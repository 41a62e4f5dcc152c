"""The mesh of processes: {pp, dp, ep, cp, tp} axes over ``torch.distributed``.

Port of ``apex_tpu/mesh/topology.py`` (the axis names, ``MeshConfig``,
``build_mesh``, ``mesh_shape_of``). The JAX package's mesh is one array
of devices with named axes that a single program runs over; here each
process is one rank of ``torch.distributed``'s default group and a
:class:`Mesh` is that rank's view of the same layout: the axis sizes,
its own coordinates, and one process group for every set of axes a
collective can span.

Rank ``r`` sits where JAX's mesh puts device ``r``: its coordinates are
the row-major unravel of ``r`` over the axis order, outermost first
(:data:`DEFAULT_AXIS_ORDER`, so tp varies fastest and tensor-parallel
peers are neighbouring ranks).

Every process of the world builds the mesh, in the same order as every
other one: group creation is itself a collective call.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_TP = "tp"
AXIS_CP = "cp"
AXIS_EP = "ep"

#: outermost → innermost, as in the JAX package
DEFAULT_AXIS_ORDER = (AXIS_PP, AXIS_DP, AXIS_EP, AXIS_CP, AXIS_TP)

AxisName = Union[str, Sequence[str]]


class PartitionSpec(tuple):
    """Per dimension of an array, the mesh axis (or tuple of axes) it is
    sharded over, or None: ``jax.sharding.PartitionSpec``'s contract as a
    plain tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape; ``dp=None`` takes what is left of the
    world after ``tp * pp * cp * ep`` (the JAX class, the same
    errors)."""

    tp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    dp: Optional[int] = None
    axis_order: Sequence[str] = DEFAULT_AXIS_ORDER

    def resolve_dp(self, n_devices: int) -> int:
        if self.tp < 1 or self.pp < 1 or self.cp < 1 or self.ep < 1:
            raise ValueError(
                f"tp, pp, cp, ep must be >= 1, got tp={self.tp} "
                f"pp={self.pp} cp={self.cp} ep={self.ep}")
        model_parallel = self.tp * self.pp * self.cp * self.ep
        if self.dp is not None:
            total = model_parallel * self.dp
            if total != n_devices:
                raise ValueError(
                    f"tp*pp*cp*ep*dp = {total} != device count {n_devices}")
            return self.dp
        if n_devices % model_parallel != 0:
            raise ValueError(
                f"device count {n_devices} not divisible by "
                f"tp*pp*cp*ep={model_parallel}")
        return n_devices // model_parallel


def _axes(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


_CURRENT = threading.local()


class Mesh:
    """This rank's place in the mesh: ``shape`` (axis → size, outermost
    first), ``coords`` (axis → this rank's index), the world ``rank``,
    the ``device`` its tensors live on and the ``backend``.

    :meth:`group` gives the process group spanning a set of axes (the
    ranks that share every other coordinate). A set of axes that spans
    one rank has no group (its collectives need no traffic), except when
    it is the whole world, whose group is the default one.

    ``with mesh:`` makes it the mesh that the collectives of
    :mod:`apex_tpu_torch.mesh.collectives` use when they are not given
    one, in this thread (the port's counterpart of running inside
    ``shard_map``)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Dict[Tuple[str, ...], object],
                 device: torch.device, backend: str):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.world_size = math.prod(shape.values())
        idx = _unravel(rank, tuple(shape.values()))
        self.coords = dict(zip(self.axis_names, idx))
        self._groups = groups
        self.device = device
        self.backend = backend

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")

    def _key(self, axis: AxisName) -> Tuple[str, ...]:
        axes = _axes(axis)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown} (mesh has "
                             f"{self.axis_names})")
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axis in {axes}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def in_mesh_order(self, axis: AxisName) -> bool:
        """True when the axes are listed outermost first, the order the
        ranks of their group take (torch numbers a group's members by
        their world ranks)."""
        axes = _axes(axis)
        pos = [self.axis_names.index(a) for a in axes]
        return pos == sorted(pos)

    def size(self, axis: AxisName) -> int:
        """Ranks along ``axis`` (the product over a tuple of axes)."""
        self._key(axis)
        return math.prod(self.shape[a] for a in _axes(axis))

    def index(self, axis: AxisName) -> int:
        """This rank's index along ``axis``; over a tuple of axes the
        row-major index in the order given (JAX's ``axis_index``)."""
        self._key(axis)
        i = 0
        for a in _axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def ranks(self, axis: AxisName) -> Tuple[int, ...]:
        """The world ranks of this rank's group along ``axis``, by index
        along the axes in mesh order."""
        key = self._key(axis)
        return _line_ranks(self.shape, self.coords, key)

    def group(self, axis: AxisName):
        """The process group spanning ``axis``, or None when it holds
        this rank alone and is not the world."""
        return self._groups.get(self._key(axis))

    def __enter__(self):
        stack = getattr(_CURRENT, "stack", None)
        if stack is None:
            stack = _CURRENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.stack.pop()
        return False


def current_mesh() -> Optional[Mesh]:
    """The innermost ``with mesh:`` of this thread, or None."""
    stack = getattr(_CURRENT, "stack", None)
    return stack[-1] if stack else None


def resolve_mesh(mesh: Optional[Mesh]) -> Mesh:
    """``mesh``, else the current ``with mesh:``, else the mesh of the
    installed :mod:`~apex_tpu_torch.transformer.parallel_state`; raises
    when there is none (where JAX's collectives would find no axis
    outside ``shard_map``)."""
    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        from apex_tpu_torch.transformer import parallel_state as ps

        if ps.model_parallel_is_initialized():
            mesh = ps.get_mesh()
    if mesh is None:
        raise RuntimeError(
            "no mesh: pass mesh=, call inside `with mesh:`, or "
            "initialize_model_parallel() first")
    return mesh


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def _line_ranks(shape: Dict[str, int], coords: Dict[str, int],
                key: Tuple[str, ...]) -> Tuple[int, ...]:
    names = tuple(shape)
    sizes = tuple(shape.values())
    out = []
    for sub in itertools.product(*(range(shape[a]) for a in key)):
        c = dict(coords)
        c.update(zip(key, sub))
        out.append(_ravel([c[a] for a in names], sizes))
    return tuple(out)


def build_mesh(tp: int = 1, pp: int = 1, dp: Optional[int] = None, *,
               axis_order: Sequence[str] = DEFAULT_AXIS_ORDER,
               cp: int = 1, ep: int = 1,
               device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default process
    group (:func:`apex_tpu_torch.parallel.initialize_distributed`);
    every rank calls it with the same arguments. ``dp=None`` infers data
    parallelism as in JAX, with the same factorisation errors.
    ``device`` is where this rank's tensors live: None takes the current
    CUDA device under NCCL; under gloo it must be named (``"cpu"``, or a
    CUDA device that ranks may share)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised torch.distributed default "
            "group: call apex_tpu_torch.parallel.initialize_distributed "
            "first")
    n = dist.get_world_size()
    cfg = MeshConfig(tp=tp, pp=pp, cp=cp, ep=ep, dp=dp,
                     axis_order=tuple(axis_order))
    dp_size = cfg.resolve_dp(n)
    sizes = {AXIS_DP: dp_size, AXIS_PP: pp, AXIS_TP: tp, AXIS_CP: cp,
             AXIS_EP: ep}
    unknown = set(cfg.axis_order) - set(sizes)
    if unknown:
        raise ValueError(
            f"unknown axis names in axis_order: {sorted(unknown)}")
    shape = {a: sizes[a] for a in cfg.axis_order}
    if math.prod(shape.values()) != n:
        raise ValueError(
            f"mesh shape {tuple(shape.values())} does not cover {n} devices")
    backend = dist.get_backend()
    if device is None:
        if backend != "nccl":
            raise ValueError(f"name the device of a {backend} mesh "
                             "(device='cpu' or 'cuda:<i>')")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    rank = dist.get_rank()
    groups = _make_groups(shape, rank, n)
    return Mesh(shape, rank, groups, device, backend)


def _make_groups(shape: Dict[str, int], rank: int, world: int):
    """One group per set of the mesh's non-trivial axes and per line of
    ranks, created in the same order on every rank; this rank keeps the
    ones it belongs to. The set of all non-trivial axes is the world
    (the default group); at world 1 the empty set is too."""
    nontrivial = tuple(a for a, s in shape.items() if s > 1)
    coords = dict(zip(shape, _unravel(rank, tuple(shape.values()))))
    groups = {}
    if world == 1:
        groups[()] = dist.group.WORLD
    for k in range(1, len(nontrivial) + 1):
        for key in itertools.combinations(nontrivial, k):
            if len(key) == len(nontrivial):
                groups[key] = dist.group.WORLD
                continue
            others = [a for a in nontrivial if a not in key]
            for sub in itertools.product(*(range(shape[a]) for a in others)):
                c = {a: 0 for a in shape}
                c.update(zip(others, sub))
                members = _line_ranks(shape, c, key)
                g = dist.new_group(list(members))
                if rank in members:
                    groups[key] = g
    return groups


def mesh_shape_of(mesh: Mesh) -> dict:
    """Axis-name → size mapping of a mesh."""
    return dict(mesh.shape)


def build_hybrid_mesh(*args, **kwargs):
    """The multi-slice placement of the JAX package has no counterpart
    yet: it waits for a later slice of the port (ROADMAP queue 1, the
    distributed slices after this one)."""
    raise NotImplementedError(
        "build_hybrid_mesh is not supported by apex_tpu_torch yet (a "
        "later distributed slice, ROADMAP queue 1 item 4)")
