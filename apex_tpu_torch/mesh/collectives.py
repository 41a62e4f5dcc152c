"""Named-axis collectives over a :class:`~apex_tpu_torch.mesh.Mesh`.

Port of ``apex_tpu/mesh/collectives.py``: ``psum``, ``pmean``,
``all_gather`` (tiled or stacked), ``psum_scatter`` / ``reduce_scatter``,
``ppermute``, ``ppermute_shift``, ``all_to_all``, ``pbroadcast_from``,
``axis_index`` and ``axis_size``, with JAX's shapes and argument names,
plus ``pmax`` and ``pmin`` (``lax.pmax`` / ``lax.pmin``, which the
vocab-parallel cross entropy and the train step's overflow vote use).

Each runs one ``torch.distributed`` call over the group of ``axis``, on
the caller's tensor and device, and returns a new tensor (the input is
never written). The mesh is the ``mesh=`` argument, else the innermost
``with mesh:`` of this thread. A set of axes that spans one rank needs
no traffic: its result is computed in place of the call (except at world
1, where the group is the default one and the call runs). These are not
differentiable: the autograd mappings of
:mod:`apex_tpu_torch.transformer.tensor_parallel.mappings` are built on
them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.mesh.topology import AxisName, Mesh, resolve_mesh

# torch 2.13 renamed the tensor forms of all-gather and reduce-scatter;
# the older names stay for the torch builds that have only those
_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def _ordered(mesh: Mesh, axis: AxisName):
    """The group of ``axis`` for a collective whose result depends on
    rank order: the axes must be listed in mesh order, the order of the
    group's members."""
    if not mesh.in_mesh_order(axis):
        raise ValueError(
            f"axes {axis} must be listed in mesh order {mesh.axis_names} "
            "for an order-dependent collective")
    return mesh.group(axis)


def axis_index(axis: AxisName, mesh: Optional[Mesh] = None) -> int:
    """Rank within ``axis`` — apex's ``get_*_parallel_rank()``."""
    return resolve_mesh(mesh).index(axis)


def axis_size(axis: AxisName, mesh: Optional[Mesh] = None) -> int:
    """World size of ``axis`` — apex's ``get_*_parallel_world_size()``."""
    return resolve_mesh(mesh).size(axis)


def _reduce(x: torch.Tensor, axis, op, mesh) -> torch.Tensor:
    mesh = resolve_mesh(mesh)
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.all_reduce(out, op=op, group=g)
    return out


def psum(x: torch.Tensor, axis: AxisName, mesh: Optional[Mesh] = None
         ) -> torch.Tensor:
    """All-reduce (sum) over ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axis: AxisName, mesh: Optional[Mesh] = None
         ) -> torch.Tensor:
    """All-reduce (max) over ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MAX, mesh)


def pmin(x: torch.Tensor, axis: AxisName, mesh: Optional[Mesh] = None
         ) -> torch.Tensor:
    """All-reduce (min) over ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MIN, mesh)


def pmean(x: torch.Tensor, axis: AxisName, mesh: Optional[Mesh] = None
          ) -> torch.Tensor:
    """All-reduce (mean): the sum divided by the axis size, as
    ``lax.pmean`` — apex DDP's ``gradient_average=True``."""
    mesh = resolve_mesh(mesh)
    return psum(x, axis, mesh) / mesh.size(axis)


def _gather_parts(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` in group order."""
    g = _ordered(mesh, axis)
    if g is None:
        return x.unsqueeze(0).clone()
    src = x.contiguous().unsqueeze(0)
    out = torch.empty((mesh.size(axis),) + tuple(x.shape),
                      dtype=src.dtype, device=src.device)
    _all_gather_tensor(out, src, group=g)   # the inputs end to end
    return out


def all_gather(x: torch.Tensor, axis: AxisName, *, gather_axis: int = 0,
               tiled: bool = True, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """All-gather shards along dimension ``gather_axis``: ``tiled=True``
    concatenates (NCCL's ``all_gather_base``), ``tiled=False`` stacks
    them on a new dimension there."""
    mesh = resolve_mesh(mesh)
    parts = _gather_parts(x, axis, mesh)
    if not tiled:
        return parts.movedim(0, gather_axis % (x.dim() + 1)).contiguous()
    return torch.cat(parts.unbind(0), dim=gather_axis % x.dim())


def psum_scatter(x: torch.Tensor, axis: AxisName, *, scatter_axis: int = 0,
                 tiled: bool = True, mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """Reduce-scatter: the sum over ``axis``, of which this rank keeps
    its block of dimension ``scatter_axis`` (``tiled=False``: that
    dimension has the axis size and is dropped)."""
    mesh = resolve_mesh(mesh)
    n = mesh.size(axis)
    d = scatter_axis % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"dim {d} of shape {tuple(x.shape)} not divisible "
                         f"by axis {axis!r} size {n}")
    if not tiled and x.shape[d] != n:
        raise ValueError(f"untiled psum_scatter needs dim {d} of size {n}, "
                         f"got {x.shape[d]}")
    g = _ordered(mesh, axis)
    src = x.movedim(d, 0).contiguous()
    if g is None:
        out = src.clone()
    else:
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _reduce_scatter_tensor(out, src, group=g)
    if not tiled:
        return out[0]
    return out.movedim(0, d).contiguous()


#: NCCL nomenclature alias, as in the JAX package
reduce_scatter = psum_scatter


def ppermute(x: torch.Tensor, axis: AxisName,
             perm: Sequence[Tuple[int, int]], mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """Point-to-point permutation: for each ``(src, dst)`` pair of axis
    indices, rank ``src``'s ``x`` arrives at rank ``dst``; a rank that no
    pair sends to receives zeros (``lax.ppermute``)."""
    mesh = resolve_mesh(mesh)
    perm = [(int(s), int(d)) for s, d in perm]
    n = mesh.size(axis)
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"pair {(s, d)} outside axis size {n}")
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError(f"perm {perm} is not a permutation")
    g = _ordered(mesh, axis)
    me = mesh.index(axis)
    src = x.contiguous()
    out = torch.zeros_like(src)
    to = [d for s, d in perm if s == me]
    frm = [s for s, d in perm if d == me]
    if g is None:
        if to:
            out.copy_(src)
        return out
    # one all-to-all whose only non-empty blocks are this rank's send and
    # receive (gloo moves no point-to-point message of CUDA memory)
    k = src.numel()
    send = src.reshape(-1) if to else src.new_empty(0)
    recv = out.view(-1) if frm else out.new_empty(0)
    dist.all_to_all_single(
        recv, send, output_split_sizes=[k if i in frm else 0
                                        for i in range(n)],
        input_split_sizes=[k if i in to else 0 for i in range(n)], group=g)
    return out


def ppermute_shift(x: torch.Tensor, axis: AxisName, shift: int = 1, *,
                   wrap: bool = True, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """Rank i's value arrives at rank i + shift: a ring rotation with
    ``wrap=True``; with ``wrap=False`` the first ranks receive zeros (the
    pipeline edge)."""
    n = axis_size(axis, mesh)
    if wrap:
        perm = [(i, (i + shift) % n) for i in range(n)]
    else:
        perm = [(i, i + shift) for i in range(n) if 0 <= i + shift < n]
    return ppermute(x, axis, perm, mesh)


def all_to_all(x: torch.Tensor, axis: AxisName, *, split_axis: int,
               concat_axis: int, tiled: bool = True,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """All-to-all: ``x`` split in axis-size blocks along ``split_axis``,
    block i sent to rank i, the received blocks joined along
    ``concat_axis`` in source order (``tiled=False``: the split dimension
    has the axis size and is dropped, and the blocks are stacked on a new
    ``concat_axis``) — the sequence ↔ head reshard."""
    mesh = resolve_mesh(mesh)
    n = mesh.size(axis)
    sd = split_axis % x.dim()
    if x.shape[sd] % n:
        raise ValueError(f"dim {sd} of shape {tuple(x.shape)} not divisible "
                         f"by axis {axis!r} size {n}")
    if not tiled and x.shape[sd] != n:
        raise ValueError(f"untiled all_to_all needs dim {sd} of size {n}")
    g = _ordered(mesh, axis)
    blocks = torch.stack(x.chunk(n, dim=sd), 0).contiguous()
    if g is None:
        recv = blocks.clone()
    else:
        recv = torch.empty_like(blocks)
        dist.all_to_all_single(recv, blocks, group=g)
    parts = recv.unbind(0)
    if tiled:
        return torch.cat(parts, dim=concat_axis % x.dim())
    parts = [p.squeeze(sd) for p in parts]
    return torch.stack(parts, dim=concat_axis % x.dim())


def pbroadcast_from(x: torch.Tensor, axis: AxisName, src_index: int = 0,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Rank ``src_index``'s value on every rank of ``axis`` (apex's
    ``broadcast_data`` root broadcast)."""
    mesh = resolve_mesh(mesh)
    out = x.clone()
    g = _ordered(mesh, axis)
    if g is not None:
        dist.broadcast(out, mesh.ranks(axis)[src_index], group=g)
    return out
