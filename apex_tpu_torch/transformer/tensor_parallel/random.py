"""RNG streams for tensor parallelism, and activation recompute.

Port of ``apex_tpu/transformer/tensor_parallel/random.py``. The JAX
package's keys are values that fold and split; here a key is a 63-bit
integer seed, folded and split by a fixed mix, and turned into an
explicit :class:`torch.Generator` where numbers are drawn
(:func:`key_generator`). The structure is JAX's and apex's:

- the model-parallel stream (different dropout on each tensor-parallel
  shard) is the seed folded with apex's offset 2718, then with the tp
  rank: distinct per tp rank, equal across dp ranks;
- the replicated stream is the seed unchanged;
- :class:`RNGStatesTracker` is functional: ``fork`` returns a key and a
  new tracker, and forking one tracker twice gives the same key.

The bits differ from threefry's; only the structure carries over.
:func:`checkpoint` is ``torch.utils.checkpoint`` (non-reentrant); a
``policy`` is a selective-checkpoint ``context_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from apex_tpu_torch.mesh.topology import AXIS_TP, Mesh, resolve_mesh

#: apex's model-parallel seed offset
_MODEL_PARALLEL_FOLD = 2718
_MASK = (1 << 63) - 1


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (splitmix64 of their mix)."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019)
    z &= (1 << 64) - 1
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


def split(key: int) -> Tuple[int, int]:
    """Two independent keys from one (``jax.random.split``)."""
    return fold_in(key, 0), fold_in(key, 1)


def key_generator(key: int, device: Union[str, torch.device] = "cpu"
                  ) -> torch.Generator:
    """A generator on ``device`` seeded by ``key``."""
    return torch.Generator(device=device).manual_seed(int(key))


def model_parallel_rng_key(key: int, axis: str = AXIS_TP, *,
                           mesh: Optional[Mesh] = None) -> int:
    """This tp rank's key: distinct dropout on each tensor-parallel
    shard, the same on every dp rank."""
    mesh = resolve_mesh(mesh)
    return fold_in(fold_in(key, _MODEL_PARALLEL_FOLD), mesh.index(axis))


def model_parallel_seed_keys(seed: int, axis: str = AXIS_TP, *,
                             mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """``(replicated_key, per_rank_key)`` from an int seed — apex's
    ``model_parallel_cuda_manual_seed(seed)``."""
    base = int(seed) & _MASK
    return base, model_parallel_rng_key(base, axis, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class RNGStatesTracker:
    """Named key streams; every operation returns a new tracker
    (``CudaRNGStatesTracker``'s ``add`` / ``fork`` / ``get_states`` /
    ``set_states``)."""

    states: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, name: str, seed_or_key: int) -> "RNGStatesTracker":
        if name in self.states:
            raise ValueError(f"rng stream {name!r} already exists")
        return RNGStatesTracker({**self.states,
                                 name: int(seed_or_key) & _MASK})

    def fork(self, name: str = "model-parallel-rng"
             ) -> Tuple[int, "RNGStatesTracker"]:
        if name not in self.states:
            raise ValueError(f"unknown rng stream {name!r}")
        sub, nxt = split(self.states[name])
        return sub, RNGStatesTracker({**self.states, name: nxt})

    def get_states(self) -> Dict[str, int]:
        return dict(self.states)

    def set_states(self, states: Dict[str, int]) -> "RNGStatesTracker":
        return RNGStatesTracker(dict(states))


def get_rng_tracker(seed: int = 0, axis: str = AXIS_TP, *,
                    mesh: Optional[Mesh] = None) -> RNGStatesTracker:
    """A tracker with apex's two default streams (replicated and
    model-parallel)."""
    base, per_rank = model_parallel_seed_keys(seed, axis, mesh=mesh)
    return RNGStatesTracker({"default": base, "model-parallel-rng": per_rank})


#: apex name parity — ``get_cuda_rng_tracker``
get_cuda_rng_tracker = get_rng_tracker


def checkpoint(fn: Optional[Callable] = None, *,
               policy: Optional[Callable] = None,
               preserve_rng_state: bool = True):
    """Activation recompute — ``tensor_parallel.checkpoint``: as a
    decorator, ``checkpoint(fn)`` or ``checkpoint(policy=...)(fn)``.
    ``policy`` is a selective-checkpoint ``context_fn`` (say
    :data:`save_dots`); None recomputes everything in the backward.
    Collectives inside ``fn`` replay in the backward in the forward's
    order on every rank."""
    if fn is not None and not callable(fn):
        raise TypeError("checkpoint: first argument must be callable")

    def wrap(f):
        kw = {} if policy is None else {"context_fn": policy}

        def run(*args):
            return _torch_checkpoint(f, *args, use_reentrant=False,
                                     preserve_rng_state=preserve_rng_state,
                                     **kw)
        return run

    return wrap if fn is None else wrap(fn)


def checkpoint_call(fn: Callable, *args, policy: Optional[Callable] = None):
    """apex's call shape: ``checkpoint(run_function, *args)``."""
    return checkpoint(fn, policy=policy)(*args)


def _policy(save: Callable[[object], bool]):
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    def pol(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if save(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(pol)


def _is_dot(op) -> bool:
    aten = torch.ops.aten
    return op in (aten.mm.default, aten.bmm.default, aten.addmm.default)


#: selective-recompute policies, JAX's names: save the matmul outputs,
#: nothing, or everything
save_dots = _policy(_is_dot)
save_nothing = None
save_everything = _policy(lambda op: True)
