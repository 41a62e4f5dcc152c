"""Shared plumbing of the fused optimizers.

Port of ``apex_tpu/optimizers/_base.py``. An optimizer is a
:class:`FusedOptimizer` of functions over trees of tensors, as in the JAX
package. The port's one addition is ``skip`` on ``step``: a bool 0-d
tensor on the device where True means "leave params and state as they
were" — apex's ``noop_flag``, which takes the place of the JAX train
step's ``apply_if_finite`` select after an in-place update.

The state passed to ``step`` is consumed, as the JAX train step donates
it: a flat-layout step updates its moment buffers in place.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.kernels.flat_ops import device_scalar

Schedule = Union[float, Callable[[torch.Tensor], Any]]


class FusedOptimizer(NamedTuple):
    """- ``init(params) -> state``;
    - ``update(grads, state, params) -> (updates, state)`` — deltas to
      add to the params;
    - ``step(grads, state, params, *, grad_scale=None, skip=None) ->
      (new_params, state)`` — the apex call shape
      (``FusedAdam.step()``): the sweep writes the new params directly;
    - ``per_leaf_norms`` — True for optimizers whose update depends on
      whole-leaf norms (LAMB's trust ratios): such an update is wrong on a
      shard of a leaf, which the distributed slice's FSDP will refuse.

    The JAX type's ``state_pspecs`` (mesh sharding) comes with the
    distributed slice."""

    init: Callable
    update: Callable
    step: Callable
    per_leaf_norms: bool = False


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def resolve_lr(learning_rate: Schedule, count: torch.Tensor) -> torch.Tensor:
    """The learning rate as an fp32 0-d tensor on ``count``'s device; a
    schedule is called on the (device) step count."""
    if callable(learning_rate):
        return device_scalar(learning_rate(count), count.device)
    return device_scalar(learning_rate, count.device)


def resolve_grad_scale(grad_scale, device) -> torch.Tensor:
    return device_scalar(1.0 if grad_scale is None else grad_scale, device)


def bias_corrections(count: torch.Tensor, b1, b2, enabled: bool):
    """Adam-family bias-correction pair ``(1 - b1^t, 1 - b2^t)`` in fp32
    on the count's device, or ``(1, 1)``."""
    dev = count.device
    if not enabled:
        one = device_scalar(1.0, dev)
        return one, one
    c = count.to(torch.float32)
    return (1.0 - device_scalar(b1, dev) ** c,
            1.0 - device_scalar(b2, dev) ** c)


def zeros_like_tree(params):
    """fp32 zeros mirroring the param tree (tree-layout moment init)."""
    return _tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def finish_tree_optimizer(init: Callable, sweep: Callable,
                          per_leaf_norms: bool = False) -> FusedOptimizer:
    """Wrap a tree-layout ``sweep(grads, state, params, grad_scale,
    out_is_delta, skip)`` into the update/step contract."""

    def update(grads, state, params=None, *, grad_scale=None):
        return sweep(grads, state, params, grad_scale, True, None)

    def step(grads, state, params, *, grad_scale=None, skip=None):
        return sweep(grads, state, params, grad_scale, False, skip)

    return FusedOptimizer(init=init, update=update, step=step,
                          per_leaf_norms=per_leaf_norms)


def tree_sweep(leaf: Callable, params, grads, *moment_trees):
    """Map ``leaf(p, g, *moments) -> (out, *new_moments)`` over the leaves
    and unzip → ``(out_tree, *new_moment_trees)``."""
    if params is None:
        raise ValueError("tree-layout optimizers require params")
    leaves, spec = _tree.flatten(params)
    others = [_tree.leaves(t) for t in (grads,) + moment_trees]
    outs = [leaf(*xs) for xs in zip(leaves, *others)]
    width = 1 + len(moment_trees)
    return tuple(_tree.unflatten(spec, [o[i] for o in outs])
                 for i in range(width))


def pack_pair(params, grads):
    """Params packed in their own dtypes and grads as fp32 master grads at
    the params' offsets."""
    pbufs, layout = mt.pack(params)
    gbufs = mt.pack_cast(grads, layout, torch.float32)
    return pbufs, gbufs, layout


def zeros_like_group_f32(layout: mt.FlatLayout, device):
    return tuple(torch.zeros(s, dtype=torch.float32, device=device)
                 for s in layout.group_sizes)


def per_leaf_norms(tree) -> list:
    """Per-leaf L2 norms, fp32 0-d tensors in leaf order — the per-tensor
    half of ``multi_tensor_l2norm``, for LAMB's trust ratios. A stacked
    ``[L, ...]`` leaf has one norm over all its layers, as in JAX."""
    return [torch.linalg.vector_norm(x.float().reshape(-1))
            for x in _tree.leaves(tree)]


def broadcast_per_leaf(values, layout: mt.FlatLayout):
    """One scalar per leaf (0-d tensors, leaf order) → flat fp32 buffers
    of ``layout``: each leaf's span holds its value, the padding holds 1.0
    (neutral under multiplication). One ``cat`` of expanded views per
    group, on the values' device, with no host round trip."""
    dev = values[0].device if values else torch.device("cpu")
    parts = [[] for _ in range(layout.num_groups)]
    for val, meta in zip(values, layout.leaves):
        parts[meta.group].append(val.float().reshape(1).expand(meta.size))
    bufs = []
    for g in range(layout.num_groups):
        pad = layout.group_sizes[g] - layout.group_used[g]
        parts[g].append(torch.ones(pad, dtype=torch.float32, device=dev))
        bufs.append(torch.cat(parts[g]))
    return bufs


def param_device(params) -> torch.device:
    leaves = _tree.leaves(params)
    return _device_of(leaves[0]) if leaves else torch.device("cpu")
