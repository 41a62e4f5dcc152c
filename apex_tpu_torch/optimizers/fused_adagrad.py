"""FusedAdagrad: one multi-tensor kernel sweep (flat) or leafwise PyTorch
(tree).

Port of ``apex_tpu/optimizers/fused_adagrad.py`` (``apex.optimizers.
FusedAdagrad`` over ``multi_tensor_adagrad``). Two layouts, the same math
(``g' = g * grad_scale + weight_decay * p``, ``h += g'^2``, ``p -= lr * g'
/ (sqrt(h) + eps)``):

- ``layout="flat"``: params and fp32 grads are packed into per-dtype flat
  buffers each step and one :func:`~apex_tpu_torch.kernels.adagrad_flat`
  launch per group updates params and the sum of squares in place. The
  sum of squares lives as flat fp32 buffers at the JAX layout's offsets;
- ``layout="tree"``: the sum of squares mirrors the param tree and the
  update is leafwise PyTorch, as the JAX package leaves it to XLA.

The port adds ``skip`` to ``step`` (apex's ``noop_flag``; the JAX
function has none): on a skipped step params, the sum of squares and
the count stay bit for bit as they were.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.kernels.flat_ops import adagrad_flat
from apex_tpu_torch.optimizers._base import (
    FusedOptimizer,
    Schedule,
    finish_tree_optimizer,
    next_count,
    pack_pair,
    param_device,
    resolve_grad_scale,
    resolve_lr,
    tree_sweep,
    zeros_like_group_f32,
    zeros_like_tree,
)


class FusedAdagradState(NamedTuple):
    count: torch.Tensor                  # int32 0-d
    sum_sq: Tuple[torch.Tensor, ...]     # flat fp32, one per dtype group


class TreeAdagradState(NamedTuple):
    count: torch.Tensor
    sum_sq: Any  # mirrors the param tree, fp32


def fused_adagrad(learning_rate: Schedule = 1e-2, eps: float = 1e-10,
                  weight_decay: float = 0.0, layout: str = "flat"
                  ) -> FusedOptimizer:
    """A FusedAdagrad transform. ``layout``: "flat" (the kernel) or
    "tree" (leafwise); the same math either way."""
    if layout not in ("flat", "tree"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "tree":
        return _tree_adagrad(learning_rate, eps, weight_decay)

    def init(params) -> FusedAdagradState:
        dev = param_device(params)
        return FusedAdagradState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            sum_sq=zeros_like_group_f32(mt.layout_of(params), dev))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        if params is None:
            raise ValueError("fused_adagrad requires params")
        with torch.profiler.record_function("fused_adagrad.pack"):
            pbufs, gbufs, flat_layout = pack_pair(params, grads)
        count = state.count + 1
        new_p, new_h = adagrad_flat(
            pbufs, gbufs, list(state.sum_sq),
            lr=resolve_lr(learning_rate, count), eps=eps,
            weight_decay=weight_decay,
            grad_scale=1.0 if grad_scale is None else grad_scale,
            out_is_delta=out_is_delta, skip=skip)
        if out_is_delta:   # the JAX update's dtype: the params' own
            new_p = [d.to(p.dtype) for d, p in zip(new_p, pbufs)]
        new_state = FusedAdagradState(next_count(state.count, skip),
                                      tuple(new_h))
        return mt.unpack(new_p, flat_layout), new_state

    def update(grads, state, params=None, *, grad_scale=None):
        return _sweep(grads, state, params, grad_scale, True, None)

    def step(grads, state, params, *, grad_scale=None, skip=None):
        return _sweep(grads, state, params, grad_scale, False, skip)

    return FusedOptimizer(init=init, update=update, step=step)


def _tree_adagrad(learning_rate, eps, weight_decay):
    """Leafwise Adagrad: the flat sweep's math, no packing copies."""

    def init(params) -> TreeAdagradState:
        return TreeAdagradState(
            count=torch.zeros((), dtype=torch.int32,
                              device=param_device(params)),
            sum_sq=zeros_like_tree(params))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        count = state.count + 1
        lr = resolve_lr(learning_rate, count)
        gs = resolve_grad_scale(grad_scale, count.device)

        def leaf(p, g, h):
            p32 = p.float()
            g32 = g.float() * gs + weight_decay * p32
            h_new = h + g32 * g32
            upd = lr * g32 / (torch.sqrt(h_new) + eps)
            out = (-upd if out_is_delta else p32 - upd).to(p.dtype)
            if skip is not None:
                return torch.where(skip, p, out), torch.where(skip, h, h_new)
            return out, h_new

        out_t, h_t = tree_sweep(leaf, params, grads, state.sum_sq)
        return out_t, TreeAdagradState(next_count(state.count, skip), h_t)

    return finish_tree_optimizer(init, _sweep)
