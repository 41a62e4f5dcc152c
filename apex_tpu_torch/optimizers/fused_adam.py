"""FusedAdam: one multi-tensor kernel sweep (flat) or leafwise PyTorch (tree).

Port of ``apex_tpu/optimizers/fused_adam.py`` (``apex.optimizers.
FusedAdam`` over ``multi_tensor_adam``). Two layouts, the same math:

- ``layout="flat"``: params and fp32 grads are packed into per-dtype flat
  buffers each step and one :func:`~apex_tpu_torch.kernels.adam_flat`
  launch per group updates params, m and v. The moments live as flat
  fp32 buffers at the JAX layout's offsets. The new params are views
  into the freshly packed buffer, so unpacking copies nothing.
- ``layout="tree"``: the moments mirror the param tree and the update is
  leafwise PyTorch, as the JAX package leaves it to XLA.

Hyperparameters and the step count live on the device, so a schedule or
bias correction never syncs with the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.kernels.flat_ops import adam_flat
from apex_tpu_torch.optimizers._base import (
    FusedOptimizer,
    Schedule,
    bias_corrections,
    finish_tree_optimizer,
    pack_pair,
    param_device,
    resolve_grad_scale,
    resolve_lr,
    tree_sweep,
    zeros_like_group_f32,
    zeros_like_tree,
)


class FusedAdamState(NamedTuple):
    count: torch.Tensor              # int32 0-d
    m: Tuple[torch.Tensor, ...]      # flat fp32, one per dtype group
    v: Tuple[torch.Tensor, ...]


class TreeAdamState(NamedTuple):
    count: torch.Tensor
    m: Any  # mirrors the param tree, fp32
    v: Any


def _next_count(count, skip):
    new = count + 1
    return new if skip is None else torch.where(skip, count, new)


def fused_adam(
    learning_rate: Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    adam_w_mode: bool = True,
    bias_correction: bool = True,
    layout: str = "flat",
) -> FusedOptimizer:
    """A FusedAdam transform (AdamW by default, like apex).
    ``adam_w_mode=False`` is classic Adam with L2 decay folded into the
    gradient. ``layout``: "flat" (the kernel) or "tree" (leafwise)."""
    if layout not in ("flat", "tree"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "tree":
        return _tree_adam(learning_rate, b1, b2, eps, weight_decay,
                          adam_w_mode, bias_correction)

    def init(params) -> FusedAdamState:
        dev = param_device(params)
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros_like_group_f32(mt.layout_of(params), dev),
            v=zeros_like_group_f32(mt.layout_of(params), dev))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        if params is None:
            raise ValueError("fused_adam requires params")
        # a profiler range, so a trace shows what packing costs a step
        with torch.profiler.record_function("fused_adam.pack"):
            pbufs, gbufs, flat_layout = pack_pair(params, grads)
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2, bias_correction)
        new_p, new_m, new_v = adam_flat(
            pbufs, gbufs, list(state.m), list(state.v),
            lr=resolve_lr(learning_rate, count), b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, bias_correction1=bc1,
            bias_correction2=bc2,
            grad_scale=1.0 if grad_scale is None else grad_scale,
            adam_w_mode=adam_w_mode, out_is_delta=out_is_delta, skip=skip)
        if out_is_delta:   # the JAX update's dtype: the params' own
            new_p = [d.to(p.dtype) for d, p in zip(new_p, pbufs)]
        new_state = FusedAdamState(_next_count(state.count, skip),
                                   tuple(new_m), tuple(new_v))
        return mt.unpack(new_p, flat_layout), new_state

    def update(grads, state, params=None, *, grad_scale=None):
        return _sweep(grads, state, params, grad_scale, True, None)

    def step(grads, state, params, *, grad_scale=None, skip=None):
        return _sweep(grads, state, params, grad_scale, False, skip)

    return FusedOptimizer(init=init, update=update, step=step)


def _tree_adam(learning_rate, b1, b2, eps, weight_decay, adam_w_mode,
               bias_correction):
    """Leafwise Adam: the flat sweep's math, no packing copies."""

    def init(params) -> TreeAdamState:
        return TreeAdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=param_device(params)),
            m=zeros_like_tree(params), v=zeros_like_tree(params))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2, bias_correction)
        lr = resolve_lr(learning_rate, count)
        gs = resolve_grad_scale(grad_scale, count.device)

        def leaf(p, g, m, v):
            g32 = g.float() * gs
            p32 = p.float()
            if weight_decay and not adam_w_mode:
                g32 = g32 + weight_decay * p32
            m_new = b1 * m + (1.0 - b1) * g32
            v_new = b2 * v + (1.0 - b2) * g32 * g32
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if weight_decay and adam_w_mode:
                upd = upd + weight_decay * p32
            delta = -lr * upd
            out = (delta if out_is_delta else p32 + delta).to(p.dtype)
            if skip is not None:
                return (torch.where(skip, p, out), torch.where(skip, m, m_new),
                        torch.where(skip, v, v_new))
            return out, m_new, v_new

        out_t, m_t, v_t = tree_sweep(leaf, params, grads, state.m, state.v)
        return out_t, TreeAdamState(_next_count(state.count, skip), m_t, v_t)

    return finish_tree_optimizer(init, _sweep)
