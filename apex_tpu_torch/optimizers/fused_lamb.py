"""FusedLAMB: two-phase NVLAMB over the multi-tensor kernels (flat) or
leafwise PyTorch (tree).

Port of ``apex_tpu/optimizers/fused_lamb.py`` (``apex.optimizers.
FusedLAMB`` over ``multi_tensor_lamb``). The flat layout's step:

- the optional global gradient clip: :func:`~apex_tpu_torch.kernels.
  l2norm_flat` over the packed fp32 grads, folded into the sweep's
  ``grad_scale``;
- phase 1: one :func:`~apex_tpu_torch.kernels.adam_flat` launch per
  group with ``lr=1`` in delta mode: it writes ``-u`` (the Adam-style
  update with decoupled weight decay) to a new fp32 buffer, updates m and
  v in place, and leaves the params as they are;
- the trust ratios ``||p|| / ||u||`` per leaf (a stacked ``[L, ...]``
  leaf is one tensor, as in JAX), broadcast over the flat buffers;
- phase 2: ``p - lr * ratio * u``, elementwise PyTorch over the flat
  buffers, as the JAX package leaves it to XLA.

The tree layout runs the same math leaf by leaf. Both honour the step's
``skip`` flag (apex's ``noop_flag``): on an overflow step params, m, v
and the count stay bit for bit as they were.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.kernels.flat_ops import adam_flat, l2norm_flat
from apex_tpu_torch.optimizers._base import (
    FusedOptimizer,
    Schedule,
    bias_corrections,
    broadcast_per_leaf,
    finish_tree_optimizer,
    next_count,
    pack_pair,
    param_device,
    per_leaf_norms,
    resolve_grad_scale,
    resolve_lr,
    tree_sweep,
    zeros_like_group_f32,
    zeros_like_tree,
)


class FusedLAMBState(NamedTuple):
    count: torch.Tensor              # int32 0-d
    m: Tuple[torch.Tensor, ...]      # flat fp32, one per dtype group
    v: Tuple[torch.Tensor, ...]


class TreeLAMBState(NamedTuple):
    count: torch.Tensor
    m: Any  # mirrors the param tree, fp32
    v: Any


def _trust_ratio(p_norm, u_norm):
    """``||p|| / ||u||``, or 1 where either norm is zero."""
    ok = (p_norm > 0.0) & (u_norm > 0.0)
    return torch.where(ok, p_norm / torch.where(u_norm > 0.0, u_norm,
                                                torch.ones_like(u_norm)),
                       torch.ones_like(p_norm))


def _clip_scale(gnorm, max_grad_norm: float):
    return torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)


def fused_lamb(
    learning_rate: Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    bias_correction: bool = True,
    max_grad_norm: Optional[float] = 1.0,
    always_adapt: bool = False,
    grad_averaging: bool = True,
    layout: str = "flat",
) -> FusedOptimizer:
    """A FusedLAMB transform with apex's defaults (eps 1e-6, weight decay
    0.01, global clip at 1.0). ``grad_averaging=False`` accumulates the
    raw gradient into m. ``always_adapt`` is apex's ``use_nvlamb``: with
    False the trust ratio applies only when weight decay is on; a zero
    ``||p||`` or ``||u||`` gives ratio 1. ``layout``: "flat" (the
    kernels) or "tree" (leafwise); the same math either way."""
    if layout not in ("flat", "tree"):
        raise ValueError(f"unknown layout {layout!r}")
    adapt = always_adapt or weight_decay != 0.0
    if layout == "tree":
        return _tree_lamb(learning_rate, b1, b2, eps, weight_decay,
                          bias_correction, max_grad_norm, adapt,
                          grad_averaging)

    def init(params) -> FusedLAMBState:
        dev = param_device(params)
        return FusedLAMBState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros_like_group_f32(mt.layout_of(params), dev),
            v=zeros_like_group_f32(mt.layout_of(params), dev))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        if params is None:
            raise ValueError("fused_lamb requires params")
        with torch.profiler.record_function("fused_lamb.pack"):
            pbufs, gbufs, flat_layout = pack_pair(params, grads)
        count = state.count + 1
        gscale = resolve_grad_scale(grad_scale, count.device)
        if max_grad_norm is not None:
            gnorm = l2norm_flat(gbufs) * gscale
            gscale = gscale * _clip_scale(gnorm, max_grad_norm)
        bc1, bc2 = bias_corrections(count, b1, b2, bias_correction)
        # phase 1 (stage 1): delta = -u, u = mhat / (sqrt(vhat) + eps)
        # + wd * p; the params are only read
        delta_bufs, new_m, new_v = adam_flat(
            pbufs, gbufs, list(state.m), list(state.v), lr=1.0, b1=b1,
            b2=b2, eps=eps, weight_decay=weight_decay, bias_correction1=bc1,
            bias_correction2=bc2, grad_scale=gscale, adam_w_mode=True,
            out_is_delta=True, grad_averaging=grad_averaging, skip=skip)
        lr = resolve_lr(learning_rate, count)
        if adapt:
            # ||u|| == ||delta||; one ratio per leaf, lr folded in
            ratios = [_trust_ratio(pn, un) for pn, un in zip(
                per_leaf_norms(params),
                per_leaf_norms(mt.unpack(delta_bufs, flat_layout)))]
            coef_bufs = broadcast_per_leaf([lr * r for r in ratios],
                                           flat_layout)
        else:       # use_nvlamb=False and wd=0: no trust adaptation
            coef_bufs = [lr] * len(pbufs)
        # phase 2 (stage 2): p - lr * ratio * u == p + coef * delta
        if out_is_delta:
            out_bufs = [(c * d).to(p.dtype)
                        for p, c, d in zip(pbufs, coef_bufs, delta_bufs)]
        else:
            out_bufs = [torch.addcmul(p.float(), c, d).to(p.dtype)
                        for p, c, d in zip(pbufs, coef_bufs, delta_bufs)]
            if skip is not None:
                out_bufs = [torch.where(skip, p, o)
                            for p, o in zip(pbufs, out_bufs)]
        new_state = FusedLAMBState(next_count(state.count, skip),
                                   tuple(new_m), tuple(new_v))
        return mt.unpack(out_bufs, flat_layout), new_state

    def update(grads, state, params=None, *, grad_scale=None):
        return _sweep(grads, state, params, grad_scale, True, None)

    def step(grads, state, params, *, grad_scale=None, skip=None):
        return _sweep(grads, state, params, grad_scale, False, skip)

    return FusedOptimizer(init=init, update=update, step=step)


def _tree_lamb(learning_rate, b1, b2, eps, weight_decay, bias_correction,
               max_grad_norm, adapt, grad_averaging):
    """Leafwise NVLAMB: the flat layout's math, per-leaf trust ratios, no
    packing copies."""

    def init(params) -> TreeLAMBState:
        return TreeLAMBState(
            count=torch.zeros((), dtype=torch.int32,
                              device=param_device(params)),
            m=zeros_like_tree(params), v=zeros_like_tree(params))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        count = state.count + 1
        gscale = resolve_grad_scale(grad_scale, count.device)
        if max_grad_norm is not None:
            gn2 = None
            for g in _tree.leaves(grads):
                s = torch.sum(torch.square(g.float()))
                gn2 = s if gn2 is None else gn2 + s
            gnorm = torch.sqrt(gn2) * gscale
            gscale = gscale * _clip_scale(gnorm, max_grad_norm)
        bc1, bc2 = bias_corrections(count, b1, b2, bias_correction)
        lr = resolve_lr(learning_rate, count)

        def leaf(p, g, m, v):
            g32 = g.float() * gscale
            p32 = p.float()
            m_new = b1 * m + ((1.0 - b1) if grad_averaging else 1.0) * g32
            v_new = b2 * v + (1.0 - b2) * g32 * g32
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p32
            ratio = (_trust_ratio(torch.linalg.vector_norm(p32.reshape(-1)),
                                  torch.linalg.vector_norm(u.reshape(-1)))
                     if adapt else 1.0)
            delta = -lr * ratio * u
            out = (delta if out_is_delta else p32 + delta).to(p.dtype)
            if skip is not None:
                return (torch.where(skip, p, out), torch.where(skip, m, m_new),
                        torch.where(skip, v, v_new))
            return out, m_new, v_new

        out_t, m_t, v_t = tree_sweep(leaf, params, grads, state.m, state.v)
        return out_t, TreeLAMBState(next_count(state.count, skip), m_t, v_t)

    return finish_tree_optimizer(init, _sweep, per_leaf_norms=True)
