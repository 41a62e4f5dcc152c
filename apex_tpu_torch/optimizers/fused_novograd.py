"""FusedNovoGrad: layer-wise second moments over flat buffers (flat) or
leaf by leaf (tree).

Port of ``apex_tpu/optimizers/fused_novograd.py`` (``apex.optimizers.
FusedNovoGrad`` over ``multi_tensor_novograd``). NovoGrad keeps one
second-moment scalar per tensor, so the state is the first moments and
one ``v`` per leaf. It has no kernel of its own: the normalised gradient
step is elementwise PyTorch over the flat buffers, as the JAX package
leaves it to XLA. The two layouts keep the JAX package's arithmetic,
which differs in one rounding: the flat layout squares each leaf's norm,
the tree layout sums the squares.

The port adds ``skip`` to ``step`` (apex's ``noop_flag``): on a skipped
step params, m, v and the count stay bit for bit as they were.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.optimizers._base import (
    FusedOptimizer,
    Schedule,
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


class FusedNovoGradState(NamedTuple):
    count: torch.Tensor                  # int32 0-d
    m: Tuple[torch.Tensor, ...]          # flat fp32, one per dtype group
    v: torch.Tensor                      # [n_leaves] fp32, one per tensor


class TreeNovoGradState(NamedTuple):
    count: torch.Tensor
    m: Any  # mirrors the param tree, fp32
    v: Any  # one fp32 0-d tensor per leaf


def _keep(skip, old, new):
    return new if skip is None else torch.where(skip, old, new)


def fused_novograd(learning_rate: Schedule = 1e-3, b1: float = 0.95,
                   b2: float = 0.98, eps: float = 1e-8,
                   weight_decay: float = 0.0, grad_averaging: bool = True,
                   layout: str = "flat") -> FusedOptimizer:
    """A FusedNovoGrad transform. ``layout``: "flat" (packed buffers) or
    "tree" (leafwise); per-tensor second moments in both, initialised to
    the first gradient's squared norm (apex's rule)."""
    if layout not in ("flat", "tree"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "tree":
        return _tree_novograd(learning_rate, b1, b2, eps, weight_decay,
                              grad_averaging)

    def init(params) -> FusedNovoGradState:
        dev = param_device(params)
        flat_layout = mt.layout_of(params)
        return FusedNovoGradState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros_like_group_f32(flat_layout, dev),
            v=torch.zeros(len(flat_layout.leaves), dtype=torch.float32,
                          device=dev))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        if params is None:
            raise ValueError("fused_novograd requires params")
        pbufs, gbufs, flat_layout = pack_pair(params, grads)
        count = state.count + 1
        gscale = resolve_grad_scale(grad_scale, count.device)
        gsq = (torch.stack(per_leaf_norms(grads)) * gscale) ** 2
        new_v = torch.where(state.count == 0, gsq,
                            b2 * state.v + (1.0 - b2) * gsq)
        denom_bufs = broadcast_per_leaf(
            list((torch.sqrt(new_v) + eps).unbind(0)), flat_layout)
        coeff = (1.0 - b1) if grad_averaging else 1.0
        lr = resolve_lr(learning_rate, count)
        out_bufs, new_m = [], []
        for pb, gb, mb, db in zip(pbufs, gbufs, state.m, denom_bufs):
            p32 = pb.float()
            g32 = gb.float() * gscale
            m = b1 * mb + coeff * (g32 / db + weight_decay * p32)
            out = (-lr * m) if out_is_delta else (p32 - lr * m)
            out_bufs.append(_keep(skip, pb, out.to(pb.dtype)))
            new_m.append(_keep(skip, mb, m))
        new_state = FusedNovoGradState(next_count(state.count, skip),
                                       tuple(new_m),
                                       _keep(skip, state.v, new_v))
        return mt.unpack(out_bufs, flat_layout), new_state

    def update(grads, state, params=None, *, grad_scale=None):
        return _sweep(grads, state, params, grad_scale, True, None)

    def step(grads, state, params, *, grad_scale=None, skip=None):
        return _sweep(grads, state, params, grad_scale, False, skip)

    return FusedOptimizer(init=init, update=update, step=step)


def _tree_novograd(learning_rate, b1, b2, eps, weight_decay, grad_averaging):
    """Leafwise NovoGrad: per-leaf scalar second moments, no packing."""

    def init(params) -> TreeNovoGradState:
        dev = param_device(params)
        return TreeNovoGradState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros_like_tree(params),
            v=_tree.tree_map(lambda p: torch.zeros(
                (), dtype=torch.float32, device=p.device), params))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        count = state.count + 1
        gscale = resolve_grad_scale(grad_scale, count.device)
        coeff = (1.0 - b1) if grad_averaging else 1.0
        lr = resolve_lr(learning_rate, count)
        first = state.count == 0

        def leaf(p, g, m, v):
            p32 = p.float()
            g32 = g.float() * gscale
            gsq = torch.sum(torch.square(g32))
            v_new = torch.where(first, gsq, b2 * v + (1.0 - b2) * gsq)
            denom = torch.sqrt(v_new) + eps
            m_new = b1 * m + coeff * (g32 / denom + weight_decay * p32)
            delta = -lr * m_new
            out = (delta if out_is_delta else p32 + delta).to(p.dtype)
            return (_keep(skip, p, out), _keep(skip, m, m_new),
                    _keep(skip, v, v_new))

        out_t, m_t, v_t = tree_sweep(leaf, params, grads, state.m, state.v)
        return out_t, TreeNovoGradState(next_count(state.count, skip), m_t,
                                        v_t)

    return finish_tree_optimizer(init, _sweep, per_leaf_norms=True)
