"""FusedSGD: one multi-tensor kernel sweep (flat) or leafwise PyTorch (tree).

Port of ``apex_tpu/optimizers/fused_sgd.py`` (``apex.optimizers.FusedSGD``
over ``multi_tensor_sgd``): momentum, dampening, Nesterov and weight
decay folded into the gradient. Two layouts:

- ``layout="flat"``: params and fp32 grads are packed into per-dtype flat
  buffers each step and one :func:`~apex_tpu_torch.kernels.sgd_flat`
  launch per group updates params and momentum. The momentum lives as
  flat fp32 buffers at the JAX layout's offsets;
- ``layout="tree"``: the momentum mirrors the param tree and the update
  is leafwise PyTorch, as the JAX package leaves it to XLA.

torch and apex start the momentum buffer as the raw gradient; with a zero
buffer that is a zero dampening on the first step (``damp_eff``), chosen
on the device from the step count, so no step waits on the host. The
two layouts keep the JAX package's arithmetic, which differs where
``momentum == 0``: the flat sweep still applies ``(1 - dampening)``, the
tree update takes the gradient as it is.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.kernels.flat_ops import device_scalar, sgd_flat
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


class FusedSGDState(NamedTuple):
    count: torch.Tensor                  # int32 0-d
    momentum: Tuple[torch.Tensor, ...]   # flat fp32, one per dtype group


class TreeSGDState(NamedTuple):
    count: torch.Tensor
    momentum: Any  # mirrors the param tree, fp32


def _damp_eff(count: torch.Tensor, dampening: float) -> torch.Tensor:
    """Zero on the first step, ``dampening`` after (a device select)."""
    return torch.where(count == 0, device_scalar(0.0, count.device),
                       device_scalar(dampening, count.device))


def fused_sgd(learning_rate: Schedule = 1e-3, momentum: float = 0.0,
              dampening: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False, layout: str = "flat"
              ) -> FusedOptimizer:
    """A FusedSGD transform. ``layout``: "flat" (the kernel) or "tree"
    (leafwise). Nesterov needs ``momentum > 0`` and ``dampening == 0``,
    as in torch."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("nesterov requires momentum > 0 and dampening = 0")
    if layout not in ("flat", "tree"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "tree":
        return _tree_sgd(learning_rate, momentum, dampening, weight_decay,
                         nesterov)

    def init(params) -> FusedSGDState:
        dev = param_device(params)
        return FusedSGDState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            momentum=zeros_like_group_f32(mt.layout_of(params), dev))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        if params is None:
            raise ValueError("fused_sgd requires params")
        with torch.profiler.record_function("fused_sgd.pack"):
            pbufs, gbufs, flat_layout = pack_pair(params, grads)
        count = state.count + 1
        new_p, new_m = sgd_flat(
            pbufs, gbufs, list(state.momentum),
            lr=resolve_lr(learning_rate, count), momentum=momentum,
            dampening=_damp_eff(state.count, dampening),
            weight_decay=weight_decay,
            grad_scale=1.0 if grad_scale is None else grad_scale,
            nesterov=nesterov, out_is_delta=out_is_delta, skip=skip)
        if out_is_delta:   # the JAX update's dtype: the params' own
            new_p = [d.to(p.dtype) for d, p in zip(new_p, pbufs)]
        new_state = FusedSGDState(next_count(state.count, skip),
                                  tuple(new_m))
        return mt.unpack(new_p, flat_layout), new_state

    def update(grads, state, params=None, *, grad_scale=None):
        return _sweep(grads, state, params, grad_scale, True, None)

    def step(grads, state, params, *, grad_scale=None, skip=None):
        return _sweep(grads, state, params, grad_scale, False, skip)

    return FusedOptimizer(init=init, update=update, step=step)


def _tree_sgd(learning_rate, momentum, dampening, weight_decay, nesterov):
    """Leafwise SGD: the JAX tree update, no packing copies."""

    def init(params) -> TreeSGDState:
        return TreeSGDState(
            count=torch.zeros((), dtype=torch.int32,
                              device=param_device(params)),
            momentum=zeros_like_tree(params))

    def _sweep(grads, state, params, grad_scale, out_is_delta, skip):
        count = state.count + 1
        lr = resolve_lr(learning_rate, count)
        gs = resolve_grad_scale(grad_scale, count.device)
        damp = _damp_eff(state.count, dampening)

        def leaf(p, g, m):
            g32 = g.float() * gs
            p32 = p.float()
            if weight_decay:
                g32 = g32 + weight_decay * p32
            if momentum:
                m_new = momentum * m + (1.0 - damp) * g32
                upd = g32 + momentum * m_new if nesterov else m_new
            else:
                m_new, upd = m, g32
            delta = -lr * upd
            out = (delta if out_is_delta else p32 + delta).to(p.dtype)
            if skip is not None:
                return torch.where(skip, p, out), torch.where(skip, m, m_new)
            return out, m_new

        out_t, m_t = tree_sweep(leaf, params, grads, state.momentum)
        return out_t, TreeSGDState(next_count(state.count, skip), m_t)

    return finish_tree_optimizer(init, _sweep)
