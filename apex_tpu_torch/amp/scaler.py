"""Functional dynamic loss scaling, on the device.

Port of ``apex_tpu/amp/scaler.py`` (apex's ``LossScaler`` and
``csrc/update_scale_hysteresis.cu``). The scaler is a tuple of 0-d
device tensors, and every decision — unscale, overflow check, skip,
grow or back off — is a ``torch.where``, so a train step carries both
the clean and the overflow path with no host sync.

Semantics are apex's defaults: initial scale 2^16, x2 growth after 2000
consecutive finite steps, x0.5 backoff on inf/nan, optional hysteresis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch._capabilities import resolve_device


@dataclasses.dataclass(frozen=True)
class ScalerConfig:
    """Static scaler configuration (apex ``LossScaler.__init__``)."""

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    hysteresis: int = 1
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24
    #: False → identity scaler (bf16/fp32 policies); keeps one code path
    enabled: bool = True

    def init(self, device: Optional[Union[str, torch.device]] = None
             ) -> "ScalerState":
        """The initial state on ``device`` (None → CUDA)."""
        dev = resolve_device(device)
        return ScalerState(
            loss_scale=torch.tensor(
                self.init_scale if self.enabled else 1.0,
                dtype=torch.float32, device=dev),
            growth_count=torch.tensor(0, dtype=torch.int32, device=dev),
            hysteresis_left=torch.tensor(self.hysteresis, dtype=torch.int32,
                                         device=dev))


class ScalerState(NamedTuple):
    """Device-resident scaler state (apex ``amp.state_dict()``)."""

    loss_scale: torch.Tensor       # fp32 0-d
    growth_count: torch.Tensor     # int32 0-d: consecutive finite steps
    hysteresis_left: torch.Tensor  # int32 0-d: overflow tolerance left


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def scale_loss(loss, state: ScalerState):
    """``loss * scale`` in fp32 (2^16 does not fit float16)."""
    return _tree.tree_map(lambda l: l.float() * state.loss_scale, loss)


def all_finite(tree: Any) -> torch.Tensor:
    """One bool 0-d tensor: every floating leaf is free of inf and NaN."""
    leaves = [x for x in _tree.leaves(tree) if _is_float(x)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def unscale(grads: Any, state: ScalerState) -> Any:
    """``grad * (1 / scale)`` on every floating leaf, into fp32 (apex's
    ``multi_tensor_scale`` writes fp32 master grads)."""
    inv = 1.0 / state.loss_scale
    return _tree.tree_map(
        lambda g: g.float() * inv if _is_float(g) else g, grads)


def update(cfg: ScalerConfig, state: ScalerState, grads_finite
           ) -> ScalerState:
    """Post-step scale update — apex ``update_scale`` plus hysteresis,
    branch-free."""
    if not cfg.enabled:
        return state
    scale, count, hyst = state
    finite = torch.as_tensor(grads_finite, device=scale.device).bool()

    # clean step: bump the counter; at growth_interval grow and reset
    new_count = count + 1
    should_grow = finite & (new_count >= cfg.growth_interval)
    grown = torch.clamp(scale * cfg.growth_factor, cfg.min_scale,
                        cfg.max_scale)
    scale_clean = torch.where(should_grow, grown, scale)
    count_clean = torch.where(should_grow, torch.zeros_like(new_count),
                              new_count)

    # overflow step: spend hysteresis; back off only when exhausted
    hyst_spent = hyst - 1
    should_backoff = hyst_spent <= 0
    backed = torch.clamp(scale * cfg.backoff_factor, cfg.min_scale,
                         cfg.max_scale)
    scale_over = torch.where(should_backoff, backed, scale)
    hyst_over = torch.where(should_backoff,
                            torch.full_like(hyst, cfg.hysteresis), hyst_spent)

    return ScalerState(
        loss_scale=torch.where(finite, scale_clean, scale_over),
        growth_count=torch.where(finite, count_clean,
                                 torch.zeros_like(count)).to(torch.int32),
        hysteresis_left=torch.where(
            finite, torch.full_like(hyst, cfg.hysteresis),
            hyst_over).to(torch.int32))


def apply_if_finite(new_tree: Any, old_tree: Any, grads_finite) -> Any:
    """Select updated vs previous values — "skip ``optimizer.step()`` on
    overflow" without a branch. Works on params and optimizer state."""
    return _tree.tree_map(
        lambda n, o: torch.where(torch.as_tensor(grads_finite,
                                                 device=n.device), n, o),
        new_tree, old_tree)


def value_and_scaled_grad(fun: Callable, cfg: ScalerConfig, *,
                          has_aux: bool = False):
    """Differentiate ``fun(params, *args)`` in ``params`` under loss
    scaling; return unscaled grads. The one-call form of apex's ``with
    amp.scale_loss(loss, optimizer) as scaled: scaled.backward()``.

    Returns ``wrapped(params, *args, scaler_state) -> (value[, aux],
    grads, grads_finite)``: ``grads`` a tree like ``params``, fp32 for
    floating leaves, already unscaled; ``grads_finite`` the bool 0-d
    overflow flag for :func:`update` and the optimizer's ``skip``. With
    the scaler disabled nothing is scaled, half grads still come back in
    fp32, and the flag is reported for observation only."""

    def wrapped(params, *args, scaler_state: ScalerState):
        leaves, spec = _tree.flatten(params)
        diff = [x.detach().requires_grad_(x.is_floating_point())
                for x in leaves]
        with torch.enable_grad():
            out = fun(_tree.unflatten(spec, diff), *args)
            value, aux = out if has_aux else (out, None)
            target = (scale_loss(value, scaler_state) if cfg.enabled
                      else value)
            wrt = [x for x in diff if x.requires_grad]
            got = iter(torch.autograd.grad(target, wrt, allow_unused=True))
        grads = []
        for x in diff:
            g = next(got) if x.requires_grad else None
            if x.requires_grad and g is None:
                g = torch.zeros_like(x)
            grads.append(g)
        grads = _tree.unflatten(spec, grads)
        if cfg.enabled:
            grads = unscale(grads, scaler_state)
            value = target.detach().float() / scaler_state.loss_scale
        else:
            grads = _tree.tree_map(
                lambda g: g.float() if _is_float(g) else g, grads)
            value = value.detach().float()
        finite = all_finite(grads)
        if has_aux:
            return (value, aux), grads, finite
        return value, grads, finite

    return wrapped


def update_scale_hysteresis(current_scale, growth_tracker, hysteresis_tracker,
                            found_inf, growth_factor: float = 2.0,
                            backoff_factor: float = 0.5,
                            growth_interval: int = 2000,
                            hysteresis: int = 1):
    """``csrc/update_scale_hysteresis.cu`` semantics, branch-free → the
    new ``(scale, growth_tracker, hysteresis_tracker)``. ``found_inf`` is
    nonzero on overflow (torch GradScaler polarity). The tracker only
    decrements on overflow and backs off on every overflow once spent;
    growth is skipped where it would leave the fp32 range. ``hysteresis``
    is accepted for signature parity (the reference reads only the
    tracker)."""
    del hysteresis
    scale = torch.as_tensor(current_scale, dtype=torch.float32)
    dev = scale.device
    growth = torch.as_tensor(growth_tracker, dtype=torch.int32, device=dev)
    hyst = torch.as_tensor(hysteresis_tracker, dtype=torch.int32, device=dev)
    finite = torch.as_tensor(found_inf, device=dev) == 0

    hyst_new = torch.where(finite, hyst, hyst - 1)
    backoff = (~finite) & (hyst_new <= 0)
    growth_new = torch.where(finite, growth + 1,
                             torch.zeros_like(growth)).to(torch.int32)
    grown = scale * growth_factor
    grow = finite & (growth_new >= growth_interval) & torch.isfinite(grown)
    new_scale = torch.where(grow, grown, scale)
    new_scale = torch.where(backoff, scale * backoff_factor, new_scale)
    growth_out = torch.where(finite & (growth_new >= growth_interval),
                             torch.zeros_like(growth_new), growth_new)
    return new_scale, growth_out.to(torch.int32), hyst_new.to(torch.int32)
