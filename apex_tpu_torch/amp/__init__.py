"""Mixed precision of the port (``apex_tpu.amp``): opt-level policies,
``initialize`` and the dynamic loss scaler.

Port of ``apex_tpu/amp/__init__.py``. apex's

.. code-block:: python

    model, optimizer = amp.initialize(model, optimizer, opt_level="O2")
    with amp.scale_loss(loss, optimizer) as scaled_loss:
        scaled_loss.backward()

becomes, functionally:

.. code-block:: python

    amp_ctx, apply_fn = amp.initialize(model_apply, opt_level="O2",
                                       half_dtype=torch.float16)
    scaler = amp_ctx.init_scaler_state()
    value, grads, finite = amp_ctx.value_and_grad(loss_fn)(
        params, scaler_state=scaler)
    scaler = amp_ctx.update_scaler(scaler, finite)

or, in a train step, ``amp_ctx.scaler`` as its ``scaler_cfg``. The
scaler state lives on the device; nothing waits on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.amp.policy import HALF_DTYPES, Policy, get_policy
from apex_tpu_torch.amp.scaler import (
    ScalerConfig,
    ScalerState,
    all_finite,
    apply_if_finite,
    scale_loss,
    unscale,
    update,
    update_scale_hysteresis,
    value_and_scaled_grad,
)


@dataclasses.dataclass(frozen=True)
class Amp:
    """Precision policy plus scaler configuration, as :func:`initialize`
    returns them: the functional form of apex's patched (model,
    optimizer) pair and its ``_amp_state``."""

    policy: Policy
    scaler: ScalerConfig

    def init_scaler_state(self, device: Optional[Union[str, torch.device]]
                          = None) -> ScalerState:
        """The scaler's initial state on ``device`` (None → CUDA)."""
        return self.scaler.init(device=device)

    def value_and_grad(self, fun: Callable, **kw):
        return value_and_scaled_grad(fun, self.scaler, **kw)

    def update_scaler(self, state: ScalerState, grads_finite) -> ScalerState:
        return update(self.scaler, state, grads_finite)

    # -- checkpointing: apex amp.state_dict()/load_state_dict() ------------
    @staticmethod
    def state_dict(state: ScalerState) -> dict:
        """Host numbers (reading them waits for the device)."""
        return {"loss_scale": float(state.loss_scale),
                "growth_count": int(state.growth_count),
                "hysteresis_left": int(state.hysteresis_left)}

    @staticmethod
    def load_state_dict(d: dict, device: Optional[Union[str, torch.device]]
                        = None) -> ScalerState:
        """The state of a :meth:`state_dict` on ``device`` (None →
        CUDA)."""
        dev = resolve_device(device)
        return ScalerState(
            loss_scale=torch.tensor(float(d["loss_scale"]),
                                    dtype=torch.float32, device=dev),
            growth_count=torch.tensor(int(d["growth_count"]),
                                      dtype=torch.int32, device=dev),
            hysteresis_left=torch.tensor(int(d["hysteresis_left"]),
                                         dtype=torch.int32, device=dev))


def initialize(apply_fn: Optional[Callable] = None, opt_level: str = "O1",
               *, half_dtype=torch.bfloat16,
               loss_scale: Union[str, float, None] = "policy",
               **policy_overrides) -> Tuple[Amp, Optional[Callable]]:
    """Configure mixed precision, as ``amp.initialize`` does.

    - ``apply_fn``: an optional model function ``f(params, *args)``; if
      given, a wrapped version is returned that casts params and inputs
      to the compute dtype and the result to the output dtype (O1's op
      patching and O2's ``model.half()``, done structurally);
    - ``opt_level``: ``"O0" | "O1" | "O2" | "O3"``;
    - ``half_dtype``: ``torch.bfloat16`` (no scaling) or
      ``torch.float16``;
    - ``loss_scale``: ``"policy"`` (the opt level's), ``"dynamic"``, a
      static number (never grows, never backs off), or None (disabled);
    - ``policy_overrides``: fields of :class:`Policy`, like apex's
      ``amp.initialize(..., keep_batchnorm_fp32=True)``.

    Returns ``(amp_ctx, wrapped_apply_or_None)``."""
    policy = get_policy(opt_level, half_dtype)
    if policy_overrides:
        policy = policy.with_(**policy_overrides)
    if loss_scale == "policy":
        loss_scale = policy.loss_scale
    if loss_scale is None:
        cfg = ScalerConfig(enabled=False)
    elif loss_scale == "dynamic":
        cfg = ScalerConfig(enabled=True)
    else:
        ls = float(loss_scale)
        cfg = ScalerConfig(init_scale=ls, growth_factor=1.0,
                           backoff_factor=1.0, min_scale=ls, max_scale=ls,
                           enabled=True)
    ctx = Amp(policy=policy, scaler=cfg)

    wrapped = None
    if apply_fn is not None:
        def wrapped(params, *args, **kwargs):
            params = policy.cast_to_compute(params)
            args = policy.cast_to_compute(args)
            return policy.cast_to_output(apply_fn(params, *args, **kwargs))

    return ctx, wrapped


def master_params(state_or_params: Any) -> Any:
    """The fp32 master copy of the parameters (``amp.master_params``):
    the ``master_params`` attribute of an optimizer state that keeps
    masters (the O2 pattern), else the params themselves (O0/O1, where
    the params are the masters)."""
    masters = getattr(state_or_params, "master_params", None)
    return state_or_params if masters is None else masters


def state_dict(state: ScalerState) -> dict:
    """Module-level :meth:`Amp.state_dict` (apex's ``amp.state_dict()``)."""
    return Amp.state_dict(state)


def load_state_dict(d: dict, device: Optional[Union[str, torch.device]]
                    = None) -> ScalerState:
    """Module-level :meth:`Amp.load_state_dict`."""
    return Amp.load_state_dict(d, device)


__all__ = ["Amp", "HALF_DTYPES", "Policy", "ScalerConfig", "ScalerState",
           "all_finite", "apply_if_finite", "get_policy", "initialize",
           "load_state_dict", "master_params", "scale_loss", "state_dict",
           "unscale", "update", "update_scale_hysteresis",
           "value_and_scaled_grad"]
