"""Mixed-precision support of the port (``apex_tpu.amp``): the dynamic
loss scaler. Opt-level policies and ``initialize`` come with a later
slice."""

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

__all__ = ["ScalerConfig", "ScalerState", "all_finite", "apply_if_finite",
           "scale_loss", "unscale", "update", "update_scale_hysteresis",
           "value_and_scaled_grad"]
