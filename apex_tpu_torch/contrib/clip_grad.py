"""Fused gradient clipping (apex contrib's ``clip_grad_norm_``).

Port of ``apex_tpu/contrib/clip_grad.py``: one kernel pass for the global
norm (:func:`~apex_tpu_torch.kernels.l2norm_flat`, ``multi_tensor_l2norm``)
and one for the rescale (:func:`~apex_tpu_torch.kernels.scale_flat`,
``multi_tensor_scale``), over the flat buffers of the gradients.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.kernels.flat_ops import (
    device_scalar,
    l2norm_flat,
    scale_flat,
)


def clip_grad_norm_(grads: Any, max_norm: float, *, eps: float = 1e-6
                    ) -> Tuple[Any, torch.Tensor]:
    """Clip a gradient tree to the global L2 norm ``max_norm`` →
    ``(clipped_grads, total_norm)``: functional, as in the JAX package
    (torch's original scales in place). The coefficient ``min(1,
    max_norm / (total + eps))`` is clamped to 1, so small gradients pass
    through unchanged; everything stays on the device."""
    bufs, layout = mt.pack(grads)
    total = l2norm_flat(bufs)
    coeff = torch.clamp(
        device_scalar(max_norm, total.device) / (total + eps), max=1.0)
    out_bufs, _ = scale_flat(bufs, coeff)
    return mt.unpack(out_bufs, layout), total
