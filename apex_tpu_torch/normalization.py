"""apex.normalization name-parity layer over the LayerNorm kernels.

Port of ``apex_tpu/normalization.py``. The reference's four classes
differ only in statistic (mean and variance vs RMS) and in how the
parameters' dtype is handled (``MixedFused*`` keep fp32 affine
parameters with half I/O). The port's kernels
(:mod:`apex_tpu_torch.kernels.layer_norm`) compute both statistics in
fp32 and take any mix of parameter and input dtype, so every class is a
functional alias of one of two functions:

- ``FusedLayerNorm`` / ``MixedFusedLayerNorm`` → :func:`fused_layer_norm`
- ``FusedRMSNorm`` / ``MixedFusedRMSNorm`` → :func:`fused_rms_norm`
"""

from apex_tpu_torch.kernels.layer_norm import layer_norm as fused_layer_norm
from apex_tpu_torch.kernels.layer_norm import rms_norm as fused_rms_norm

FusedLayerNorm = fused_layer_norm
MixedFusedLayerNorm = fused_layer_norm
FusedRMSNorm = fused_rms_norm
MixedFusedRMSNorm = fused_rms_norm

__all__ = [
    "fused_layer_norm",
    "fused_rms_norm",
    "FusedLayerNorm",
    "MixedFusedLayerNorm",
    "FusedRMSNorm",
    "MixedFusedRMSNorm",
]
