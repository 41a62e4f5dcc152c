"""Fused functional wrappers (``apex_tpu.transformer.functional``)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    GenericScaledMaskedSoftmax,
    ScaledMaskedSoftmax,
    ScaledUpperTriangMaskedSoftmax,
)

__all__ = ["FusedScaleMaskSoftmax", "GenericScaledMaskedSoftmax",
           "ScaledMaskedSoftmax", "ScaledUpperTriangMaskedSoftmax"]
