"""Fused optimizers of the port (``apex_tpu.optimizers``): FusedAdam,
FusedLAMB and FusedSGD, each in both layouts. Adagrad, NovoGrad and the
ZeRO optimizers come with later slices."""

from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import (
    FusedAdamState,
    TreeAdamState,
    fused_adam,
)
from apex_tpu_torch.optimizers.fused_lamb import (
    FusedLAMBState,
    TreeLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_sgd import (
    FusedSGDState,
    TreeSGDState,
    fused_sgd,
)

__all__ = ["FusedAdamState", "FusedLAMBState", "FusedOptimizer",
           "FusedSGDState", "TreeAdamState", "TreeLAMBState",
           "TreeSGDState", "fused_adam", "fused_lamb", "fused_sgd"]
