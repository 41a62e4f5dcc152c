"""Fused optimizers of the port (``apex_tpu.optimizers``): FusedAdam and
FusedLAMB, each in both layouts. SGD, Adagrad, NovoGrad and the ZeRO
optimizers come with later slices."""

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

__all__ = ["FusedAdamState", "FusedLAMBState", "FusedOptimizer",
           "TreeAdamState", "TreeLAMBState", "fused_adam", "fused_lamb"]
