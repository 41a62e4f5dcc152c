"""Fused optimizers of the port (``apex_tpu.optimizers``): FusedAdam in
both layouts. LAMB, SGD, Adagrad, NovoGrad and the ZeRO optimizers come
with later slices."""

from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import (
    FusedAdamState,
    TreeAdamState,
    fused_adam,
)

__all__ = ["FusedAdamState", "FusedOptimizer", "TreeAdamState", "fused_adam"]
