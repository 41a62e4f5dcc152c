"""Fused optimizers of the port (``apex_tpu.optimizers``): FusedAdam,
FusedLAMB, FusedSGD, FusedAdagrad and FusedNovoGrad, each in both
layouts, and the LARC gradient transform. The ZeRO optimizers come with
the distributed slice of ZeRO and FSDP."""

from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adagrad import (
    FusedAdagradState,
    TreeAdagradState,
    fused_adagrad,
)
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
from apex_tpu_torch.optimizers.fused_novograd import (
    FusedNovoGradState,
    TreeNovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optimizers.fused_sgd import (
    FusedSGDState,
    TreeSGDState,
    fused_sgd,
)
from apex_tpu_torch.optimizers.larc import larc_transform

# apex class-name aliases
FusedAdagrad = fused_adagrad
FusedNovoGrad = fused_novograd

__all__ = ["FusedAdagrad", "FusedAdagradState", "FusedAdamState",
           "FusedLAMBState", "FusedNovoGrad", "FusedNovoGradState",
           "FusedOptimizer", "FusedSGDState", "TreeAdagradState",
           "TreeAdamState", "TreeLAMBState", "TreeNovoGradState",
           "TreeSGDState",
           "fused_adagrad", "fused_adam", "fused_lamb", "fused_novograd",
           "fused_sgd", "larc_transform"]
