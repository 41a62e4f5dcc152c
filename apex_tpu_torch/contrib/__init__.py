"""Optional subsystems of the port (``apex_tpu.contrib``): the fused
gradient clip. The rest of contrib comes with later slices."""

from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_

__all__ = ["clip_grad_norm_"]
