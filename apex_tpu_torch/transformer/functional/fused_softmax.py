"""FusedScaleMaskSoftmax (apex/transformer/functional/fused_softmax.py).

Port of ``apex_tpu/transformer/functional/fused_softmax.py``. The
reference wraps two CUDA extensions behind an eligibility check (fp16 or
bf16, 16 < sk <= 2048, sq % 4 == 0, ...) and falls back to an unfused
softmax otherwise. The port's kernels have no such limits, so, as in the
JAX package, the choice is only "fusion enabled?"; the unfused path stays
for parity and for debugging against plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.kernels.softmax import (
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.enums import AttnMaskType

# the reference's autograd.Function names, as aliases of the kernels
ScaledMaskedSoftmax = scaled_masked_softmax
ScaledUpperTriangMaskedSoftmax = scaled_upper_triang_masked_softmax
GenericScaledMaskedSoftmax = scaled_masked_softmax


def _default_mask_func(scores: torch.Tensor, mask) -> torch.Tensor:
    return torch.where(torch.as_tensor(mask, device=scores.device).bool(),
                       -10000.0, scores)


class FusedScaleMaskSoftmax(torch.nn.Module):
    """``softmax(scale * mask(x))`` dispatcher. The arguments are the JAX
    dataclass's (the reference constructor's, with ``input_in_fp16/bf16``
    folded into ``softmax_in_fp32``: the kernels always reduce in fp32).

    Fused: causal with a mask composes both in the kernel; causal without
    one takes the upper-triangular variant; padding takes the masked
    one. Unfused: plain PyTorch in fp32 (with ``softmax_in_fp32``), the
    causal triangle and ``mask_func`` filling with -10000. So the paths
    differ on one input, as in the reference: a row with every entry
    masked is all zeros fused and uniform ``1 / sk`` unfused."""

    def __init__(self, attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        super().__init__()
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def forward(self, scores: torch.Tensor, mask=None) -> torch.Tensor:
        scale = 1.0 if self.scale is None else self.scale
        causal = self.attn_mask_type == AttnMaskType.causal
        if self.scaled_masked_softmax_fusion:
            if causal:
                if mask is not None:
                    # causal and padding together (the unfused path's
                    # meaning; square scores only)
                    return scaled_masked_softmax(scores, mask, scale=scale,
                                                 causal=True)
                return scaled_upper_triang_masked_softmax(scores,
                                                          scale=scale)
            return scaled_masked_softmax(scores, mask, scale=scale)
        # the unfused fallback (the reference's forward_torch_softmax)
        x = scores.float() if self.softmax_in_fp32 else scores
        x = x * scale
        if causal:
            sq, sk = x.shape[-2], x.shape[-1]
            tril = torch.ones(sq, sk, dtype=torch.bool,
                              device=x.device).tril()
            x = torch.where(tril, x, -10000.0)
        if mask is not None:
            x = (self.mask_func or _default_mask_func)(x, mask)
        probs = torch.exp(x - x.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        return probs.to(scores.dtype)
