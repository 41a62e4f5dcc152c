"""Vocab-parallel cross entropy at tp=1.

Port of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
(``_fwd_core``, ``_vpce_bwd``; apex's ``_VocabParallelCrossEntropy``) for
one tensor-parallel rank: the vocab is whole on this device, so the
three all-reduces of the reference are identities. It is a
:class:`torch.autograd.Function` whose backward is the closed form
``softmax - (1 - eps) * onehot - eps / vocab``, times the incoming
gradient, in the logits' dtype — the reference hand-writes it for the
same reason, instead of differentiating through the gather. Statistics
are fp32 whatever the logits' dtype. The tensor-parallel form comes with
the distributed slice.
"""

from __future__ import annotations

import torch


def _fwd_core(logits: torch.Tensor, target: torch.Tensor,
              label_smoothing: float):
    """→ ``(loss, softmax, mask, masked_target)`` at one rank that owns
    the whole vocab: per-token fp32 loss and the saved softmax."""
    vocab_size = logits.shape[-1]
    logits_max = logits.amax(dim=-1)
    shifted = logits.float() - logits_max.float()[..., None]
    mask = (target >= 0) & (target < vocab_size)
    masked_target = torch.where(mask, target, torch.zeros_like(target)).long()
    predicted = shifted.gather(-1, masked_target[..., None])[..., 0]
    predicted = predicted * mask.to(shifted.dtype)
    exp_logits = shifted.exp_()            # in place: shifted is not reused
    sum_exp = exp_logits.sum(dim=-1)
    loss = torch.log(sum_exp) - predicted
    softmax = exp_logits.div_(sum_exp[..., None])
    if label_smoothing > 0.0:
        # smoothed NLL: (1 - eps) * CE + eps * mean over vocab of -log p
        eps = label_smoothing
        sum_log_probs = torch.log(softmax.clamp_min(1e-30)).sum(dim=-1)
        loss = (1.0 - eps) * loss - eps * (sum_log_probs / vocab_size)
    return loss, softmax, mask, masked_target


class _VocabParallelCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        loss, softmax, mask, masked_target = _fwd_core(logits, target,
                                                       label_smoothing)
        ctx.save_for_backward(softmax, mask, masked_target)
        ctx.label_smoothing = label_smoothing
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, mask, masked_target = ctx.saved_tensors
        eps = ctx.label_smoothing
        onehot_scale = (1.0 - eps) if eps > 0.0 else 1.0
        grad = (softmax - eps / softmax.shape[-1] if eps > 0.0
                else softmax.clone())
        grad.scatter_add_(-1, masked_target[..., None],
                          (-onehot_scale * mask.to(grad.dtype))[..., None])
        grad.mul_(g[..., None])
        return grad.to(ctx.logits_dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-token fp32 loss from ``logits [..., vocab]`` and ``target
    [...]`` ids; differentiable in the logits."""
    return _VocabParallelCrossEntropy.apply(logits, target,
                                            float(label_smoothing))
