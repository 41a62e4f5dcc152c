"""Vocab-parallel cross entropy.

Port of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
(``_fwd_core``, ``_vpce_bwd``; apex's ``_VocabParallelCrossEntropy``).
The logits stay vocab-sharded: each rank holds ``[..., vocab/tp]`` and
three all-reduces over the tp axis (the max, the target's logit, the
sum of exponentials; a fourth for the smoothing term) make every rank's
per-token loss the whole vocab's. Over a tp axis of one rank, or with no
mesh, those are identities.

It is a :class:`torch.autograd.Function` whose backward is the closed
form ``softmax - (1 - eps) * onehot - eps / vocab``, times the incoming
gradient, in the logits' dtype — the reference hand-writes it for the
same reason, instead of differentiating through the gather. Statistics
are fp32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.mesh import collectives as C
from apex_tpu_torch.mesh.topology import AXIS_TP, Mesh
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility


def _fwd_core(logits: torch.Tensor, target: torch.Tensor,
              label_smoothing: float, axis: str = AXIS_TP,
              mesh: Optional[Mesh] = None):
    """→ ``(loss, softmax, mask, masked_target, vocab_size)``: per-token
    fp32 loss, this rank's block of the softmax and the global vocab
    size. ``mesh`` None (or a tp axis of one rank) is the whole vocab on
    this device."""
    per_partition = logits.shape[-1]
    tp = mesh if mesh is not None and mesh.size(axis) > 1 else None
    if tp is None:
        start, size = 0, 1
    else:
        size = tp.size(axis)
        start, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, tp.index(axis), size)
    vocab_size = per_partition * size
    logits_max = logits.amax(dim=-1)
    if tp is not None:
        logits_max = C.pmax(logits_max, axis, tp)
    shifted = logits.float() - logits_max.float()[..., None]
    mask = (target >= start) & (target < start + per_partition)
    masked_target = torch.where(mask, target - start,
                                torch.zeros_like(target)).long()
    predicted = shifted.gather(-1, masked_target[..., None])[..., 0]
    predicted = predicted * mask.to(shifted.dtype)
    if tp is not None:
        predicted = C.psum(predicted, axis, tp)
    exp_logits = shifted.exp_()            # in place: shifted is not reused
    sum_exp = exp_logits.sum(dim=-1)
    if tp is not None:
        sum_exp = C.psum(sum_exp, axis, tp)
    loss = torch.log(sum_exp) - predicted
    softmax = exp_logits.div_(sum_exp[..., None])
    if label_smoothing > 0.0:
        # smoothed NLL: (1 - eps) * CE + eps * mean over vocab of -log p
        eps = label_smoothing
        sum_log_probs = torch.log(softmax.clamp_min(1e-30)).sum(dim=-1)
        if tp is not None:
            sum_log_probs = C.psum(sum_log_probs, axis, tp)
        loss = (1.0 - eps) * loss - eps * (sum_log_probs / vocab_size)
    return loss, softmax, mask, masked_target, vocab_size


class _VocabParallelCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing, axis, mesh):
        loss, softmax, mask, masked_target, vocab = _fwd_core(
            logits, target, label_smoothing, axis, mesh)
        ctx.save_for_backward(softmax, mask, masked_target)
        ctx.label_smoothing = label_smoothing
        ctx.vocab_size = vocab
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, mask, masked_target = ctx.saved_tensors
        eps = ctx.label_smoothing
        onehot_scale = (1.0 - eps) if eps > 0.0 else 1.0
        grad = (softmax - eps / ctx.vocab_size if eps > 0.0
                else softmax.clone())
        grad.scatter_add_(-1, masked_target[..., None],
                          (-onehot_scale * mask.to(grad.dtype))[..., None])
        grad.mul_(g[..., None])
        return grad.to(ctx.logits_dtype), None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 axis: str = AXIS_TP, *,
                                 mesh: Optional[Mesh] = None
                                 ) -> torch.Tensor:
    """Per-token fp32 loss from this rank's ``logits [..., vocab/tp]``
    and the global ``target [...]`` ids; differentiable in the logits.
    ``mesh`` None: the whole vocab is local (tp = 1)."""
    return _VocabParallelCrossEntropy.apply(logits, target,
                                            float(label_smoothing), axis,
                                            mesh)
