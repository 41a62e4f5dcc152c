"""Fused softmax cross entropy with label smoothing, forward and backward.

Port of ``apex_tpu/kernels/xentropy.py`` (apex contrib's
``SoftmaxCrossEntropyLoss``): ``_run_fwd`` (kernel body ``_fwd_kernel``)
and ``_run_bwd`` (``_bwd_kernel``), joined by the custom VJP that
:func:`softmax_cross_entropy` is here as a ``torch.autograd.Function``.
The forward saves only the fp32 per-row log-sum-exp; the backward
recomputes ``softmax = exp(x - lse)`` from the logits.

- :func:`xentropy_fwd` ``(x [rows, V], target [rows]) -> (loss, lse)``,
  both fp32 ``[rows]``: CUDA tensors launch ``csrc/xentropy.cu``'s
  forward, CPU tensors run :func:`xentropy_fwd_plain`;
- :func:`xentropy_bwd` ``(x, target, lse, g) -> dx`` in x's dtype: CUDA
  tensors launch the backward, CPU tensors run
  :func:`xentropy_bwd_plain`.

Semantics, the JAX kernels': ``loss = lse - (1 - eps) * x[t] - eps *
mean(x)`` (``lse - x[t]`` at ``eps = 0``), the mean over the real vocab;
rows whose target is ``ignore_index`` get zero loss and a zero gradient
row; a target outside ``[0, V)`` reads ``x[t]`` as 0 (the JAX kernel's
zero-padded columns). The kernels take fp32 or bf16 logits and compute
in fp32; float16 is widened to fp32 and its gradient cast back, as the
JAX function's ``widen_f16`` does. The JAX kernel pads the vocab to 128
lanes and the rows to a block; nothing here is padded.

Launch counts: ``xentropy_fwd.launches`` and ``xentropy_bwd.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.kernels import _build


def _scalars(smoothing: float, vocab: int):
    """The JAX kernel's constants, as it forms them: the Python doubles
    ``1 - eps`` and ``eps / V``, each rounded once to fp32."""
    return float(smoothing), 1.0 - float(smoothing), float(smoothing) / vocab


def xentropy_fwd_plain(x: torch.Tensor, target: torch.Tensor,
                       smoothing: float = 0.0, ignore_index: int = -100
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the forward kernel: ``(loss, lse)``, fp32
    ``[rows]``, from ``x [rows, V]`` (fp32 arithmetic) and int targets
    ``[rows]``. No host sync, so a CUDA graph can capture it."""
    x32 = x.float()
    vocab = x.shape[-1]
    s, one_minus_s, _ = _scalars(smoothing, vocab)
    mx = x32.amax(dim=-1, keepdim=True)
    lse = (torch.log(torch.exp(x32 - mx).sum(dim=-1, keepdim=True))
           + mx)[:, 0]
    t = target.long()
    in_range = (t >= 0) & (t < vocab)
    pred = torch.gather(x32, 1, t.clamp(0, vocab - 1)[:, None])[:, 0]
    pred = torch.where(in_range, pred, torch.zeros_like(pred))
    loss = lse - pred
    if s > 0.0:
        mean_x = x32.sum(dim=-1) / vocab
        loss = lse - one_minus_s * pred - s * mean_x
    loss = torch.where(t == ignore_index, torch.zeros_like(loss), loss)
    return loss, lse


def xentropy_bwd_plain(x: torch.Tensor, target: torch.Tensor,
                       lse: torch.Tensor, g: torch.Tensor,
                       smoothing: float = 0.0, ignore_index: int = -100
                       ) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: ``dx = (exp(x - lse) -
    (1 - eps) * onehot(t) - eps / V) * g`` in fp32, zero rows where
    ``t == ignore_index``, in x's dtype."""
    x32 = x.float()
    vocab = x.shape[-1]
    s, one_minus_s, s_over_v = _scalars(smoothing, vocab)
    t = target.long()
    onehot = (torch.arange(vocab, device=x.device)[None, :] == t[:, None])
    grad = torch.exp(x32 - lse.float()[:, None]) - one_minus_s * onehot.float()
    if s > 0.0:
        grad = grad - s_over_v
    grad = torch.where((t == ignore_index)[:, None], torch.zeros_like(grad),
                       grad)
    return (grad * g.float()[:, None]).to(x.dtype)


def _check(x: torch.Tensor, target: torch.Tensor, what: str):
    if x.ndim != 2 or target.shape != (x.shape[0],):
        raise ValueError(f"{what}: expected x [rows, V] and target [rows], "
                         f"got {tuple(x.shape)} and {tuple(target.shape)}")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def xentropy_fwd(x: torch.Tensor, target: torch.Tensor, *,
                 smoothing: float = 0.0, ignore_index: int = -100
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row smoothed cross entropy and log-sum-exp → ``(loss, lse)``,
    fp32 ``[rows]``. ``x`` is ``[rows, V]``, fp32 or bf16 for the kernel
    (:func:`softmax_cross_entropy` widens float16); ``target`` holds int
    ids ``[rows]``. CUDA tensors launch the kernel (counted in
    ``xentropy_fwd.launches``); CPU tensors run the plain version."""
    rows, vocab = _check(x, target, "xentropy_fwd")
    if not _build.on_cuda(x, target):
        return xentropy_fwd_plain(x, target, smoothing, ignore_index)
    code = _build.dtype_code(x, "xentropy_fwd logits")
    _build.require(x, "x", (rows, vocab), x.dtype)
    t32 = target.to(torch.int32).contiguous()
    s, one_minus_s, _ = _scalars(smoothing, vocab)
    loss = torch.empty(rows, dtype=torch.float32, device=x.device)
    lse = torch.empty(rows, dtype=torch.float32, device=x.device)
    rc = _build.library().apex_tpu_torch_xentropy_fwd(
        x.data_ptr(), t32.data_ptr(), loss.data_ptr(), lse.data_ptr(), rows,
        vocab, s, one_minus_s, int(ignore_index), code, _build.stream())
    _build.check(rc, "xentropy_fwd")
    xentropy_fwd.launches += 1
    return loss, lse


xentropy_fwd.launches = 0


def xentropy_bwd(x: torch.Tensor, target: torch.Tensor, lse: torch.Tensor,
                 g: torch.Tensor, *, smoothing: float = 0.0,
                 ignore_index: int = -100) -> torch.Tensor:
    """``dx [rows, V]`` in x's dtype from the logits, the targets, the
    forward's fp32 ``lse [rows]`` and the upstream gradient ``g [rows]``.
    CUDA tensors launch the kernel (counted in
    ``xentropy_bwd.launches``); CPU tensors run the plain version."""
    rows, vocab = _check(x, target, "xentropy_bwd")
    if not _build.on_cuda(x, target, lse, g):
        return xentropy_bwd_plain(x, target, lse, g, smoothing, ignore_index)
    code = _build.dtype_code(x, "xentropy_bwd logits")
    _build.require(x, "x", (rows, vocab), x.dtype)
    _build.require(lse, "lse", (rows,), torch.float32)
    g = g.to(torch.float32).contiguous()
    _build.require(g, "g", (rows,), torch.float32)
    t32 = target.to(torch.int32).contiguous()
    s, one_minus_s, s_over_v = _scalars(smoothing, vocab)
    dx = torch.empty_like(x)
    rc = _build.library().apex_tpu_torch_xentropy_bwd(
        x.data_ptr(), t32.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), rows, vocab, s, one_minus_s, s_over_v,
        int(ignore_index), code, _build.stream())
    _build.check(rc, "xentropy_bwd")
    xentropy_bwd.launches += 1
    return dx


xentropy_bwd.launches = 0


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves the logits (an input,
    not a copy), the targets and the fp32 lse; the backward is the
    backward kernel."""

    @staticmethod
    def forward(ctx, x2, t2, smoothing: float, ignore_index: int):
        loss, lse = xentropy_fwd(x2, t2, smoothing=smoothing,
                                 ignore_index=ignore_index)
        ctx.save_for_backward(x2, t2, lse)
        ctx.smoothing, ctx.ignore_index = smoothing, ignore_index
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x2, t2, lse = ctx.saved_tensors
        dx = xentropy_bwd(x2, t2, lse, dloss, smoothing=ctx.smoothing,
                          ignore_index=ctx.ignore_index)
        return dx, None, None, None


def softmax_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                          label_smoothing: float = 0.0,
                          ignore_index: int = -100) -> torch.Tensor:
    """Per-token loss, fp32 of ``target``'s shape, from ``logits [...,
    V]`` and int ``target [...]``; differentiable in the logits. Drop-in
    for apex contrib ``SoftmaxCrossEntropyLoss``: fused, label smoothing,
    ``ignore_index`` rows contribute zero loss and zero gradient. float16
    logits are widened to fp32 (the loss is fp32 either way) and their
    gradient comes back in float16."""
    shape = target.shape
    if logits.dtype == torch.float16:
        logits = logits.float()
    x2 = logits.reshape(-1, logits.shape[-1]).contiguous()
    t2 = target.reshape(-1).to(torch.int32)
    loss = _SoftmaxCrossEntropy.apply(x2, t2, float(label_smoothing),
                                      int(ignore_index))
    return loss.reshape(shape)


__all__ = ["softmax_cross_entropy", "xentropy_bwd", "xentropy_bwd_plain",
           "xentropy_fwd", "xentropy_fwd_plain"]
