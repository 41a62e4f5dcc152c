"""Fused LayerNorm / RMSNorm over the last axis, forward and backward, as
differentiable custom ops.

Port of ``apex_tpu/kernels/layer_norm.py`` (``_fwd``, ``_bwd``, the
custom VJP ``_norm`` and the public ``layer_norm`` / ``rms_norm``), apex's
``fused_layer_norm_cuda``. One pair of kernels covers both statistics:
``subtract_mean=False`` is RMSNorm. Statistics are fp32 whatever the I/O
type; the affine parameters may be fp32 with bf16 inputs (apex's
``MixedFused*`` behaviour); float16 inputs are widened to fp32 at the
public functions and the result is cast back, as the JAX package's
``widen_f16`` does.

Two ops of the ``apex_tpu_torch`` library, joined by
``register_autograd``:

- ``apex_tpu_torch::layer_norm_fwd(x, w, b, eps, subtract_mean) -> (y,
  mean, rstd)`` over ``x [rows, hidden]`` — CUDA tensors launch
  ``csrc/layer_norm.cu``, CPU tensors run :func:`layer_norm_fwd_plain`;
- ``apex_tpu_torch::layer_norm_bwd(x, w, mean, rstd, dy, subtract_mean)
  -> (dx, dw, db)`` — CUDA tensors launch the two-pass backward of
  ``csrc/layer_norm.cu``, CPU tensors run :func:`layer_norm_bwd_plain`.
  ``dw`` and ``db`` are fp32; the autograd formula casts them to the
  parameters' dtype (``db`` is zero for RMSNorm).

Being ops, they are what selective activation checkpointing sees, and
the forward's saved ``(mean, rstd)`` are its outputs, as the JAX custom
VJP saves them as residuals.

Python wrappers: :func:`layer_norm_fwd` and :func:`layer_norm_bwd` (the
kernels' calls, launch counts in ``layer_norm_fwd.launches`` and
``layer_norm_bwd.launches``), and :func:`layer_norm` / :func:`rms_norm`
(the JAX package's functions, differentiable in x, weight and bias).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.kernels import _build


def _rows(x: torch.Tensor):
    if x.ndim != 2:
        raise ValueError(f"expected [rows, hidden], got {tuple(x.shape)}")
    return x.shape


def layer_norm_fwd_plain(x, w, b, eps: float, subtract_mean: bool
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the forward kernel: ``(y in x's dtype, mean
    fp32 [rows], rstd fp32 [rows])`` — ``_fwd_kernel``'s two-moment form
    in fp32."""
    rows, hidden = _rows(x)
    x32 = x.float()
    if subtract_mean:
        mean = x32.sum(-1, keepdim=True) / hidden
        diff = x32 - mean
    else:
        mean = torch.zeros((rows, 1), dtype=torch.float32, device=x.device)
        diff = x32
    var = (diff * diff).sum(-1, keepdim=True) / hidden
    rstd = torch.rsqrt(var + eps)
    y = (diff * rstd * w.float() + b.float()).to(x.dtype)
    return y, mean[:, 0].contiguous(), rstd[:, 0].contiguous()


def layer_norm_bwd_plain(x, w, mean, rstd, dy, subtract_mean: bool
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the backward kernels: ``_bwd_kernel``'s
    ``dx = (w dy - xhat c1 - c2) rstd`` in x's dtype, and fp32 ``dw =
    sum_rows dy xhat``, ``db = sum_rows dy``."""
    rows, hidden = _rows(x)
    x32, dy32 = x.float(), dy.float()
    rs = rstd.float()[:, None]
    xhat = (x32 - mean.float()[:, None]) * rs
    wdy = dy32 * w.float()
    c1 = (wdy * xhat).sum(-1, keepdim=True) / hidden
    c2 = (wdy.sum(-1, keepdim=True) / hidden if subtract_mean
          else torch.zeros_like(c1))
    dx = ((wdy - xhat * c1 - c2) * rs).to(x.dtype)
    return dx, (dy32 * xhat).sum(0), dy32.sum(0)


def _check_fwd(x, w, b):
    rows, hidden = _rows(x)
    _build.require(x, "x", (rows, hidden), x.dtype)
    _build.require(w, "weight", (hidden,), w.dtype)
    _build.require(b, "bias", (hidden,), w.dtype)
    return (rows, hidden, _build.dtype_code(x, "layer_norm x"),
            _build.dtype_code(w, "layer_norm weight"))


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@torch.library.custom_op("apex_tpu_torch::layer_norm_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float,
            subtract_mean: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not _build.on_cuda(x, w, b):
        return layer_norm_fwd_plain(x, w, b, eps, subtract_mean)
    rows, hidden, xc, wc = _check_fwd(x, w, b)
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    rc = _build.library().apex_tpu_torch_layer_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, hidden, eps,
        int(subtract_mean), xc, wc, _build.stream())
    _build.check(rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


@_fwd_op.register_fake
def _fwd_fake(x, w, b, eps, subtract_mean):
    rows = x.shape[0]
    return (torch.empty_like(x),
            x.new_empty(rows, dtype=torch.float32),
            x.new_empty(rows, dtype=torch.float32))


@torch.library.custom_op("apex_tpu_torch::layer_norm_bwd", mutates_args=())
def _bwd_op(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
            rstd: torch.Tensor, dy: torch.Tensor, subtract_mean: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not _build.on_cuda(x, w, mean, rstd, dy):
        return layer_norm_bwd_plain(x, w, mean, rstd, dy, subtract_mean)
    rows, hidden, xc, wc = _check_fwd(x, w, w)
    _build.require(dy, "dy", (rows, hidden), x.dtype)
    for name, t in (("mean", mean), ("rstd", rstd)):
        _build.require(t, name, (rows,), torch.float32)
    lib = _build.library()
    nblk = lib.apex_tpu_torch_layer_norm_bwd_blocks(rows)
    work = torch.empty((nblk, 2, hidden), dtype=torch.float32,
                       device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty(hidden, dtype=torch.float32, device=x.device)
    db = torch.empty(hidden, dtype=torch.float32, device=x.device)
    rc = lib.apex_tpu_torch_layer_norm_bwd(
        x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), rows, hidden, int(subtract_mean), xc, wc,
        _build.stream())
    _build.check(rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dw, db


@_bwd_op.register_fake
def _bwd_fake(x, w, mean, rstd, dy, subtract_mean):
    hidden = x.shape[1]
    return (torch.empty_like(x), x.new_empty(hidden, dtype=torch.float32),
            x.new_empty(hidden, dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    x, w, _, _, subtract_mean = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, w, mean, rstd)
    ctx.subtract_mean = subtract_mean


def _backward(ctx, dy, _dmean, _drstd):
    """The JAX ``_norm_bwd``: the backward op, ``dw``/``db`` cast to the
    weight's dtype, ``db`` zero for RMSNorm; mean and rstd carry no
    gradient."""
    x, w, mean, rstd = ctx.saved_tensors
    dx, dw, db = _bwd_op(x, w, mean, rstd, dy.contiguous(),
                         ctx.subtract_mean)
    if not ctx.subtract_mean:
        db = torch.zeros_like(dw)
    return dx, dw.to(w.dtype), db.to(w.dtype), None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def layer_norm_fwd(x, w, b, *, eps: float, subtract_mean: bool = True
                   ) -> Tuple[torch.Tensor, ...]:
    """``(y, mean, rstd)`` over ``x [rows, hidden]``, differentiable in x,
    w and b. CUDA tensors launch the kernel on the current stream
    (counted in ``layer_norm_fwd.launches``): x fp32 or bf16, w and b one
    dtype of fp32 or bf16, all contiguous. CPU tensors run the plain
    version."""
    _build.on_cuda(x, w, b)       # refuse other and mixed devices here
    return _fwd_op(x, w, b, float(eps), bool(subtract_mean))


layer_norm_fwd.launches = 0


def layer_norm_bwd(x, w, mean, rstd, dy, *, subtract_mean: bool = True
                   ) -> Tuple[torch.Tensor, ...]:
    """``(dx, dw, db)`` — ``dw``/``db`` fp32 — from the forward's input,
    weight and statistics and the output gradient ``dy``. CUDA tensors
    launch the two-pass kernel (counted in ``layer_norm_bwd.launches``),
    CPU tensors run the plain version."""
    _build.on_cuda(x, w, mean, rstd, dy)
    return _bwd_op(x, w, mean, rstd, dy, bool(subtract_mean))


layer_norm_bwd.launches = 0


def _norm(x, weight, bias, eps: float, subtract_mean: bool):
    shape = x.shape
    was16 = x.dtype == torch.float16
    if was16:
        x = x.float()
    if weight.dtype == torch.float16:
        weight = weight.float()
    if bias.dtype != weight.dtype:
        bias = bias.to(weight.dtype)
    y, _, _ = layer_norm_fwd(x.reshape(-1, shape[-1]).contiguous(),
                             weight.contiguous(), bias.contiguous(),
                             eps=eps, subtract_mean=subtract_mean)
    y = y.reshape(shape)
    return y.to(torch.float16) if was16 else y


def layer_norm(x, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5):
    """Fused LayerNorm over the last axis (``FusedLayerNorm``).
    ``weight``/``bias`` default to the identity affine. Statistics are
    fp32 whatever the I/O dtype; the params may be fp32 with half inputs
    (``MixedFusedLayerNorm``)."""
    hidden = x.shape[-1]
    if weight is None:
        weight = torch.ones(hidden, dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(hidden, dtype=weight.dtype, device=x.device)
    return _norm(x, weight, bias, float(eps), True)


def rms_norm(x, weight: Optional[torch.Tensor] = None, *,
             eps: float = 1e-5):
    """Fused RMSNorm over the last axis (``FusedRMSNorm``)."""
    hidden = x.shape[-1]
    if weight is None:
        weight = torch.ones(hidden, dtype=torch.float32, device=x.device)
    bias = torch.zeros(hidden, dtype=weight.dtype, device=x.device)
    return _norm(x, weight, bias, float(eps), False)
