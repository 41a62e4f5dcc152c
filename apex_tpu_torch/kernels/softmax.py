"""Fused scaled, masked softmax, forward and backward (Megatron's
``scaled_masked_softmax`` and ``scaled_upper_triang_masked_softmax``).

Port of ``apex_tpu/kernels/softmax.py``: ``_run_fwd`` (kernel body
``_fwd_kernel``) and ``_run_bwd`` (``_bwd_kernel``), joined by the custom
VJP that is a ``torch.autograd.Function`` here. The forward saves its
output; the backward is ``dx = scale * y * (dy - sum(y * dy))``.

- :func:`softmax_fwd` ``(x3 [nb, sq, sk], mask3 [nb / h, sq, sk] or None)
  -> y3`` in x3's dtype: CUDA tensors launch ``csrc/softmax.cu``'s
  forward on the route :func:`fwd_route` picks (1: the row held in
  registers, 16-byte loads; 0: the general kernel), CPU tensors run
  :func:`softmax_fwd_plain`;
- :func:`softmax_bwd` ``(y3, dy3) -> dx3`` in y3's dtype: CUDA tensors
  launch the backward, CPU tensors run :func:`softmax_bwd_plain`.

Semantics, the JAX kernel's: ``softmax(scale * x)`` in fp32 over the last
dim; an entry is invalid where its mask is nonzero, or past the diagonal
when causal (square scores only). Invalid entries take part in the row's
max as -30000 and count 0 in the sum, which is clamped at 1e-30, so a
row with every entry masked gives zeros. A mask batch serves ``h = nb /
nb_mask`` consecutive score batches (JAX's ratio tiling: mask block
``i // h``). The kernels take fp32 or bf16 and compute in fp32; float16
is widened to fp32 around them and the result narrowed once, as the JAX
function's ``widen_f16`` does, so the saved ``y`` is fp32 and the
gradient is rounded to float16 once. The JAX kernel pads sk to 128 lanes
and sq to its row block; nothing here is padded.

Launch counts: ``softmax_fwd.launches`` and ``softmax_bwd.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.kernels import _build
from apex_tpu_torch.kernels.flat_ops import _widen

#: the JAX kernel's fill for invalid entries (``_NEG``)
_NEG = -30000.0


def _valid(nb: int, sq: int, sk: int, mask3, causal: bool, device):
    """The ``[nb | 1, sq, sk]`` bool of entries that take part, or None
    when every entry does."""
    valid = None
    if causal:
        col = torch.arange(sk, device=device)
        valid = (col[None, :] <= torch.arange(sq, device=device)[:, None])[None]
    if mask3 is not None:
        keep = (mask3 == 0).repeat_interleave(nb // mask3.shape[0], dim=0)
        valid = keep if valid is None else valid & keep
    return valid


def fwd_route(x3: torch.Tensor, y3: torch.Tensor,
              mask3: Optional[torch.Tensor] = None) -> int:
    """Which forward kernel ``softmax_fwd`` launches for these operands,
    by dtype, row length and pointer alignment alone (never by failure):
    1 for the row-in-registers kernel (``csrc/softmax.cu``,
    ``softmax_fwd_rows_kernel``) — fp32 or bf16, ``sk`` a multiple of the
    V = 16 / itemsize values a 16-byte vector holds and at most
    ``_build.SOFTMAX_ROWS_MAX_COLS``, x3 and y3 starting on a 16-byte
    boundary, the byte mask (when there is one) on a V-byte one; 0 for
    the general kernel (``softmax_fwd_kernel``), which takes every other
    shape. The C entry checks route 1's conditions again and refuses the
    launch when they fail."""
    if x3.dtype not in _build.DTYPE_CODES:
        return 0
    v = 16 // x3.element_size()
    sk = x3.shape[-1]
    return int(sk % v == 0 and sk <= _build.SOFTMAX_ROWS_MAX_COLS
               and x3.data_ptr() % 16 == 0 and y3.data_ptr() % 16 == 0
               and (mask3 is None or mask3.data_ptr() % v == 0))


def softmax_fwd_plain(x3: torch.Tensor, mask3: Optional[torch.Tensor],
                      scale: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel, in fp32, output in x3's
    dtype. No host sync, so a CUDA graph can capture it."""
    nb, sq, sk = x3.shape
    x = x3.float() * scale
    valid = _valid(nb, sq, sk, mask3, causal, x3.device)
    if valid is not None:
        x = torch.where(valid, x, _NEG)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (e / denom).to(x3.dtype)


def softmax_bwd_plain(y3: torch.Tensor, dy3: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: ``scale * y * (dy -
    sum(y * dy))`` in fp32, in y3's dtype."""
    y = y3.float()
    dy = dy3.float()
    inner = (y * dy).sum(dim=-1, keepdim=True)
    return (scale * y * (dy - inner)).to(y3.dtype)


def softmax_fwd(x3: torch.Tensor, mask3: Optional[torch.Tensor] = None, *,
                scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """``y3 [nb, sq, sk]`` in x3's dtype (fp32 or bf16 for the kernel):
    the scaled, masked softmax of ``x3`` over its last dim. ``mask3`` is
    ``[nb / h, sq, sk]`` (bool or int, nonzero = masked) or None;
    ``causal`` needs ``sq == sk``. CUDA tensors launch the kernel that
    :func:`fwd_route` picks (counted in ``softmax_fwd.launches``); CPU
    tensors run the plain version."""
    if x3.ndim != 3:
        raise ValueError(f"softmax_fwd: x3 must be [nb, sq, sk], got "
                         f"{tuple(x3.shape)}")
    nb, sq, sk = x3.shape
    if causal and sq != sk:
        raise ValueError(
            f"causal softmax requires square scores, got {sq}x{sk}")
    if mask3 is not None and (mask3.ndim != 3 or tuple(mask3.shape[1:])
                              != (sq, sk) or mask3.shape[0] == 0
                              or nb % mask3.shape[0]):
        raise ValueError(f"softmax_fwd: mask {tuple(mask3.shape)} does not "
                         f"tile scores {tuple(x3.shape)}")
    tensors = (x3,) if mask3 is None else (x3, mask3)
    if not _build.on_cuda(*tensors):
        return softmax_fwd_plain(x3, mask3, scale, causal)
    code = _build.dtype_code(x3, "softmax_fwd scores")
    y3 = torch.empty_like(x3, memory_format=torch.contiguous_format)
    if x3.numel() == 0:
        return y3
    _build.require(x3, "x3", (nb, sq, sk), x3.dtype, align=1)
    m = None
    if mask3 is not None:
        m = (mask3 != 0).contiguous()      # one byte an entry, 0 or 1
    rc = _build.library().apex_tpu_torch_softmax_fwd(
        x3.data_ptr(), None if m is None else m.data_ptr(), y3.data_ptr(),
        nb * sq, sq, sk, 1 if m is None else nb // m.shape[0], float(scale),
        int(causal), code, fwd_route(x3, y3, m), _build.stream())
    _build.check(rc, "softmax_fwd")
    softmax_fwd.launches += 1
    return y3


softmax_fwd.launches = 0


def softmax_bwd(y3: torch.Tensor, dy3: torch.Tensor, *,
                scale: float = 1.0) -> torch.Tensor:
    """``dx3`` in y3's dtype from the forward's output ``y3 [nb, sq, sk]``
    and the gradient ``dy3`` (taken in y3's dtype). CUDA tensors launch
    the kernel (counted in ``softmax_bwd.launches``); CPU tensors run the
    plain version."""
    if y3.ndim != 3 or dy3.shape != y3.shape:
        raise ValueError(f"softmax_bwd: y3 {tuple(y3.shape)} and dy3 "
                         f"{tuple(dy3.shape)} must be one [nb, sq, sk]")
    if not _build.on_cuda(y3, dy3):
        return softmax_bwd_plain(y3, dy3, scale)
    code = _build.dtype_code(y3, "softmax_bwd probabilities")
    dy3 = dy3.to(y3.dtype).contiguous()
    dx3 = torch.empty_like(y3, memory_format=torch.contiguous_format)
    if y3.numel() == 0:
        return dx3
    nb, sq, sk = y3.shape
    _build.require(y3, "y3", (nb, sq, sk), y3.dtype, align=1)
    rc = _build.library().apex_tpu_torch_softmax_bwd(
        y3.data_ptr(), dy3.data_ptr(), dx3.data_ptr(), nb * sq, sk,
        float(scale), code, _build.stream())
    _build.check(rc, "softmax_bwd")
    softmax_bwd.launches += 1
    return dx3


softmax_bwd.launches = 0


class _Softmax(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves its output, the backward
    is the backward kernel; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x3, mask3, scale: float, causal: bool):
        y3 = softmax_fwd(x3, mask3, scale=scale, causal=causal)
        ctx.save_for_backward(y3)
        ctx.scale = scale
        return y3

    @staticmethod
    def backward(ctx, dy3):
        (y3,) = ctx.saved_tensors
        return softmax_bwd(y3, dy3, scale=ctx.scale), None, None, None


def _mask3(mask, x: torch.Tensor) -> torch.Tensor:
    """The JAX function's mask rule: a legacy ``[b, sq, sk]`` mask over
    ``[b, h, sq, sk]`` scores gets a head axis; leading axes are added;
    sq, sk and any interior broadcast axis are materialised, trailing
    size-1 leading axes (the heads) are not, so the kernel tiles them."""
    shape = tuple(x.shape)
    sq, sk = shape[-2:]
    m = torch.as_tensor(mask, device=x.device)
    if m.ndim > x.ndim:
        raise ValueError(f"mask rank {m.ndim} exceeds scores rank {x.ndim}")
    if m.ndim == x.ndim - 1 and x.ndim >= 4 and m.shape[0] == shape[0]:
        m = m[:, None]
    while m.ndim < x.ndim:
        m = m[None]
    lead = tuple(m.shape[:-2])
    cut = len(lead)
    while cut > 0 and lead[cut - 1] == 1:
        cut -= 1
    tgt = shape[:cut] + (1,) * (len(lead) - cut) + (sq, sk)
    try:
        return torch.broadcast_to(m, tgt).reshape(-1, sq, sk)
    except RuntimeError as e:
        raise ValueError(f"mask {tuple(m.shape)} does not broadcast to "
                         f"scores {shape}") from e


def scaled_masked_softmax(x: torch.Tensor, mask=None, *, scale: float = 1.0,
                          causal: bool = False) -> torch.Tensor:
    """``softmax(scale * x + mask)`` — ``ScaledMaskedSoftmax``.

    ``x``: ``[b, h, sq, sk]`` (or any ``[..., sq, sk]``); ``mask``: bool
    or 0/1, nonzero = masked out, any shape broadcastable to ``x`` over
    the leading, head and query dims (``[b, 1, sq, sk]``, ``[b, 1, 1,
    sk]`` padding masks, the legacy ``[b, sq, sk]``, ...). Softmax in fp32
    whatever the I/O dtype. ``causal=True`` also applies the
    upper-triangular mask inside the kernel (square scores only).
    Differentiable in ``x``."""
    shape = x.shape
    sq, sk = shape[-2], shape[-1]
    if causal and sq != sk:
        raise ValueError(
            f"causal softmax requires square scores, got {sq}x{sk}")
    was16 = x.dtype == torch.float16
    xw = _widen(x)
    m3 = None if mask is None else _mask3(mask, xw)
    y = _Softmax.apply(xw.reshape(-1, sq, sk).contiguous(), m3,
                       float(scale), bool(causal)).reshape(shape)
    return y.to(torch.float16) if was16 else y


def scaled_upper_triang_masked_softmax(x: torch.Tensor, *,
                                       scale: float = 1.0) -> torch.Tensor:
    """Causal ``softmax(scale * x)`` over the last two dims —
    ``ScaledUpperTriangMaskedSoftmax``. Requires ``sq == sk``."""
    shape = x.shape
    sq, sk = shape[-2], shape[-1]
    if sq != sk:
        raise ValueError(
            f"causal softmax requires square scores, got {sq}x{sk}")
    was16 = x.dtype == torch.float16
    xw = _widen(x)
    y = _Softmax.apply(xw.reshape(-1, sq, sk).contiguous(), None,
                       float(scale), True).reshape(shape)
    return y.to(torch.float16) if was16 else y


#: ``generic_scaled_masked_softmax_cuda`` — the reference's third variant
#: lifts its sequence-length and mask-broadcast limits; this kernel never
#: had them, so the generic name is the same op
generic_scaled_masked_softmax = scaled_masked_softmax

__all__ = ["fwd_route", "generic_scaled_masked_softmax",
           "scaled_masked_softmax", "scaled_upper_triang_masked_softmax",
           "softmax_bwd", "softmax_bwd_plain", "softmax_fwd",
           "softmax_fwd_plain"]
