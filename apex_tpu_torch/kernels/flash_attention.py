"""Flash attention, forward and backward, as differentiable custom ops:
over the model layout ``[batch, seq, hidden]`` (the lane-packed kernels)
and over the head-major layout ``[batch, heads, seq, head_dim]`` (the
second half of this module: :func:`flash_attention`,
:func:`flash_attention_with_lse`, :func:`mha`).

Port of ``apex_tpu/kernels/flash_attention.py:flash_attention_bsh`` and
its custom VJP (``_flash_bsh_fwd`` / ``_flash_bsh_bwd``). The JAX package
packs ``128 // head_dim`` heads into one 128-lane group and keeps lse as
``[b * n_grp, g, s]``; here one CUDA block owns one (batch, head, tile)
and lse is ``[b, heads, s]`` — the same values, reshaped.

Two ops of the ``apex_tpu_torch`` library, joined by
``register_autograd``:

- ``apex_tpu_torch::flash_attention_bsh_fwd(q, k, v, num_heads, causal,
  scale) -> (out, lse)`` — CUDA tensors launch the tensor-core kernel of
  ``csrc/flash_fwd_tc.cu`` (bf16 and fp16) or
  ``csrc/flash_attention_bsh.cu`` (fp32), by :func:`tc_route`; CPU tensors run
  :func:`flash_attention_bsh_plain`;
- ``apex_tpu_torch::flash_attention_bsh_bwd(q, k, v, do, lse, delta,
  num_heads, causal, scale) -> (dq, dk, dv)`` — CUDA tensors launch the
  tensor-core kernel of ``csrc/flash_bwd_tc.cu`` (bf16 and fp16) or
  ``csrc/flash_attention_bsh_bwd.cu`` (fp32), by the same rule; CPU
  tensors run :func:`flash_attention_bsh_bwd_plain`.

The autograd backward computes ``delta = sum_d(out * do)`` per head (the
JAX ``_flash_bsh_bwd``) and calls the backward op; lse carries no
gradient. Being ops, the forward is visible to selective activation
checkpointing, which is how ``remat_policy="qkv_fc1_attn"`` keeps the
backward from re-running the forward kernel (``models/gpt.py``).

Python wrappers: :func:`flash_attention_bsh_fwd` (``(out, lse)``),
:func:`flash_attention_bsh` (``out``, the JAX function's signature) and
:func:`flash_attention_bsh_bwd` (``(dq, dk, dv)``). float16 reaches the
tensor-core kernels as it is wherever :func:`tc_route` sends it there
(a head width in multiples of 8 up to 128, so every lane-packed call):
they round P and dS to fp16 as they round them to bf16 for bf16 inputs,
and the plain twins round the same way. JAX widens float16 to fp32 at
its kernels' boundary instead (``widen_f16``,
``apex_tpu/kernels/flash_attention.py:1167-1178``), so its P and dS stay
fp32: a difference by design. Where :func:`tc_route` says no, the
wrappers widen float16 to fp32 and cast the results back, as JAX does,
and the fp32 CUDA-core kernels run it. The same rule, with the same
rounding, holds for the head-major backwards, fused and split (the dQ
and dK/dV sweeps of ``csrc/flash_bwd_dq_tc.cu`` and
``csrc/flash_bwd_tc.cu``). Each kernel's launch count is kept on its
wrapper (``flash_attention_bsh_fwd.launches``,
``flash_attention_bsh_bwd.launches``, ...); the forwards and the
backwards also count their tensor-core launches apart
(``flash_attention_bsh_fwd.tc_launches``, ``flash_attention_fwd.
tc_launches``, ``flash_attention_bsh_bwd.tc_launches``,
``flash_attention_bwd.tc_launches``, ``flash_attention_bwd_dq.
tc_launches``, ``flash_attention_bwd_dkdv.tc_launches``), inside the
total.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from apex_tpu_torch.kernels import _build

_NEG = -1e30


def _geometry(q, k, v, num_heads: int, causal: bool):
    if q.ndim != 3:
        raise ValueError(f"expected [b, s, hidden], got {tuple(q.shape)}")
    b, sq, hidden = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, hidden) or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} inconsistent "
            f"with q {tuple(q.shape)}")
    if causal and sq != sk:
        raise ValueError("causal attention requires sq == sk")
    if hidden % num_heads:
        raise ValueError(
            f"hidden={hidden} not divisible by num_heads={num_heads}")
    return b, sq, sk, hidden, hidden // num_heads


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale) if scale is not None else 1.0 / d ** 0.5


def _widen_f16(t: torch.Tensor) -> torch.Tensor:
    """float16 → fp32 (the CUDA-core kernels have no float16
    instantiation, as Mosaic has no f16); anything else as it is."""
    return t.float() if t.dtype == torch.float16 else t


def _kernel_inputs(head_dim: int, *tensors) -> tuple:
    """The operands as a forward or backward op takes them: as they
    are where :func:`tc_route` says yes (bf16 or float16 on the tensor
    cores), else with float16 widened to fp32 (the CUDA-core kernels'
    fp32 instantiation; JAX's ``widen_f16``). A rule of dtype and width
    alone, on either device, so the plain twins on the CPU compute what
    the card does."""
    if tc_route(head_dim, *tensors):
        return tensors
    return tuple(_widen_f16(t) for t in tensors)


def tc_route(head_dim: int, *tensors) -> bool:
    """Which kernel a forward or backward op launches for CUDA tensors, by
    dtype and head width alone (never by failure): True for the
    tensor-core kernels of ``csrc/flash_fwd_tc.cu``,
    ``csrc/flash_bwd_tc.cu`` (fused, and the split dK/dV sweep) and
    ``csrc/flash_bwd_dq_tc.cu`` (the split dQ sweep) — every operand (q,
    k, v; and do) of one
    16-bit dtype, bf16 or fp16 (mixed bf16/fp16 is False), a head width
    that is a multiple of 8 and at most 128; False for the CUDA-core
    kernels (``csrc/flash_attention_bsh.cu``, ``csrc/flash_attention.cu``,
    ``csrc/flash_attention_bsh_bwd.cu``, ``csrc/flash_attention_bwd.cu``):
    fp32, other widths (where the wrappers widen fp16 to fp32 first,
    :func:`_kernel_inputs`). fp32 stays off the tensor cores because their
    fp32 path is TF32, 10 bits of mantissa: it would change what JAX's
    fp32 kernels compute, and a 3xTF32 or split-bf16 product that keeps
    fp32's accuracy is a design of its own. An operand off a 16-byte
    boundary is the op's to copy (:func:`_aligned16`)."""
    dtype = tensors[0].dtype
    return (dtype in _build.TC_DTYPE_CODES
            and all(t.dtype == dtype for t in tensors)
            and head_dim % 8 == 0 and 0 < head_dim <= _build.HM_MAX_HEAD_DIM)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on a 16-byte boundary (the
    tensor-core kernels' 16-byte copies), else one copy of it, which
    does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _round_io(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 P (or dS) as the products downstream take it: rounded to the
    inputs' 16-bit dtype, as the tensor-core kernels pack them into bf16
    or fp16 fragments and as JAX rounds them for bf16 (``p.astype(v.dtype)``
    in ``_online_update`` :90; ``_p_ds`` :188-189; JAX widens fp16 to fp32
    first, so there P and dS stay fp32: a difference by design). An fp16
    dS past 65504 becomes inf here as in the kernel. fp32 stays as it
    is."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).float()


def _heads(t, num_heads: int):
    """``[b, s, hidden]`` → fp32 ``[b, heads, s, d]``."""
    b, s, hidden = t.shape
    return t.float().reshape(b, s, num_heads, hidden // num_heads
                             ).transpose(1, 2)


def _merge(t, dtype):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _valid(sq: int, sk: int, causal: bool, device):
    """The ``_valid_cols`` mask ``[sq, sk]``: ``col < sk`` and, causal,
    ``col <= row``."""
    col = torch.arange(sk, device=device)
    valid = (col < sk)[None, :].expand(sq, sk)
    if causal:
        valid = valid & (col[None, :] <= torch.arange(
            sq, device=device)[:, None])
    return valid


def flash_attention_bsh_plain(q, k, v, *, num_heads: int,
                              causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the forward kernels: ``(out [b, sq, hidden]
    in q's dtype, lse fp32 [b, heads, sq])``, all arithmetic in fp32 —
    scores times ``scale``, the masks of ``_valid_cols`` with the finite
    ``-1e30`` fill, fp32 softmax statistics, ``l`` summed from fp32 p and
    p rounded to the inputs' 16-bit dtype before ``P V``
    (:func:`_round_io`)."""
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    s_ = _scale(scale, d)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * s_        # [b, H, sq, sk]
    valid = _valid(sq, sk, causal, q.device)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(_round_io(p, q.dtype), vh) / lsum
    lse = (m + torch.log(lsum))[..., 0]
    return _merge(out, q.dtype), lse.contiguous()


def flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta, *,
                                  num_heads: int, causal: bool = False,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the backward kernels, the ``_p_ds`` block
    math written out over whole rows: ``P = exp(S * scale - lse)`` under
    the valid mask, ``dS = P * (dP - delta) * scale``, both in fp32 and
    then, for bf16 and fp16 inputs, rounded to that dtype as the
    tensor-core kernel rounds them (:func:`_round_io`), then ``dV = P^T
    dO``, ``dK = dS^T Q``, ``dQ = dS K`` summed in fp32, results in q's
    dtype. ``lse`` and ``delta`` are fp32 ``[b, heads, sq]``."""
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    s_ = _scale(scale, d)
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (q, k, v, do))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * s_
    valid = _valid(sq, sk, causal, q.device)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = _round_io(p * (dp - delta.float()[..., None]) * s_, q.dtype)
    p = _round_io(p, q.dtype)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dq = torch.matmul(ds, kh)
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@torch.library.custom_op("apex_tpu_torch::flash_attention_bsh_fwd",
                         mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            num_heads: int, causal: bool, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    if not _build.on_cuda(q, k, v):
        return flash_attention_bsh_plain(q, k, v, num_heads=num_heads,
                                         causal=causal, scale=scale)
    if d != _build.KERNEL_HEAD_DIM:
        raise ValueError(
            f"flash_attention_bsh kernel: head_dim {d} != "
            f"{_build.KERNEL_HEAD_DIM}")
    tc = tc_route(d, q, k, v)
    code = (_build.tc_dtype_code if tc else _build.dtype_code)(
        q, "flash_attention_bsh q")
    _build.require(q, "q", (b, sq, hidden), q.dtype)
    _build.require(k, "k", (b, sk, hidden), q.dtype)
    _build.require(v, "v", (b, sk, hidden), q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, hidden, num_heads, scale, int(causal),
            code, _build.stream())
    if tc:
        rc = _build.library().apex_tpu_torch_flash_fwd_bsh_tc(*args)
        _build.check(rc, "flash_attention_bsh (tensor cores)")
        flash_attention_bsh_fwd.tc_launches += 1
    else:
        rc = _build.library().apex_tpu_torch_flash_fwd_bsh(*args)
        _build.check(rc, "flash_attention_bsh")
    flash_attention_bsh_fwd.launches += 1
    return out, lse


@_fwd_op.register_fake
def _fwd_fake(q, k, v, num_heads, causal, scale):
    b, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, num_heads, sq),
                                            dtype=torch.float32)


@torch.library.custom_op("apex_tpu_torch::flash_attention_bsh_bwd",
                         mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            num_heads: int, causal: bool, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    if not _build.on_cuda(q, k, v, do, lse, delta):
        return flash_attention_bsh_bwd_plain(
            q, k, v, do, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    if d != _build.KERNEL_HEAD_DIM:
        raise ValueError(
            f"flash_attention_bsh_bwd kernel: head_dim {d} != "
            f"{_build.KERNEL_HEAD_DIM}")
    tc = tc_route(d, q, k, v, do)
    code = (_build.tc_dtype_code if tc else _build.dtype_code)(
        q, "flash_attention_bsh_bwd q")
    for name, t, rows in (("q", q, sq), ("k", k, sk), ("v", v, sk),
                          ("do", do, sq)):
        _build.require(t, name, (b, rows, hidden), q.dtype)
    for name, t in (("lse", lse), ("delta", delta)):
        _build.require(t, name, (b, num_heads, sq), torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    geom = (b, sq, sk, hidden, num_heads, scale, int(causal), code,
            _build.stream())
    if tc:
        # dq is summed with fp32 atomics, then rounded to q's dtype once
        dq32 = torch.empty((b, sq, hidden), dtype=torch.float32,
                           device=q.device)
        rc = _build.library().apex_tpu_torch_flash_bwd_bsh_tc(
            *args, dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(), *geom)
        _build.check(rc, "flash_attention_bsh_bwd (tensor cores)")
        dq = dq32.to(q.dtype)
        flash_attention_bsh_bwd.tc_launches += 1
    else:
        dq = torch.empty_like(q)
        rc = _build.library().apex_tpu_torch_flash_bwd_bsh(
            *args, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *geom)
        _build.check(rc, "flash_attention_bsh_bwd")
    flash_attention_bsh_bwd.launches += 1
    return dq, dk, dv


@_bwd_op.register_fake
def _bwd_fake(q, k, v, do, lse, delta, num_heads, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, num_heads, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.num_heads, ctx.causal, ctx.scale = num_heads, causal, scale


def _backward(ctx, dout, _dlse):
    """The JAX ``_flash_bsh_bwd``: per-head ``delta = sum_d(out * do)``
    in fp32, then the backward op. lse carries no gradient."""
    q, k, v, out, lse = ctx.saved_tensors
    b, sq, hidden = q.shape
    dout = dout.contiguous()
    delta = (out.float() * dout.float()).reshape(
        b, sq, ctx.num_heads, hidden // ctx.num_heads).sum(-1)
    delta = delta.transpose(1, 2).contiguous()               # [b, H, sq]
    dq, dk, dv = _bwd_op(q, k, v, dout, lse, delta, ctx.num_heads,
                         ctx.causal, ctx.scale)
    return dq, dk, dv, None, None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)

#: the forward op itself, as selective checkpointing policies see it
FLASH_FWD_OP = torch.ops.apex_tpu_torch.flash_attention_bsh_fwd.default


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def flash_attention_bsh_fwd(q, k, v, *, num_heads: int,
                            causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [b, sq, hidden], lse fp32 [b, heads, sq])``, differentiable
    in q, k and v. CUDA tensors launch the kernel on the current stream
    (counted in ``flash_attention_bsh_fwd.launches``, the tensor-core
    ones also in ``.tc_launches``); CPU tensors run the plain version. The
    kernels take contiguous, 16-byte aligned q/k/v of one dtype with
    head_dim 64, bf16 or fp16 (the tensor-core kernel) or fp32, and raise
    on anything else. float16 runs the tensor-core kernel as it is (P
    rounded to fp16; JAX widens it to fp32), except where
    :func:`tc_route` says no (:func:`_kernel_inputs`)."""
    _, _, _, _, d = _geometry(q, k, v, num_heads, causal)
    _build.on_cuda(q, k, v)       # refuse other and mixed devices here
    dtype = q.dtype
    out, lse = _fwd_op(*_kernel_inputs(d, q, k, v), num_heads, bool(causal),
                       _scale(scale, d))
    return out.to(dtype), lse


flash_attention_bsh_fwd.launches = 0
flash_attention_bsh_fwd.tc_launches = 0


def flash_attention_bsh(q, k, v, *, num_heads: int, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``[batch, seq, hidden]`` inputs with heads laid out
    contiguously along ``hidden`` — the JAX function. Returns the output,
    same shape and dtype as ``q``; differentiable. Shapes the lane-packed
    kernels do not take (:func:`flash_bsh_eligible`: a head width other
    than 64, ``APEX_TPU_FLASH_BWD=split``, a dQ accumulator over budget)
    run the head-major kernels instead, as JAX's function does."""
    b, sq, _, hidden, d = _geometry(q, k, v, num_heads, causal)
    if not flash_bsh_eligible(hidden, num_heads, sq):
        split = lambda t: t.reshape(b, t.shape[1], num_heads, d).transpose(
            1, 2)
        out = flash_attention(split(q), split(k), split(v), causal=causal,
                              scale=scale)
        return out.transpose(1, 2).reshape(b, sq, hidden)
    return flash_attention_bsh_fwd(q, k, v, num_heads=num_heads,
                                   causal=causal, scale=scale)[0]


def flash_attention_bsh_bwd(q, k, v, do, lse, delta, *, num_heads: int,
                            causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` from the forward's inputs, the output gradient
    ``do`` and the fp32 ``[b, heads, sq]`` statistics ``lse`` (from the
    forward) and ``delta`` (``sum_d(out * do)`` per head). CUDA tensors
    launch a kernel (counted in ``flash_attention_bsh_bwd.launches``):
    bf16 and fp16 the tensor-core one (also counted in ``.tc_launches``;
    P and dS rounded to the inputs' dtype; dq summed with atomics, so its
    last bits may change between launches), fp32 the CUDA-core one; CPU
    tensors run the plain version. float16 is widened to fp32 only where
    :func:`tc_route` says no, as in the forward, and each gradient comes
    back in its input's dtype."""
    _, _, _, _, d = _geometry(q, k, v, num_heads, causal)
    _build.on_cuda(q, k, v, do, lse, delta)
    dtypes = [t.dtype for t in (q, k, v)]
    grads = _bwd_op(*_kernel_inputs(d, q, k, v, do), lse, delta, num_heads,
                    bool(causal), _scale(scale, d))
    return tuple(g.to(dt) for g, dt in zip(grads, dtypes))


flash_attention_bsh_bwd.launches = 0
flash_attention_bsh_bwd.tc_launches = 0


# ---------------------------------------------------------------------------
# head-major [b, heads, s, head_dim]: flash_attention, flash_attention_with_lse
# ---------------------------------------------------------------------------
#
# Port of the JAX module's head-major API (``flash_attention`` :732,
# ``flash_attention_with_lse`` :694, ``mha`` :781) over ``_run_fwd`` /
# ``_run_bwd``. The kernels see ``q [b * heads, sq, d]``, ``k, v [b *
# heads, sk, d]``, any ``d <= 128``, optional per-row kv lengths ``[b *
# heads]`` (JAX repeats ``kv_lengths`` per head) and segment ids ``[b,
# sq]`` / ``[b, sk]`` indexed by ``row // heads`` (JAX's ``n_rep``).
#
# Four ops of the ``apex_tpu_torch`` library:
#
# - ``flash_attention_fwd(q, k, v, lens, seg_q, seg_k, n_rep, causal,
#   scale, block_q) -> (out, lse)`` — ``csrc/flash_fwd_tc.cu`` (bf16 and
#   fp16, by :func:`tc_route`) or ``csrc/flash_attention.cu``, or
#   :func:`flash_attention_fwd_plain` on the CPU;
# - ``flash_attention_bwd`` (fused, ``(dq, dk, dv)``) —
#   ``csrc/flash_bwd_tc.cu`` (bf16 and fp16, by :func:`tc_route`) or
#   ``csrc/flash_attention_bwd.cu``; ``flash_attention_bwd_dq`` (``dq``) —
#   ``csrc/flash_bwd_dq_tc.cu`` or ``csrc/flash_attention_bwd.cu``, and
#   ``flash_attention_bwd_dkdv`` (``(dk, dv)``) — ``csrc/flash_bwd_tc.cu``
#   without its dQ share or ``csrc/flash_attention_bwd.cu``, by the same
#   rule (float16 widened to fp32 off the tensor cores, on either
#   device); or their plain twins on the CPU; gradients in fp32.
#
# The forward's autograd formula computes ``delta = sum_d(out * do)`` in
# fp32, less the lse cotangent (``_flash_with_lse_bwd`` :657: since
# d(lse)/ds_j = p_j, the dlse term folds into the same kernels), and runs
# the fused backward or the split pair by :func:`fused_backward`, JAX's
# rule over JAX's arithmetic (``_run_bwd`` :488-494). ``block_q`` and
# ``block_k`` are the JAX tile sizes: here ``block_q`` feeds only that
# rule and ``block_k`` nothing; the CUDA tiles are the kernels' own.

#: JAX's default tile sizes and its fused-backward dQ budget
#: (``flash_attention.py:57-64``): they decide the backward, not the tiles
_DEFAULT_BLOCK_Q = 512
_FUSED_DQ_BYTES = 4 * 1024 * 1024
_LANE = 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _fit_block(want: int, seq: int) -> int:
    """Largest tile <= ``want`` that doesn't pad ``seq`` by more than a
    quarter (JAX's ``_fit_block`` :338)."""
    b = min(want, _round_up(seq, 8))
    while b > 128 and _round_up(seq, b) - seq > seq // 4:
        b //= 2
    return b


def _bwd_mode() -> str:
    """``APEX_TPU_FLASH_BWD``: ``auto`` (the default), ``fused`` or
    ``split``; anything else raises, as in JAX."""
    mode = os.environ.get("APEX_TPU_FLASH_BWD", "auto")
    if mode not in ("auto", "fused", "split"):
        raise ValueError(
            f"APEX_TPU_FLASH_BWD={mode!r}: expected auto, fused or split")
    return mode


def fused_backward(sq: int, d: int, block_q: Optional[int] = None) -> bool:
    """True when the head-major backward runs the fused single sweep, False
    for the split dQ and dK/dV sweeps: JAX's ``_run_bwd`` rule — fused
    under ``APEX_TPU_FLASH_BWD=fused``, split under ``split``, and under
    ``auto`` fused while the padded fp32 dQ accumulator ``round_up(sq,
    bq) x round_up(d, 128)`` fits 4 MiB, ``bq = _fit_block(block_q or
    512, sq)``."""
    mode = _bwd_mode()
    if mode != "auto":
        return mode == "fused"
    bq = _fit_block(block_q or _DEFAULT_BLOCK_Q, sq)
    return _round_up(sq, bq) * _round_up(d, _LANE) * 4 <= _FUSED_DQ_BYTES


def _group_geometry(hidden: int, num_heads: int):
    """(head_dim, heads_per_group, n_groups) of the JAX lane packing, or
    None when the packing cannot express it (``_group_geometry`` :807)."""
    if hidden % num_heads:
        return None
    d = hidden // num_heads
    if d > _LANE or _LANE % d or hidden % _LANE:
        return None
    return d, _LANE // d, hidden // _LANE


def flash_bsh_eligible(hidden: int, num_heads: int, seq: int,
                       block_q: Optional[int] = None) -> bool:
    """True when a model runs the lane-packed ``[b, s, hidden]`` kernels
    for this shape: JAX's ``flash_bsh_eligible`` (:826) — the lane-group
    geometry, ``APEX_TPU_FLASH_BWD`` not ``split``, the fused dQ budget —
    and one condition of the port's own: its lane-packed kernels are built
    for one head width (``_build.KERNEL_HEAD_DIM``, 64). Where JAX would
    pack another width (32, 128, ...), the port runs the head-major
    kernels instead."""
    geom = _group_geometry(hidden, num_heads)
    if geom is None or geom[0] != _build.KERNEL_HEAD_DIM:
        return False
    if _bwd_mode() == "split":
        return False
    bq = _fit_block(block_q or _DEFAULT_BLOCK_Q, seq)
    return _round_up(seq, bq) * _LANE * 4 <= _FUSED_DQ_BYTES


def _seg_pair(segment_ids, kv_segment_ids, b: int, sq: int, sk: int,
              device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The public segment-id arguments as an int32 ``([b, sq], [b, sk])``
    pair on ``device`` (or None): either one stands for both, as in JAX's
    ``_seg_pair`` (:676)."""
    if segment_ids is None and kv_segment_ids is None:
        return None
    as_i32 = lambda x: torch.as_tensor(x, device=device).to(torch.int32)
    seg_q = as_i32(segment_ids if segment_ids is not None
                   else kv_segment_ids)
    seg_k = as_i32(kv_segment_ids if kv_segment_ids is not None
                   else segment_ids)
    if tuple(seg_q.shape) != (b, sq) or tuple(seg_k.shape) != (b, sk):
        raise ValueError(
            f"segment_ids {tuple(seg_q.shape)} / kv_segment_ids "
            f"{tuple(seg_k.shape)} must be [batch, seq] = ({b}, {sq}) / "
            f"({b}, {sk})")
    return seg_q.contiguous(), seg_k.contiguous()


def _hm_geometry(q, k, v, causal: bool):
    if q.ndim != 3:
        raise ValueError(f"expected [b * heads, s, d], got {tuple(q.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} inconsistent "
            f"with q {tuple(q.shape)}")
    if causal and sq != sk:
        raise ValueError("causal attention requires sq == sk")
    return bh, sq, sk, d


def _hm_valid(bh: int, sq: int, sk: int, causal: bool, lens, seg_q, seg_k,
              n_rep: int, device) -> torch.Tensor:
    """The ``_valid_cols`` mask ``[bh or 1, sq, sk]``: ``col < sk``, ``col
    < kv_length`` of the row, equal segment ids (``row // n_rep`` picks the
    batch row of the ids) and, causal, ``col <= row``. Builds on the device
    without a host sync (CUDA-graph safe)."""
    col = torch.arange(sk, device=device)
    valid = torch.ones((1, sq, sk), dtype=torch.bool, device=device)
    if lens is not None:
        valid = valid & (col[None, None, :] < lens.to(device)[:, None, None])
    if seg_q is not None:
        rows = torch.arange(bh, device=device) // n_rep
        sq_ids, sk_ids = seg_q[rows], seg_k[rows]
        valid = valid & (sq_ids[:, :, None] == sk_ids[:, None, :])
    if causal:
        valid = valid & (col[None, None, :] <= torch.arange(
            sq, device=device)[None, :, None])
    return valid


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None, lens=None,
                              segs=None, n_rep: int = 1
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the head-major forward kernels over ``[bh, s,
    d]``: ``(out in q's dtype, lse fp32 [bh, sq])``, all arithmetic in
    fp32 — scores times ``scale``, the ``_valid_cols`` mask with the
    finite ``-1e30`` fill, masked probabilities 0, ``l`` summed from fp32
    p and p rounded to the inputs' 16-bit dtype before ``P V``
    (:func:`_round_io`), ``out = acc / max(l, 1e-30)`` and ``lse = m +
    log(max(l, 1e-30))``, so a row with every column masked gives ``out =
    0`` and ``lse = -1e30 + log(1e-30)`` (``_fwd_kernel``'s
    ``_finish``)."""
    bh, sq, sk, d = _hm_geometry(q, k, v, causal)
    s_ = _scale(scale, d)
    seg_q, seg_k = segs if segs is not None else (None, None)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s_
    valid = _hm_valid(bh, sq, sk, causal, lens, seg_q, seg_k, n_rep,
                      q.device)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(_round_io(p, q.dtype), v.float()) / lsum
    lse = (m + torch.log(lsum))[..., 0]
    return out.to(q.dtype), lse.contiguous()


def _p_ds_plain(q, k, v, do, lse, delta, *, causal, scale, lens, segs,
                n_rep):
    """The ``_p_ds`` block math over whole rows, in fp32: ``P = exp(S *
    scale - lse)`` under the mask, ``dS = P * (dP - delta) * scale``, both
    then rounded to the inputs' 16-bit dtype (:func:`_round_io`), as the
    tensor-core backwards (fused and split) round them. The CUDA-core
    kernels keep P and dS in fp32: the twin of those is this one on the
    inputs widened to fp32."""
    bh, sq, sk, d = _hm_geometry(q, k, v, causal)
    s_ = _scale(scale, d)
    seg_q, seg_k = segs if segs is not None else (None, None)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s_
    valid = _hm_valid(bh, sq, sk, causal, lens, seg_q, seg_k, n_rep,
                      q.device)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None]) * s_
    return _round_io(p, q.dtype), _round_io(ds, q.dtype)


def flash_attention_bwd_plain(q, k, v, do, lse, delta, *,
                              causal: bool = False,
                              scale: Optional[float] = None, lens=None,
                              segs=None, n_rep: int = 1
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of the fused backward kernel: ``(dq, dk, dv)`` in fp32
    from the ``[bh, s, d]`` inputs, the output gradient ``do`` and the
    fp32 ``[bh, sq]`` ``lse`` and ``delta`` — ``dV = P^T dO``, ``dK = dS^T
    Q``, ``dQ = dS K``."""
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, causal=causal, scale=scale,
                        lens=lens, segs=segs, n_rep=n_rep)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return torch.matmul(ds, k.float()), dk, dv


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = False,
                                 scale: Optional[float] = None, lens=None,
                                 segs=None, n_rep: int = 1) -> torch.Tensor:
    """Plain twin of the split dQ kernel: fp32 ``dQ = dS K``."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, causal=causal, scale=scale,
                        lens=lens, segs=segs, n_rep=n_rep)
    return torch.matmul(ds, k.float())


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, *,
                                   causal: bool = False,
                                   scale: Optional[float] = None, lens=None,
                                   segs=None, n_rep: int = 1
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the split dK/dV kernel: fp32 ``(dK = dS^T Q, dV =
    P^T dO)``."""
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, causal=causal, scale=scale,
                        lens=lens, segs=segs, n_rep=n_rep)
    return (torch.matmul(ds.transpose(-1, -2), q.float()),
            torch.matmul(p.transpose(-1, -2), do.float()))


def _hm_check_kernel(q, name: str, tc: bool = False) -> int:
    """The dtype code of the head-major kernels' inputs, for the
    tensor-core kernel if ``tc``; raises for a head width they do not
    take."""
    d = q.shape[-1]
    if d > _build.HM_MAX_HEAD_DIM:
        raise ValueError(
            f"{name} kernel: head_dim {d} > {_build.HM_MAX_HEAD_DIM} (wider "
            f"heads are not ported yet)")
    return (_build.tc_dtype_code if tc else _build.dtype_code)(q, f"{name} q")


def _present(*tensors):
    return [t for t in tensors if t is not None]


def _hm_aux(lens, seg_q, seg_k, bh: int, n_rep: int, sq: int, sk: int):
    """Check the int32 kv lengths and segment ids a kernel reads and
    return their pointers (None for an absent operand)."""
    b = bh // n_rep
    ptrs = []
    for name, t, shape in (("lens", lens, (bh,)), ("seg_q", seg_q, (b, sq)),
                           ("seg_k", seg_k, (b, sk))):
        if t is None:
            ptrs.append(None)
            continue
        _build.require(t, name, shape, torch.int32, align=4)
        ptrs.append(t.data_ptr())
    return ptrs


@torch.library.custom_op("apex_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def _hm_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lens: Optional[torch.Tensor], seg_q: Optional[torch.Tensor],
               seg_k: Optional[torch.Tensor], n_rep: int, causal: bool,
               scale: float, block_q: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    bh, sq, sk, d = _hm_geometry(q, k, v, causal)
    segs = None if seg_q is None else (seg_q, seg_k)
    if not _build.on_cuda(q, k, v, *_present(lens, seg_q, seg_k)):
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                         lens=lens, segs=segs, n_rep=n_rep)
    tc = tc_route(d, q, k, v)
    code = _hm_check_kernel(q, "flash_attention", tc)
    for name, t, rows in (("q", q, sq), ("k", k, sk), ("v", v, sk)):
        _build.require(t, name, (bh, rows, d), q.dtype, align=1)
    if tc:
        q, k, v = (_aligned16(t) for t in (q, k, v))
    aux = _hm_aux(lens, seg_q, seg_k, bh, n_rep, sq, sk)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *aux, out.data_ptr(),
            lse.data_ptr(), bh, n_rep, sq, sk, d, scale, int(causal), code,
            _build.stream())
    if tc:
        rc = _build.library().apex_tpu_torch_flash_fwd_hm_tc(*args)
        _build.check(rc, "flash_attention (tensor cores)")
        flash_attention_fwd.tc_launches += 1
    else:
        rc = _build.library().apex_tpu_torch_flash_fwd_hm(*args)
        _build.check(rc, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


@_hm_fwd_op.register_fake
def _hm_fwd_fake(q, k, v, lens, seg_q, seg_k, n_rep, causal, scale, block_q):
    return torch.empty_like(q), q.new_empty(q.shape[:2],
                                            dtype=torch.float32)


#: the head-major backward entries of each sweep: (CUDA cores, tensor
#: cores)
_HM_BWD_ENTRIES = {"fused": ("flash_bwd_hm_fused", "flash_bwd_hm_tc"),
                   "dq": ("flash_bwd_hm_dq", "flash_bwd_hm_dq_tc"),
                   "dkdv": ("flash_bwd_hm_dkdv", "flash_bwd_hm_dkdv_tc")}


def _hm_bwd_launch(sweep: str, q, k, v, do, lse, delta, lens, seg_q, seg_k,
                   n_rep: int, causal: bool, scale: float):
    """One launch of a head-major backward ``sweep`` ("fused", "dq" or
    "dkdv") on CUDA tensors: its tensor-core kernel where
    :func:`tc_route` says so (an operand off a 16-byte boundary copied
    once), else its CUDA-core one. Returns (fp32 ``(dq or None, dk or
    None, dv or None)``, whether the tensor cores ran). The fused entries
    zero dq before they sum into it."""
    bh, sq, sk, d = _hm_geometry(q, k, v, causal)
    tc = tc_route(d, q, k, v, do)
    if tc:
        q, k, v, do = (_aligned16(t) for t in (q, k, v, do))
    entry = _HM_BWD_ENTRIES[sweep][tc]
    code = _hm_check_kernel(q, entry, tc)
    for name, t, rows in (("q", q, sq), ("k", k, sk), ("v", v, sk),
                          ("do", do, sq)):
        _build.require(t, name, (bh, rows, d), q.dtype, align=1)
    for name, t in (("lse", lse), ("delta", delta)):
        _build.require(t, name, (bh, sq), torch.float32, align=4)
    aux = _hm_aux(lens, seg_q, seg_k, bh, n_rep, sq, sk)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((bh, sq, d), **f32) if sweep != "dkdv" else None
    dk = torch.empty((bh, sk, d), **f32) if sweep != "dq" else None
    dv = torch.empty((bh, sk, d), **f32) if sweep != "dq" else None
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = getattr(_build.library(), f"apex_tpu_torch_{entry}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *aux, ptr(dq), ptr(dk), ptr(dv),
        bh, n_rep, sq, sk, d, scale, int(causal), code, _build.stream())
    _build.check(rc, entry)
    return (dq, dk, dv), tc


@torch.library.custom_op("apex_tpu_torch::flash_attention_bwd",
                         mutates_args=())
def _hm_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               lens: Optional[torch.Tensor], seg_q: Optional[torch.Tensor],
               seg_k: Optional[torch.Tensor], n_rep: int, causal: bool,
               scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not _build.on_cuda(q, k, v, do, lse, delta,
                          *_present(lens, seg_q, seg_k)):
        return flash_attention_bwd_plain(
            q, k, v, do, lse, delta, causal=causal, scale=scale, lens=lens,
            segs=None if seg_q is None else (seg_q, seg_k), n_rep=n_rep)
    grads, tc = _hm_bwd_launch("fused", q, k, v, do, lse, delta, lens,
                               seg_q, seg_k, n_rep, causal, scale)
    flash_attention_bwd.tc_launches += int(tc)
    flash_attention_bwd.launches += 1
    return grads


@_hm_bwd_op.register_fake
def _hm_bwd_fake(q, k, v, do, lse, delta, lens, seg_q, seg_k, n_rep, causal,
                 scale):
    f32 = lambda t: torch.empty_like(t, dtype=torch.float32)
    return f32(q), f32(k), f32(v)


@torch.library.custom_op("apex_tpu_torch::flash_attention_bwd_dq",
                         mutates_args=())
def _hm_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  lens: Optional[torch.Tensor],
                  seg_q: Optional[torch.Tensor],
                  seg_k: Optional[torch.Tensor], n_rep: int, causal: bool,
                  scale: float) -> torch.Tensor:
    # float16 off the tensor cores is widened on either device, so the
    # twin computes what the kernel does
    q, k, v, do = _kernel_inputs(q.shape[-1], q, k, v, do)
    if not _build.on_cuda(q, k, v, do, lse, delta,
                          *_present(lens, seg_q, seg_k)):
        return flash_attention_bwd_dq_plain(
            q, k, v, do, lse, delta, causal=causal, scale=scale, lens=lens,
            segs=None if seg_q is None else (seg_q, seg_k), n_rep=n_rep)
    (dq, _, _), tc = _hm_bwd_launch("dq", q, k, v, do, lse, delta, lens,
                                    seg_q, seg_k, n_rep, causal, scale)
    flash_attention_bwd_dq.tc_launches += int(tc)
    flash_attention_bwd_dq.launches += 1
    return dq


@_hm_bwd_dq_op.register_fake
def _hm_bwd_dq_fake(q, k, v, do, lse, delta, lens, seg_q, seg_k, n_rep,
                    causal, scale):
    return torch.empty_like(q, dtype=torch.float32)


@torch.library.custom_op("apex_tpu_torch::flash_attention_bwd_dkdv",
                         mutates_args=())
def _hm_bwd_dkdv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    lens: Optional[torch.Tensor],
                    seg_q: Optional[torch.Tensor],
                    seg_k: Optional[torch.Tensor], n_rep: int, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    q, k, v, do = _kernel_inputs(q.shape[-1], q, k, v, do)    # as dq's
    if not _build.on_cuda(q, k, v, do, lse, delta,
                          *_present(lens, seg_q, seg_k)):
        return flash_attention_bwd_dkdv_plain(
            q, k, v, do, lse, delta, causal=causal, scale=scale, lens=lens,
            segs=None if seg_q is None else (seg_q, seg_k), n_rep=n_rep)
    (_, dk, dv), tc = _hm_bwd_launch("dkdv", q, k, v, do, lse, delta, lens,
                                     seg_q, seg_k, n_rep, causal, scale)
    flash_attention_bwd_dkdv.tc_launches += int(tc)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


@_hm_bwd_dkdv_op.register_fake
def _hm_bwd_dkdv_fake(q, k, v, do, lse, delta, lens, seg_q, seg_k, n_rep,
                      causal, scale):
    return (torch.empty_like(k, dtype=torch.float32),
            torch.empty_like(v, dtype=torch.float32))


def _hm_setup_context(ctx, inputs, output):
    q, k, v, lens, seg_q, seg_k, n_rep, causal, scale, block_q = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, lens, seg_q, seg_k)
    ctx.n_rep, ctx.causal, ctx.scale = n_rep, causal, scale
    ctx.block_q = block_q


def _hm_backward(ctx, dout, dlse):
    """JAX's ``_flash_with_lse_bwd``: ``delta = sum_d(out * do) - dlse``
    in fp32, then the fused backward or the split dQ and dK/dV pair
    (:func:`fused_backward`). Gradients come back in the inputs' dtypes."""
    q, k, v, out, lse, lens, seg_q, seg_k = ctx.saved_tensors
    if dout is None:
        dout = torch.zeros_like(out)
    dout = dout.contiguous()
    delta = (out.float() * dout.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    args = (q, k, v, dout, lse, delta.contiguous(), lens, seg_q, seg_k,
            ctx.n_rep, ctx.causal, ctx.scale)
    if fused_backward(q.shape[1], q.shape[2], ctx.block_q or None):
        dq, dk, dv = _hm_bwd_op(*args)
    else:
        dq = _hm_bwd_dq_op(*args)
        dk, dv = _hm_bwd_dkdv_op(*args)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None, None, None, None, None, None, None)


_hm_fwd_op.register_autograd(_hm_backward, setup_context=_hm_setup_context)

#: the head-major forward op, as selective checkpointing policies see it
FLASH_HM_FWD_OP = torch.ops.apex_tpu_torch.flash_attention_fwd.default


def _hm_aux_args(lens, segs):
    seg_q, seg_k = segs if segs is not None else (None, None)
    return lens, seg_q, seg_k


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, lens=None, segs=None,
                        n_rep: int = 1, block_q: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head-major forward over ``[bh, s, d]``: ``(out, lse fp32 [bh,
    sq])``, differentiable in q, k and v (and through lse). ``lens`` is an
    int32 ``[bh]`` of kv lengths, ``segs`` an int32 ``([bh // n_rep, sq],
    [bh // n_rep, sk])`` pair of segment ids. CUDA tensors launch a
    kernel (counted in ``flash_attention_fwd.launches``) on fp32, bf16 or
    fp16 inputs with ``d <= 128``: the tensor-core kernel where
    :func:`tc_route` says so (bf16 or fp16, also counted in
    ``.tc_launches``; an operand off a 16-byte boundary is copied once),
    else the CUDA-core one (fp32 and bf16; fp16 there raises, the public
    API widens it first); CPU tensors run the plain version."""
    _, _, _, d = _hm_geometry(q, k, v, causal)
    _build.on_cuda(q, k, v)       # refuse other and mixed devices here
    return _hm_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                      *_hm_aux_args(lens, segs), int(n_rep), bool(causal),
                      _scale(scale, d), int(block_q or 0))


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal: bool = False,
                        scale: Optional[float] = None, lens=None, segs=None,
                        n_rep: int = 1) -> Tuple[torch.Tensor, ...]:
    """The fused head-major backward: fp32 ``(dq, dk, dv)`` from the
    forward's ``[bh, s, d]`` inputs, ``do`` and the fp32 ``[bh, sq]``
    ``lse`` and ``delta`` (``sum_d(out * do)``, less any lse cotangent).
    CUDA tensors launch a kernel (counted in
    ``flash_attention_bwd.launches``): the tensor-core one where
    :func:`tc_route` says so (bf16 or fp16, also counted in
    ``.tc_launches``; an operand off a 16-byte boundary is copied once),
    else the CUDA-core one; dq is summed with atomics in both, so its last
    bits may change between launches."""
    _, _, _, d = _hm_geometry(q, k, v, causal)
    _build.on_cuda(q, k, v, do, lse, delta)
    return _hm_bwd_op(q, k, v, do, lse, delta, *_hm_aux_args(lens, segs),
                      int(n_rep), bool(causal), _scale(scale, d))


flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                           scale: Optional[float] = None, lens=None,
                           segs=None, n_rep: int = 1) -> torch.Tensor:
    """The split dQ sweep (arguments as :func:`flash_attention_bwd`): fp32
    dq, deterministic (no atomics: the same inputs give the same bits).
    CUDA tensors launch a kernel (counted in
    ``flash_attention_bwd_dq.launches``): the tensor-core one of
    ``csrc/flash_bwd_dq_tc.cu`` where :func:`tc_route` says so (bf16 or
    fp16, dS rounded to that dtype; also counted in ``.tc_launches``; an
    operand off a 16-byte boundary is copied once), else the CUDA-core
    one (float16 there widened to fp32, on either device)."""
    _, _, _, d = _hm_geometry(q, k, v, causal)
    _build.on_cuda(q, k, v, do, lse, delta)
    return _hm_bwd_dq_op(q, k, v, do, lse, delta, *_hm_aux_args(lens, segs),
                         int(n_rep), bool(causal), _scale(scale, d))


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *,
                             causal: bool = False,
                             scale: Optional[float] = None, lens=None,
                             segs=None, n_rep: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split dK/dV sweep (arguments as :func:`flash_attention_bwd`):
    fp32 ``(dk, dv)``, deterministic. CUDA tensors launch a kernel
    (counted in ``flash_attention_bwd_dkdv.launches``): the tensor-core
    fused kernel of ``csrc/flash_bwd_tc.cu`` without its dQ share where
    :func:`tc_route` says so (P and dS rounded to bf16 or fp16; also
    counted in ``.tc_launches``), else the CUDA-core one (float16 there
    widened to fp32)."""
    _, _, _, d = _hm_geometry(q, k, v, causal)
    _build.on_cuda(q, k, v, do, lse, delta)
    return _hm_bwd_dkdv_op(q, k, v, do, lse, delta,
                           *_hm_aux_args(lens, segs), int(n_rep),
                           bool(causal), _scale(scale, d))


flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dkdv.tc_launches = 0


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None, kv_lengths=None,
                             segment_ids=None, kv_segment_ids=None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention`, but also returns the per-row
    log-sum-exp ``[b, heads, sq]`` (fp32), the mergeable form blockwise
    and ring consumers need. Differentiable in both outputs: the lse
    cotangent rides the same backward kernels."""
    if q.ndim != 4:
        raise ValueError(f"expected [b, h, s, d], got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} inconsistent "
            f"with q {tuple(q.shape)}")
    if causal and sq != sk:
        raise ValueError("causal attention requires sq == sk")
    dtype = q.dtype
    q, k, v = _kernel_inputs(d, q, k, v)
    lens = None
    if kv_lengths is not None:
        lens = torch.as_tensor(kv_lengths, device=q.device).to(
            torch.int32).reshape(b).repeat_interleave(h)
    segs = _seg_pair(segment_ids, kv_segment_ids, b, sq, sk, q.device)
    del block_k      # JAX's key tile; the CUDA tiles are the kernels' own
    out, lse = flash_attention_fwd(
        q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
        v.reshape(b * h, sk, d), causal=causal, scale=scale, lens=lens,
        segs=segs, n_rep=h, block_q=block_q)
    return out.reshape(b, h, sq, d).to(dtype), lse.reshape(b, h, sq)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, kv_lengths=None,
                    segment_ids=None, kv_segment_ids=None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention over ``[batch, heads, seq, head_dim]`` inputs —
    the JAX function. ``causal`` masks above the diagonal; ``scale``
    defaults to ``1/sqrt(head_dim)``; ``kv_lengths [batch]`` masks keys
    past each example's length; ``segment_ids`` (and ``kv_segment_ids``)
    ``[batch, seq]`` keep rows to keys of their own segment;
    ``block_q``/``block_k`` are JAX's tile sizes (here they only feed the
    choice of backward, :func:`fused_backward`). Returns the output, same
    shape and dtype as ``q``; differentiable. float16 inputs run the
    tensor-core kernels as they are where :func:`tc_route` says so (P and
    dS rounded to fp16, where JAX widens to fp32), fused or split, else
    the fp32 kernels (JAX's ``widen_f16``)."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, scale=scale, kv_lengths=kv_lengths,
        segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        block_q=block_q, block_k=block_k)[0]


def mha(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
        kv_lengths=None, segment_ids=None) -> torch.Tensor:
    """``[b, s, h, d]`` layout convenience wrapper (fast_multihead_attn's
    self-attention layout), as JAX's ``mha``."""
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=scale, kv_lengths=kv_lengths,
        segment_ids=segment_ids)
    return out.transpose(1, 2)
