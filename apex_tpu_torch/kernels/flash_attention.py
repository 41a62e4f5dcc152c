"""Flash attention over the model layout ``[batch, seq, hidden]``, forward
and backward, as differentiable custom ops.

Port of ``apex_tpu/kernels/flash_attention.py:flash_attention_bsh`` and
its custom VJP (``_flash_bsh_fwd`` / ``_flash_bsh_bwd``). The JAX package
packs ``128 // head_dim`` heads into one 128-lane group and keeps lse as
``[b * n_grp, g, s]``; here one CUDA block owns one (batch, head, tile)
and lse is ``[b, heads, s]`` — the same values, reshaped.

Two ops of the ``apex_tpu_torch`` library, joined by
``register_autograd``:

- ``apex_tpu_torch::flash_attention_bsh_fwd(q, k, v, num_heads, causal,
  scale) -> (out, lse)`` — CUDA tensors launch
  ``csrc/flash_attention_bsh.cu``, CPU tensors run
  :func:`flash_attention_bsh_plain`;
- ``apex_tpu_torch::flash_attention_bsh_bwd(q, k, v, do, lse, delta,
  num_heads, causal, scale) -> (dq, dk, dv)`` — CUDA tensors launch
  ``csrc/flash_attention_bsh_bwd.cu``, CPU tensors run
  :func:`flash_attention_bsh_bwd_plain`.

The autograd backward computes ``delta = sum_d(out * do)`` per head (the
JAX ``_flash_bsh_bwd``) and calls the backward op; lse carries no
gradient. Being ops, the forward is visible to selective activation
checkpointing, which is how ``remat_policy="qkv_fc1_attn"`` keeps the
backward from re-running the forward kernel (``models/gpt.py``).

Python wrappers: :func:`flash_attention_bsh_fwd` (``(out, lse)``),
:func:`flash_attention_bsh` (``out``, the JAX function's signature) and
:func:`flash_attention_bsh_bwd` (``(dq, dk, dv)``). The wrappers widen
float16 inputs to fp32 and cast the results back
(``apex_tpu/kernels/flash_attention.py:1167-1178``), so fp16 runs the
fp32 instantiation of the kernels. Each kernel's launch
count is kept on its wrapper (``flash_attention_bsh_fwd.launches``,
``flash_attention_bsh_bwd.launches``).
"""

from __future__ import annotations

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
    """float16 → fp32 (the kernels have no float16 instantiation, as
    Mosaic has no f16); anything else as it is."""
    return t.float() if t.dtype == torch.float16 else t


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
    """Plain PyTorch twin of the forward kernel: ``(out [b, sq, hidden]
    in q's dtype, lse fp32 [b, heads, sq])``, all arithmetic in fp32 —
    scores times ``scale``, the masks of ``_valid_cols`` with the finite
    ``-1e30`` fill, fp32 softmax statistics."""
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    s_ = _scale(scale, d)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * s_        # [b, H, sq, sk]
    valid = _valid(sq, sk, causal, q.device)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vh) / lsum
    lse = (m + torch.log(lsum))[..., 0]
    return _merge(out, q.dtype), lse.contiguous()


def flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta, *,
                                  num_heads: int, causal: bool = False,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the backward kernel, the ``_p_ds`` block
    math written out over whole rows: ``P = exp(S * scale - lse)`` under
    the valid mask, ``dS = P * (dP - delta) * scale``, ``dV = P^T dO``,
    ``dK = dS^T Q``, ``dQ = dS K`` — all in fp32 (P and dS are not
    rounded to the input dtype), results in q's dtype. ``lse`` and
    ``delta`` are fp32 ``[b, heads, sq]``."""
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    s_ = _scale(scale, d)
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (q, k, v, do))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * s_
    valid = _valid(sq, sk, causal, q.device)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None]) * s_
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
    code = _build.dtype_code(q, "flash_attention_bsh q")
    if d != _build.KERNEL_HEAD_DIM:
        raise ValueError(
            f"flash_attention_bsh kernel: head_dim {d} != "
            f"{_build.KERNEL_HEAD_DIM}")
    _build.require(q, "q", (b, sq, hidden), q.dtype)
    _build.require(k, "k", (b, sk, hidden), q.dtype)
    _build.require(v, "v", (b, sk, hidden), q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    rc = _build.library().apex_tpu_torch_flash_fwd_bsh(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, hidden, num_heads, scale, int(causal),
        code, _build.stream())
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
    code = _build.dtype_code(q, "flash_attention_bsh_bwd q")
    if d != _build.KERNEL_HEAD_DIM:
        raise ValueError(
            f"flash_attention_bsh_bwd kernel: head_dim {d} != "
            f"{_build.KERNEL_HEAD_DIM}")
    for name, t, rows in (("q", q, sq), ("k", k, sk), ("v", v, sk),
                          ("do", do, sq)):
        _build.require(t, name, (b, rows, hidden), q.dtype)
    for name, t in (("lse", lse), ("delta", delta)):
        _build.require(t, name, (b, num_heads, sq), torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _build.library().apex_tpu_torch_flash_bwd_bsh(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, sk, hidden, num_heads, scale, int(causal),
        code, _build.stream())
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
    (counted in ``flash_attention_bsh_fwd.launches``); CPU tensors run
    the plain version. The kernel takes contiguous q/k/v of one dtype,
    fp32 or bf16, with head_dim 64, and raises on anything else; float16
    inputs are widened to fp32 first and the output cast back to float16
    (the JAX function's ``widen_f16``), so they reach the fp32 kernel."""
    _, _, _, _, d = _geometry(q, k, v, num_heads, causal)
    _build.on_cuda(q, k, v)       # refuse other and mixed devices here
    half = q.dtype == torch.float16
    q, k, v = (_widen_f16(t) for t in (q, k, v))
    out, lse = _fwd_op(q, k, v, num_heads, bool(causal), _scale(scale, d))
    return (out.to(torch.float16) if half else out), lse


flash_attention_bsh_fwd.launches = 0


def flash_attention_bsh(q, k, v, *, num_heads: int, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``[batch, seq, hidden]`` inputs with heads laid out
    contiguously along ``hidden`` — the JAX function. Returns the output,
    same shape and dtype as ``q``; differentiable."""
    return flash_attention_bsh_fwd(q, k, v, num_heads=num_heads,
                                   causal=causal, scale=scale)[0]


def flash_attention_bsh_bwd(q, k, v, do, lse, delta, *, num_heads: int,
                            causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` from the forward's inputs, the output gradient
    ``do`` and the fp32 ``[b, heads, sq]`` statistics ``lse`` (from the
    forward) and ``delta`` (``sum_d(out * do)`` per head). CUDA tensors
    launch the kernel (counted in ``flash_attention_bsh_bwd.launches``),
    CPU tensors run the plain version. float16 q/k/v/do are widened to
    fp32, as in the forward, and each gradient comes back in its input's
    dtype."""
    _, _, _, _, d = _geometry(q, k, v, num_heads, causal)
    _build.on_cuda(q, k, v, do, lse, delta)
    dtypes = [t.dtype for t in (q, k, v)]
    q, k, v, do = (_widen_f16(t) for t in (q, k, v, do))
    grads = _bwd_op(q, k, v, do, lse, delta, num_heads, bool(causal),
                    _scale(scale, d))
    return tuple(g.to(dt) for g, dt in zip(grads, dtypes))


flash_attention_bsh_bwd.launches = 0
