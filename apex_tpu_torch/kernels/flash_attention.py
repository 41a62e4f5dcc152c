"""Flash-attention forward over the model layout ``[batch, seq, hidden]``.

Port of ``apex_tpu/kernels/flash_attention.py:flash_attention_bsh``
(forward only; the backward kernel comes with the training slice). The
JAX package packs ``128 // head_dim`` heads into one 128-lane group and
returns lse as ``[b * n_grp, g, s]``; here one CUDA block owns one
(batch, head, query tile) and lse comes out as ``[b, heads, s]`` — the
same values, reshaped.

- :func:`flash_attention_bsh_fwd` — the kernel wrapper, ``(out, lse)``;
  CUDA tensors launch ``csrc/flash_attention_bsh.cu``, CPU tensors run
  :func:`flash_attention_bsh_plain`.
- :func:`flash_attention_bsh` — the public form, ``out`` only (the JAX
  function's signature).
- :func:`flash_attention_bsh_plain` — the plain PyTorch version: fp32
  scores times ``scale``, the causal and ``col < sk`` masks of
  ``_valid_cols`` with the finite ``-1e30`` fill, fp32 softmax
  statistics, output in the input dtype.
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


def flash_attention_bsh_plain(q, k, v, *, num_heads: int,
                              causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: ``(out [b, sq, hidden] in q's
    dtype, lse fp32 [b, heads, sq])``, all arithmetic in fp32."""
    b, sq, sk, hidden, d = _geometry(q, k, v, num_heads, causal)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    split = lambda t, n: t.float().reshape(b, n, num_heads, d).transpose(1, 2)
    qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * s_        # [b, H, sq, sk]
    col = torch.arange(sk, device=q.device)
    valid = (col < sk)[None, :].expand(sq, sk)
    if causal:
        valid = valid & (col[None, :] <= torch.arange(
            sq, device=q.device)[:, None])
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vh) / lsum
    lse = (m + torch.log(lsum))[..., 0]
    return (out.transpose(1, 2).reshape(b, sq, hidden).to(q.dtype),
            lse.contiguous())


def flash_attention_bsh_fwd(q, k, v, *, num_heads: int,
                            causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [b, sq, hidden], lse fp32 [b, heads, sq])``. CUDA tensors
    launch the kernel on the current stream (counted in
    ``flash_attention_bsh_fwd.launches``); CPU tensors run the plain
    version. The kernel takes contiguous q/k/v of one dtype (fp32 or
    bf16) with head_dim 64 and raises on anything else."""
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
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    rc = _build.library().apex_tpu_torch_flash_fwd_bsh(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, hidden, num_heads, s_, int(causal), code,
        _build.stream())
    _build.check(rc, "flash_attention_bsh")
    flash_attention_bsh_fwd.launches += 1
    return out, lse


flash_attention_bsh_fwd.launches = 0


def flash_attention_bsh(q, k, v, *, num_heads: int, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``[batch, seq, hidden]`` inputs with heads laid out
    contiguously along ``hidden`` — the JAX function's forward. Returns
    the output, same shape and dtype as ``q``."""
    return flash_attention_bsh_fwd(q, k, v, num_heads=num_heads,
                                   causal=causal, scale=scale)[0]
