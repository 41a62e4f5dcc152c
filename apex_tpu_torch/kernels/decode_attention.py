"""Flash-decode attention for the KV-cache decode step.

Port of ``apex_tpu/kernels/decode_attention.py:decode_attention``, which
composes two Pallas kernels; here each is a CUDA kernel in
``csrc/decode_attention.cu`` with its own wrapper and launch count:

- :func:`write_column` — ``cache[b, :, pos[b], :] = new[b]`` for the K
  and V caches in one launch, IN PLACE (the JAX kernel aliases the
  donated cache to its output; the port writes the tensor it is given);
- :func:`attend_cache` — one query row per (batch, head) attends over
  cache columns ``0..pos[b]``, fp32 scores times ``scale``, fp32 online
  softmax. Columns past ``pos[b]`` contribute exact zeros whatever they
  hold (NaN included);
- :func:`decode_attention` — the two in order: write this token's K/V
  column, then attend.

Each has a plain PyTorch twin (``*_plain``) that CPU tensors run; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.kernels import _build

_NEG = -1e30


def _check_geometry(q, k_cache, v_cache, pos):
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(
            f"expected q [b, h, d] and caches [b, h, S, d], got "
            f"{tuple(q.shape)} / {tuple(k_cache.shape)}")
    b, h, d = q.shape
    sk = k_cache.shape[2]
    if tuple(k_cache.shape) != (b, h, sk, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
            f"inconsistent with q {tuple(q.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    return b, h, sk, d


def check_positions(pos: torch.Tensor, horizon: int) -> None:
    """Host-side ``0 <= pos < horizon`` check (it synchronises, so it is
    for tests and checks, never the hot path; the kernels themselves
    never touch a column outside ``[0, horizon)``)."""
    p = pos.detach().cpu()
    if bool((p < 0).any()) or bool((p >= horizon).any()):
        raise ValueError(f"positions {p.tolist()} outside [0, {horizon})")


# ---------------------------------------------------------------------------
# column write
# ---------------------------------------------------------------------------

def write_column_plain(k_new, v_new, k_cache, v_cache, pos) -> None:
    """``k_cache[i, :, pos[i]] = k_new[i]`` (and V), in place."""
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    p = pos.to(device=k_cache.device, dtype=torch.long)
    k_cache[rows, :, p] = k_new.to(k_cache.dtype)
    v_cache[rows, :, p] = v_new.to(v_cache.dtype)


def write_column(k_new, v_new, k_cache, v_cache, pos) -> None:
    """Write ``k_new/v_new [b, h, d]`` into column ``pos[b]`` (int32
    ``[b]``) of the caches ``[b, h, S, d]``, in place; every other cache
    byte is left as it was. CUDA tensors launch the kernel (counted in
    ``write_column.launches``), CPU tensors run the plain version."""
    b, h, sk, d = _check_geometry(k_new, k_cache, v_cache, pos)
    if not _build.on_cuda(k_new, v_new, k_cache, v_cache, pos):
        write_column_plain(k_new, v_new, k_cache, v_cache, pos)
        return
    code = _build.dtype_code(k_cache, "write_column cache")
    dt = k_cache.dtype
    _build.require(k_new, "k_new", (b, h, d), dt)
    _build.require(v_new, "v_new", (b, h, d), dt)
    _build.require(k_cache, "k_cache", (b, h, sk, d), dt)
    _build.require(v_cache, "v_cache", (b, h, sk, d), dt)
    _build.require(pos, "pos", (b,), torch.int32)
    rc = _build.library().apex_tpu_torch_decode_write_column(
        k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), b, h, sk, d, code,
        _build.stream())
    _build.check(rc, "write_column")
    write_column.launches += 1


write_column.launches = 0


# ---------------------------------------------------------------------------
# split-horizon read
# ---------------------------------------------------------------------------

def attend_cache_plain(q, k_cache, v_cache, pos, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of the read: fp32 throughout, masked V rows zeroed
    BEFORE the product (``0 * NaN`` would poison the sum)."""
    b, h, sk, d = _check_geometry(q, k_cache, v_cache, pos)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * s_
    col = torch.arange(sk, device=q.device)
    valid = (col[None] <= pos.to(q.device, torch.long)[:, None])[:, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    vv = torch.where(valid[..., None], v_cache.float(),
                     torch.zeros((), device=q.device))
    out = torch.einsum("bhs,bhsd->bhd", p, vv)
    return (out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def attend_cache(q, k_cache, v_cache, pos, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """``out [b, h, d]``: each (batch, head) row of ``q`` attends over
    columns ``0..pos[b]`` of the caches. CUDA tensors launch the kernel
    (counted in ``attend_cache.launches``), CPU tensors run the plain
    version."""
    b, h, sk, d = _check_geometry(q, k_cache, v_cache, pos)
    if not _build.on_cuda(q, k_cache, v_cache, pos):
        return attend_cache_plain(q, k_cache, v_cache, pos, scale=scale)
    code = _build.dtype_code(q, "attend_cache q")
    if d != _build.KERNEL_HEAD_DIM:
        raise ValueError(
            f"attend_cache kernel: head_dim {d} != {_build.KERNEL_HEAD_DIM}")
    dt = q.dtype
    _build.require(q, "q", (b, h, d), dt)
    _build.require(k_cache, "k_cache", (b, h, sk, d), dt)
    _build.require(v_cache, "v_cache", (b, h, sk, d), dt)
    _build.require(pos, "pos", (b,), torch.int32)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    out = torch.empty_like(q)
    rc = _build.library().apex_tpu_torch_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, h, sk, d, s_, code,
        _build.stream())
    _build.check(rc, "attend_cache")
    attend_cache.launches += 1
    return out


attend_cache.launches = 0


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of :func:`decode_attention` (writes the column too)."""
    write_column_plain(k_new, v_new, k_cache, v_cache, pos)
    return attend_cache_plain(q, k_cache, v_cache, pos, scale=scale)


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One decode step of attention for every (batch, head) row.

    ``q``/``k_new``/``v_new`` are ``[b, h, d]``, ``k_cache``/``v_cache``
    ``[b, h, S, d]``, ``pos`` int32 ``[b]`` with ``0 <= pos[i] < S``
    (``gpt.decode_step`` guarantees it by freezing done slots). The
    caches gain the new column at ``pos`` IN PLACE — where the JAX
    function returns new (donated) caches — and the returned ``out [b,
    h, d]`` attends over positions ``0..pos[i]``; whatever the cache
    holds past ``pos`` never reaches it. ``scale`` defaults to
    ``1/sqrt(d)`` and multiplies the fp32 scores."""
    _check_geometry(q, k_cache, v_cache, pos)
    write_column(k_new, v_new, k_cache, v_cache, pos)
    return attend_cache(q, k_cache, v_cache, pos, scale=scale)
