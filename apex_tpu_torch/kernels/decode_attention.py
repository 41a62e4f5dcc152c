"""Flash-decode attention for the KV-cache decode step, contiguous and
paged.

Port of ``apex_tpu/kernels/decode_attention.py``. Each Pallas kernel of
the decode path is a CUDA kernel in ``csrc/decode_attention.cu`` with
its own wrapper and launch count:

- :func:`write_column` — ``cache[b, :, pos[b], :] = new[b]`` for the K
  and V caches in one launch, IN PLACE (the JAX kernel aliases the
  donated cache to its output; the port writes the tensor it is given);
- :func:`attend_cache` — one query row per (batch, head) attends over
  cache columns ``0..pos[b]``, fp32 scores times ``scale``, fp32 online
  softmax. Columns past ``pos[b]`` contribute exact zeros whatever they
  hold (NaN included). The read is bound by the bytes of the K and V
  rows it must move (about one flop a byte, so fp32 on the CUDA cores,
  no tensor cores): the kernel splits each row's horizon into
  :func:`read_splits` splits, one block each, the row's blocks one
  thread-block cluster; each block stages its split's rows in shared
  memory by 16-byte asynchronous copies while it scores the previous
  sub-tile, and the first block of the cluster merges the splits'
  (max, sum, accumulator) in split order through distributed shared
  memory — one launch, no atomics, the same bits every launch;
- :func:`decode_attention` — the two in one launch of the read: the
  block of the split that holds ``pos[b]`` stores this token's K/V rows
  into the column and scores them from the new rows, so the caches and
  the output are the write-then-read pair's bit for bit, one launch a
  layer instead of two (the decode step's main path; :func:`write_column`
  and :func:`attend_cache` stay as the counterparts of JAX's
  functions);
- :func:`cache_write_columns` — the speculative verify's T-column write
  at ``pos[b] + j``, lanes past the horizon CLAMPED onto its last
  column;
- :func:`paged_write_column`, :func:`paged_write_columns` and
  :func:`paged_attention` — the same three jobs over a global page pool
  ``[num_pages, h, P, d]`` through a block table ``[b, max_pages]``:
  logical column ``c`` of row ``b`` lives in page ``table[b, c // P]``
  at offset ``c % P``. The paged read is the contiguous kernel with only
  the rows' addresses changed (its blocks read their pages from the row's
  table), and both split a horizon alike, so on the same bytes at the same
  horizon it returns the same bits; :func:`paged_decode_attention` is the
  paged write and read in one launch, as :func:`decode_attention` is;
- :func:`decode_verify_attention` and :func:`paged_verify_attention` —
  the speculative verify's T-column write and its T-row read in one
  launch of the split read with T query rows (``verify_route``: T from 2
  to ``_build.VERIFY_MAX_ROWS``): query row ``t`` attends columns ``0 ..
  pos[b] + t`` and equals the single read at ``pos[b] + t`` bit for bit,
  the caches the multi-column write's;
- the quantized cache (int8 or fp8 e4m3 data ``[.., d]`` beside one
  fp32 scale per head row and column ``[..]``): :func:`quantize_kv_rows`
  is THE quantizer, bit for bit JAX's; :func:`write_column_quant`,
  :func:`cache_write_columns_quant`, :func:`paged_write_column_quant`
  and :func:`paged_write_columns_quant` quantize the incoming rows in
  the kernel, every head row of the call at once (a group of lanes a
  row, :func:`quant_write_geometry`), and write data and scale as their
  unquantized siblings write; :func:`attend_cache_quant` and
  :func:`paged_attention_quantized` are the same split read over rows stored a byte a value: each block
  stages its split's int8 or fp8 rows as stored, and their fp32 scales
  beside them, by asynchronous copies, widens them to fp32 in registers
  and folds the scales into the scores and the probabilities (about
  ``(d + 4) / (2 d)`` of the bf16 read's bytes); the horizon splits as
  the plain reads' does, so the paged quantized read returns the
  contiguous one's bits; :func:`decode_attention_quantized` is the
  write and the read in order.

The kernels take fp32, bf16 or fp16 rows (``_build.DECODE_DTYPE_CODES``)
and the reads any head width up to ``_build.HM_MAX_HEAD_DIM`` (128).
Each has a plain PyTorch twin (``*_plain``) that CPU tensors run; CUDA
tensors launch the kernel or raise. Beside them are the XLA spellings
the model's materialised-scores path uses (:func:`paged_gather_xla`,
:func:`paged_write_columns_xla`, :func:`cache_write_columns_xla`): they
DROP lanes past the horizon where the kernels clamp them, both as in
the JAX package.
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


def _check_head_dim(d: int, name: str) -> None:
    """The reads' kernels take any head width from 1 to the head-major
    flash kernels' cap, ``_build.HM_MAX_HEAD_DIM``; a wider one raises."""
    if not 1 <= d <= _build.HM_MAX_HEAD_DIM:
        raise ValueError(
            f"{name} kernel: head_dim {d} outside [1, "
            f"{_build.HM_MAX_HEAD_DIM}] (HM_MAX_HEAD_DIM, the decode "
            f"reads' cap)")


#: the fewest values of each plane a split of the reads covers: a split
#: of 32 columns at a narrow head would move a few KB, less than its
#: block's fixed cost (the cluster barrier and the merge) is worth
READ_SPLIT_MIN_VALUES = 2048


def read_splits(horizon: int, d: int):
    """The four reads' split geometry ``(split_cols, n_splits)`` over a
    horizon of ``horizon`` columns at head width ``d``. ``split_cols`` is
    a multiple of ``_build.READ_SPLIT_COLS`` (the kernel's sub-tile) of
    at least ``READ_SPLIT_MIN_VALUES / d`` columns, and ``n_splits =
    ceil(horizon / split_cols)`` is at most ``_build.READ_MAX_SPLITS``
    (one cluster a row); split ``s`` covers the columns ``[s *
    split_cols, min((s + 1) * split_cols, horizon))``. It depends on the
    horizon and d alone, never on the positions, so the launch waits on
    nothing from the device, and the contiguous and the paged read over
    one horizon split it alike (and so sum in the same order), plain or
    quantized: the quantized reads take the plain reads' geometry."""
    if horizon < 1 or d < 1:
        raise ValueError(f"read_splits: horizon {horizon} and head width "
                         f"{d} must be positive")
    unit = _build.READ_SPLIT_COLS
    least = -(-READ_SPLIT_MIN_VALUES // d)
    units = max(-(-least // unit),
                -(-horizon // (_build.READ_MAX_SPLITS * unit)))
    return unit * units, -(-horizon // (unit * units))


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
    code = _build.decode_dtype_code(k_cache, "write_column cache")
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
    columns ``0..pos[b]`` of the caches. CUDA tensors launch the kernel,
    the horizon ``S`` in :func:`read_splits` ``(S, d)`` splits (counted
    in ``attend_cache.launches``), CPU tensors run the plain version."""
    b, h, sk, d = _check_geometry(q, k_cache, v_cache, pos)
    if not _build.on_cuda(q, k_cache, v_cache, pos):
        return attend_cache_plain(q, k_cache, v_cache, pos, scale=scale)
    code = _build.decode_dtype_code(q, "attend_cache q")
    _check_head_dim(d, "attend_cache")
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
        *read_splits(sk, d), _build.stream())
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
    ``1/sqrt(d)`` and multiplies the fp32 scores. CUDA tensors launch
    the read once, the write inside it (counted in
    ``decode_attention.launches``, not in :func:`write_column`'s or
    :func:`attend_cache`'s count), the horizon ``S`` in
    :func:`read_splits` ``(S, d)`` splits; CPU tensors run the plain
    version, the write and then the read."""
    b, h, sk, d = _check_geometry(q, k_cache, v_cache, pos)
    if not _build.on_cuda(q, k_new, v_new, k_cache, v_cache, pos):
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos,
                                      scale=scale)
    code = _build.decode_dtype_code(q, "decode_attention q")
    _check_head_dim(d, "decode_attention")
    dt = q.dtype
    _build.require(q, "q", (b, h, d), dt)
    _build.require(k_new, "k_new", (b, h, d), dt)
    _build.require(v_new, "v_new", (b, h, d), dt)
    _build.require(k_cache, "k_cache", (b, h, sk, d), dt)
    _build.require(v_cache, "v_cache", (b, h, sk, d), dt)
    _build.require(pos, "pos", (b,), torch.int32)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    out = torch.empty_like(q)
    rc = _build.library().apex_tpu_torch_decode_attention_write(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, sk, d, s_,
        code, *read_splits(sk, d), _build.stream())
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# multi-column and paged writes: the cell scatter shared by the plain twins
# and the XLA spellings
# ---------------------------------------------------------------------------

def _scatter_cells(plane, new, i0, i2, keep, *, first: bool) -> None:
    """``plane[i0[n], :, i2[n]] = new[n]`` IN PLACE for the writers ``n``
    where ``keep`` holds (``new [n, h, d]`` in writer order; ``i0``/``i2``
    in range for every writer). Where several kept writers hit one cell
    the first (``first=True``, the XLA spellings' argmax) or the last
    (the Pallas grid's last writer) wins, decided per cell before the
    write, so the result never depends on how an indexed assignment
    orders duplicates. The plane is rewritten whole, as the JAX
    spelling does, with no host synchronisation (a CUDA graph can
    capture it)."""
    d0, h, d2, d = plane.shape
    n = new.shape[0]
    order = torch.arange(n, device=plane.device)
    fill = n if first else -1
    src = torch.where(keep, order, torch.full_like(order, fill))
    win = torch.full((d0 * d2,), fill, dtype=torch.long,
                     device=plane.device).scatter_reduce(
        0, i0 * d2 + i2, src, "amin" if first else "amax")
    hit = (win != fill)[:, None, None]
    taken = new[win.clamp(0, n - 1)].to(plane.dtype)
    flat = plane.permute(0, 2, 1, 3).reshape(d0 * d2, h, d)
    plane.copy_(torch.where(hit, taken, flat).view(d0, d2, h, d).permute(
        0, 2, 1, 3))


def _columns(pos, t: int, device) -> torch.Tensor:
    """Logical columns ``pos[b] + j`` as int64 ``[b, t]``."""
    p = pos.to(device=device, dtype=torch.long)
    return p[:, None] + torch.arange(t, device=device)[None]


def _lanes(new) -> torch.Tensor:
    """``new [b, h, T, d]`` → ``[b * T, h, d]`` in writer order (row
    major over (b, j), the Pallas grid's order)."""
    b, h, t, d = new.shape
    return new.permute(0, 2, 1, 3).reshape(b * t, h, d)


def _page_cells(table, cols, p: int):
    """(page, offset) of logical columns ``cols [b, T]`` (already inside
    the horizon) under ``table [b, max_pages]``."""
    tbl = table.to(device=cols.device, dtype=torch.long)
    return torch.gather(tbl, 1, cols // p), cols % p


def cache_write_columns_xla(cache, new, pos) -> None:
    """The XLA spelling of the multi-column write, one plane at a time:
    ``cache [b, h, S, d]`` gains ``new [b, h, T, d]`` at columns ``pos[b]
    + j`` IN PLACE; columns at or past ``S`` are DROPPED (the write guard
    the verify forward relies on: an over-horizon lane must not clamp
    into a neighbouring column)."""
    b, _, sk, _ = cache.shape
    t = new.shape[2]
    cols = _columns(pos, t, cache.device)
    keep = ((cols >= 0) & (cols < sk)).reshape(-1)
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    _scatter_cells(cache, _lanes(new), rows.reshape(-1),
                   cols.clamp(0, sk - 1).reshape(-1), keep, first=True)


def paged_gather_xla(plane, table) -> torch.Tensor:
    """The row-contiguous view of a paged plane: ``plane [num_pages, h,
    P, d]`` under ``table [b, max_pages]`` → ``[b, h, max_pages * P,
    d]``, the bytes a contiguous cache would hold."""
    g = plane[table.to(device=plane.device, dtype=torch.long)]
    b, mp, h, p, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, mp * p, d)


def paged_write_columns_xla(plane, new, table, pos) -> None:
    """Write ``new [b, h, T, d]`` into logical columns ``pos[b] + j`` of
    the paged plane ``[num_pages, h, P, d]`` under ``table [b,
    max_pages]``, IN PLACE. Columns at or past the row's ``max_pages *
    P`` horizon are DROPPED; rows that collide in a shared page (the
    sink) leave the first hitter's value, as JAX's argmax does."""
    p = plane.shape[2]
    smax = table.shape[1] * p
    t = new.shape[2]
    cols = _columns(pos, t, plane.device)
    keep = ((cols >= 0) & (cols < smax)).reshape(-1)
    pages, offs = _page_cells(table, cols.clamp(0, smax - 1), p)
    _scatter_cells(plane, _lanes(new), pages.reshape(-1), offs.reshape(-1),
                   keep, first=True)


def _check_paged(q_or_new, k_pool, v_pool, table, pos, *,
                 multi: bool = False):
    """Geometry of the paged kernels: rows ``[b, h, d]`` (``[b, h, T, d]``
    with ``multi``), pools ``[num_pages, h, P, d]``, table ``[b,
    max_pages]``, pos ``[b]``."""
    want = 4 if multi else 3
    if q_or_new.ndim != want or k_pool.ndim != 4:
        raise ValueError(
            f"expected rows of rank {want} and pools [num_pages, h, P, d], "
            f"got {tuple(q_or_new.shape)} / {tuple(k_pool.shape)}")
    b, h, d = (q_or_new.shape[0], q_or_new.shape[1], q_or_new.shape[-1])
    n, hp, p, dp = k_pool.shape
    if (hp, dp) != (h, d) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
            f"inconsistent with rows {tuple(q_or_new.shape)}")
    if table.ndim != 2 or table.shape[0] != b:
        raise ValueError(f"table must be [{b}, max_pages], got "
                         f"{tuple(table.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    return b, h, n, p, table.shape[1], d


# ---------------------------------------------------------------------------
# cache_write_columns (contiguous, T columns)
# ---------------------------------------------------------------------------

def cache_write_columns_plain(k_new, v_new, k_cache, v_cache, pos) -> None:
    """Plain twin of the Pallas ``_write_cols_kernel``: lane ``j`` of row
    ``b`` lands at column ``min(pos[b] + j, S - 1)``, IN PLACE; of the
    lanes clamped onto ``S - 1`` the row's last one wins."""
    b, _, sk, _ = k_cache.shape
    t = k_new.shape[2]
    cols = _columns(pos, t, k_cache.device).clamp(max=sk - 1)
    rows = torch.arange(b, device=k_cache.device)[:, None].expand(b, t)
    keep = (cols >= 0).reshape(-1)
    for new, cache in ((k_new, k_cache), (v_new, v_cache)):
        _scatter_cells(cache, _lanes(new), rows.reshape(-1),
                       cols.clamp(min=0).reshape(-1), keep, first=False)


def cache_write_columns(k_new, v_new, k_cache, v_cache, pos) -> None:
    """Write ``k_new/v_new [b, h, T, d]`` into columns ``pos[b] .. pos[b]
    + T - 1`` of the caches ``[b, h, S, d]`` IN PLACE, lanes past the
    horizon clamped onto column ``S - 1`` (only discarded lanes ever read
    that cell, see the JAX function). CUDA tensors launch the kernel
    (counted in ``cache_write_columns.launches``), CPU tensors run the
    plain version."""
    if k_new.ndim != 4 or k_cache.ndim != 4:
        raise ValueError(
            f"expected new [b, h, T, d] and caches [b, h, S, d], got "
            f"{tuple(k_new.shape)} / {tuple(k_cache.shape)}")
    b, h, t, d = k_new.shape
    sk = k_cache.shape[2]
    if tuple(k_cache.shape) != (b, h, sk, d) \
            or v_cache.shape != k_cache.shape or v_new.shape != k_new.shape:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
            f"inconsistent with new {tuple(k_new.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    if not _build.on_cuda(k_new, v_new, k_cache, v_cache, pos):
        cache_write_columns_plain(k_new, v_new, k_cache, v_cache, pos)
        return
    code = _build.decode_dtype_code(k_cache, "cache_write_columns cache")
    dt = k_cache.dtype
    _build.require(k_new, "k_new", (b, h, t, d), dt)
    _build.require(v_new, "v_new", (b, h, t, d), dt)
    _build.require(k_cache, "k_cache", (b, h, sk, d), dt)
    _build.require(v_cache, "v_cache", (b, h, sk, d), dt)
    _build.require(pos, "pos", (b,), torch.int32)
    rc = _build.library().apex_tpu_torch_cache_write_columns(
        k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), b, h, t, sk, d, code,
        _build.stream())
    _build.check(rc, "cache_write_columns")
    cache_write_columns.launches += 1


cache_write_columns.launches = 0


# ---------------------------------------------------------------------------
# paged writes
# ---------------------------------------------------------------------------

def _paged_write_plain(new, pool, table, pos, *, clamp: bool) -> None:
    p = pool.shape[2]
    smax = table.shape[1] * p
    t = new.shape[2]
    cols = _columns(pos, t, pool.device)
    if clamp:
        keep = cols >= 0
    else:
        keep = (cols >= 0) & (cols < smax)
    pages, offs = _page_cells(table, cols.clamp(0, smax - 1), p)
    _scatter_cells(pool, _lanes(new), pages.reshape(-1), offs.reshape(-1),
                   keep.reshape(-1), first=False)


def paged_write_column_plain(k_new, v_new, k_pool, v_pool, table,
                             pos) -> None:
    """Plain twin of ``_paged_write_kernel``: ``pool[table[b, pos // P],
    :, pos % P] = new[b]`` for both pools, IN PLACE (a position outside
    the horizon is not written)."""
    for new, pool in ((k_new, k_pool), (v_new, v_pool)):
        _paged_write_plain(new[:, :, None], pool, table, pos, clamp=False)


def paged_write_column(k_new, v_new, k_pool, v_pool, table, pos) -> None:
    """Write ``k_new/v_new [b, h, d]`` into logical column ``pos[b]`` of
    the pools ``[num_pages, h, P, d]`` under ``table [b, max_pages]``
    (int32) IN PLACE: page ``table[b, pos // P]``, offset ``pos % P``.
    CUDA tensors launch the kernel (counted in
    ``paged_write_column.launches``), CPU tensors run the plain
    version."""
    b, h, n, p, mp, d = _check_paged(k_new, k_pool, v_pool, table, pos)
    if not _build.on_cuda(k_new, v_new, k_pool, v_pool, table, pos):
        paged_write_column_plain(k_new, v_new, k_pool, v_pool, table, pos)
        return
    code = _build.decode_dtype_code(k_pool, "paged_write_column pool")
    dt = k_pool.dtype
    _build.require(k_new, "k_new", (b, h, d), dt)
    _build.require(v_new, "v_new", (b, h, d), dt)
    _build.require(k_pool, "k_pool", (n, h, p, d), dt)
    _build.require(v_pool, "v_pool", (n, h, p, d), dt)
    _build.require(table, "table", (b, mp), torch.int32)
    _build.require(pos, "pos", (b,), torch.int32)
    rc = _build.library().apex_tpu_torch_paged_write_column(
        k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(), b, h, p, mp, d,
        code, _build.stream())
    _build.check(rc, "paged_write_column")
    paged_write_column.launches += 1


paged_write_column.launches = 0


def paged_write_columns_plain(k_new, v_new, k_pool, v_pool, table,
                              pos) -> None:
    """Plain twin of ``_paged_write_cols_kernel``: lane ``j`` of row ``b``
    lands at logical column ``min(pos[b] + j, max_pages * P - 1)`` through
    the table, IN PLACE; where lanes collide the last one (row major over
    (b, j)) wins."""
    for new, pool in ((k_new, k_pool), (v_new, v_pool)):
        _paged_write_plain(new, pool, table, pos, clamp=True)


def paged_write_columns(k_new, v_new, k_pool, v_pool, table, pos) -> None:
    """Write ``k_new/v_new [b, h, T, d]`` into logical columns ``pos[b] ..
    pos[b] + T - 1`` of the pools through ``table`` IN PLACE, lanes past
    the row's horizon ``max_pages * P`` clamped onto its last column.
    CUDA tensors launch the kernel (counted in
    ``paged_write_columns.launches``), CPU tensors run the plain
    version."""
    b, h, n, p, mp, d = _check_paged(k_new, k_pool, v_pool, table, pos,
                                     multi=True)
    t = k_new.shape[2]
    if not _build.on_cuda(k_new, v_new, k_pool, v_pool, table, pos):
        paged_write_columns_plain(k_new, v_new, k_pool, v_pool, table, pos)
        return
    code = _build.decode_dtype_code(k_pool, "paged_write_columns pool")
    dt = k_pool.dtype
    _build.require(k_new, "k_new", (b, h, t, d), dt)
    _build.require(v_new, "v_new", (b, h, t, d), dt)
    _build.require(k_pool, "k_pool", (n, h, p, d), dt)
    _build.require(v_pool, "v_pool", (n, h, p, d), dt)
    _build.require(table, "table", (b, mp), torch.int32)
    _build.require(pos, "pos", (b,), torch.int32)
    rc = _build.library().apex_tpu_torch_paged_write_columns(
        k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(), b, h, t, p, mp,
        d, code, _build.stream())
    _build.check(rc, "paged_write_columns")
    paged_write_columns.launches += 1


paged_write_columns.launches = 0


# ---------------------------------------------------------------------------
# paged read
# ---------------------------------------------------------------------------

def paged_attention_plain(q, k_pool, v_pool, table, pos, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``_paged_attn_kernel``: the rows' pages gathered
    into the contiguous view, then :func:`attend_cache_plain` (fp32,
    columns past ``pos`` masked before any product, so stale pages and
    the sink never reach the output)."""
    _check_paged(q, k_pool, v_pool, table, pos)
    return attend_cache_plain(q, paged_gather_xla(k_pool, table),
                              paged_gather_xla(v_pool, table), pos,
                              scale=scale)


def paged_attention(q, k_pool, v_pool, table, pos, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``out [b, h, d]``: each (batch, head) row of ``q`` attends over its
    logical columns ``0..pos[b]`` of the pools ``[num_pages, h, P, d]``
    through ``table [b, max_pages]`` (int32) — the contiguous kernel
    with column ``c`` read from page ``table[b, c // P]``, the horizon
    ``max_pages * P`` in :func:`read_splits` splits. Takes any ``P >= 1``
    and any ``max_pages``; ``pos`` must lie in ``[0, max_pages * P)``
    (:func:`check_positions` checks it off the hot path). CUDA tensors
    launch the kernel (counted in ``paged_attention.launches``), CPU
    tensors run the plain version."""
    b, h, n, p, mp, d = _check_paged(q, k_pool, v_pool, table, pos)
    if not _build.on_cuda(q, k_pool, v_pool, table, pos):
        return paged_attention_plain(q, k_pool, v_pool, table, pos,
                                     scale=scale)
    code = _build.decode_dtype_code(q, "paged_attention q")
    _check_head_dim(d, "paged_attention")
    dt = q.dtype
    _build.require(q, "q", (b, h, d), dt)
    _build.require(k_pool, "k_pool", (n, h, p, d), dt)
    _build.require(v_pool, "v_pool", (n, h, p, d), dt)
    _build.require(table, "table", (b, mp), torch.int32)
    _build.require(pos, "pos", (b,), torch.int32)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    out = torch.empty_like(q)
    rc = _build.library().apex_tpu_torch_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, p, mp, d, s_,
        code, *read_splits(mp * p, d), _build.stream())
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_decode_attention_plain(q, k_new, v_new, k_pool, v_pool, table, pos,
                                 *, scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain twin of :func:`paged_decode_attention`: the paged write, then
    the paged read."""
    paged_write_column_plain(k_new, v_new, k_pool, v_pool, table, pos)
    return paged_attention_plain(q, k_pool, v_pool, table, pos, scale=scale)


def paged_decode_attention(q, k_new, v_new, k_pool, v_pool, table, pos, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention` over the pools ``[num_pages, h, P, d]``
    through ``table [b, max_pages]`` (int32): ``k_new/v_new [b, h, d]``
    land at page ``table[b, pos // P]``, offset ``pos % P``, IN PLACE, and
    ``out [b, h, d]`` attends over logical columns ``0..pos[b]`` — what
    :func:`paged_write_column` then :func:`paged_attention` compute, bit
    for bit, in ONE launch of the read (counted in
    ``paged_decode_attention.launches``), the horizon ``max_pages * P`` in
    :func:`read_splits` splits. CPU tensors run the plain version."""
    b, h, n, p, mp, d = _check_paged(q, k_pool, v_pool, table, pos)
    if not _build.on_cuda(q, k_new, v_new, k_pool, v_pool, table, pos):
        return paged_decode_attention_plain(q, k_new, v_new, k_pool, v_pool,
                                            table, pos, scale=scale)
    code = _build.decode_dtype_code(q, "paged_decode_attention q")
    _check_head_dim(d, "paged_decode_attention")
    dt = q.dtype
    _build.require(q, "q", (b, h, d), dt)
    _build.require(k_new, "k_new", (b, h, d), dt)
    _build.require(v_new, "v_new", (b, h, d), dt)
    _build.require(k_pool, "k_pool", (n, h, p, d), dt)
    _build.require(v_pool, "v_pool", (n, h, p, d), dt)
    _build.require(table, "table", (b, mp), torch.int32)
    _build.require(pos, "pos", (b,), torch.int32)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    out = torch.empty_like(q)
    rc = _build.library().apex_tpu_torch_paged_attention_write(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, p, mp, d, s_, code, *read_splits(mp * p, d), _build.stream())
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# the speculative verify: the T-column write inside a T-row split read
# ---------------------------------------------------------------------------

def verify_route(t: int) -> bool:
    """THE verify dispatch predicate, from the query rows a (batch, head)
    row alone (T = spec_k + 1): True sends a compute-dtype verify on the
    kernel impl to :func:`decode_verify_attention` (or its paged sibling),
    one launch a layer; False keeps the multi-column write then the
    materialised read. T from 2 to ``_build.VERIFY_MAX_ROWS`` (8: spec_k
    <= 7) takes the launch; T = 1 is the decode step's own launch."""
    return 2 <= t <= _build.VERIFY_MAX_ROWS


def _check_verify(q, k_new, v_new, k_plane, v_plane, pos, *, paged: bool):
    """Geometry of the verify: q/k_new/v_new ``[b, h, T, d]``, the caches
    ``[b, h, S, d]`` or the pools ``[num_pages, h, P, d]``, pos ``[b]``.
    Returns (b, h, T, d)."""
    if q.ndim != 4 or k_new.shape != q.shape or v_new.shape != q.shape \
            or k_plane.ndim != 4 or v_plane.shape != k_plane.shape:
        raise ValueError(
            f"expected q/k_new/v_new [b, h, T, d] and planes of rank 4, got "
            f"{tuple(q.shape)} / {tuple(k_new.shape)} / {tuple(v_new.shape)}"
            f" / {tuple(k_plane.shape)} / {tuple(v_plane.shape)}")
    b, h, t, d = q.shape
    if (k_plane.shape[1], k_plane.shape[3]) != (h, d) \
            or (not paged and k_plane.shape[0] != b):
        raise ValueError(f"planes {tuple(k_plane.shape)} inconsistent with "
                         f"rows {tuple(q.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    return b, h, t, d


def verify_read_plain(q, k_cache, v_cache, pos, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The verify's read, plain: query row ``t`` of ``q [b, h, T, d]`` is
    :func:`attend_cache_plain` at position ``pos[b] + t`` over the caches
    (a position past the horizon reads every column), so each row is the
    single read's plain twin, bits included."""
    p = pos.to(device=q.device, dtype=torch.long)
    return torch.stack([attend_cache_plain(q[:, :, t], k_cache, v_cache,
                                           p + t, scale=scale)
                        for t in range(q.shape[2])], dim=2)


def decode_verify_attention_plain(q, k_new, v_new, k_cache, v_cache, pos, *,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Plain twin of :func:`decode_verify_attention`: the multi-column
    write (:func:`cache_write_columns_plain`), then the read."""
    cache_write_columns_plain(k_new, v_new, k_cache, v_cache, pos)
    return verify_read_plain(q, k_cache, v_cache, pos, scale=scale)


def decode_verify_attention(q, k_new, v_new, k_cache, v_cache, pos, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The speculative verify's attention of one layer: ``k_new/v_new [b,
    h, T, d]`` land in columns ``pos[b] .. pos[b] + T - 1`` of the caches
    ``[b, h, S, d]`` IN PLACE, lanes past the horizon clamped onto column
    ``S - 1`` (:func:`cache_write_columns`), and query row ``t`` of ``q
    [b, h, T, d]`` attends columns ``0 .. min(pos[b] + t, S - 1)`` of the
    written cache → ``out [b, h, T, d]``; the fp32 scores times ``scale``
    (default ``1/sqrt(d)``). CUDA tensors launch the T-row split read once,
    the write inside it (counted in ``decode_verify_attention.launches``,
    not in :func:`cache_write_columns`'), the horizon in
    :func:`read_splits` ``(S, d)`` splits, each query row bit for bit
    :func:`attend_cache` at ``pos[b] + t``; ``1 <= T <=
    _build.VERIFY_MAX_ROWS``. CPU tensors run the plain version."""
    b, h, t, d = _check_verify(q, k_new, v_new, k_cache, v_cache, pos,
                               paged=False)
    sk = k_cache.shape[2]
    if not _build.on_cuda(q, k_new, v_new, k_cache, v_cache, pos):
        return decode_verify_attention_plain(q, k_new, v_new, k_cache,
                                             v_cache, pos, scale=scale)
    return _launch_verify("decode_verify_attention", decode_verify_attention,
                          q, k_new, v_new, k_cache, v_cache, None, pos,
                          (b, h, t, sk, d), sk, scale)


decode_verify_attention.launches = 0


def paged_verify_attention_plain(q, k_new, v_new, k_pool, v_pool, table, pos,
                                 *, scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain twin of :func:`paged_verify_attention`: the paged multi-column
    write (:func:`paged_write_columns_plain`), then the read over the
    gathered row-contiguous view."""
    paged_write_columns_plain(k_new, v_new, k_pool, v_pool, table, pos)
    return verify_read_plain(q, paged_gather_xla(k_pool, table),
                             paged_gather_xla(v_pool, table), pos,
                             scale=scale)


def paged_verify_attention(q, k_new, v_new, k_pool, v_pool, table, pos, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_verify_attention` over the pools ``[num_pages, h, P,
    d]`` through ``table [b, max_pages]`` (int32): the lanes land at
    logical columns ``pos[b] + j`` (clamped onto the row's last logical
    column ``max_pages * P - 1``, :func:`paged_write_columns`), and query
    row ``t`` attends logical columns ``0 .. pos[b] + t`` — one launch
    (counted in ``paged_verify_attention.launches``), the horizon
    ``max_pages * P`` in :func:`read_splits` splits, so on the same bytes
    it returns the contiguous launch's bits. CPU tensors run the plain
    version."""
    b, h, t, d = _check_verify(q, k_new, v_new, k_pool, v_pool, pos,
                               paged=True)
    n, _, p, _ = k_pool.shape
    if table.ndim != 2 or table.shape[0] != b:
        raise ValueError(f"table must be [{b}, max_pages], got "
                         f"{tuple(table.shape)}")
    mp = table.shape[1]
    if not _build.on_cuda(q, k_new, v_new, k_pool, v_pool, table, pos):
        return paged_verify_attention_plain(q, k_new, v_new, k_pool, v_pool,
                                            table, pos, scale=scale)
    return _launch_verify("paged_verify_attention", paged_verify_attention,
                          q, k_new, v_new, k_pool, v_pool, table, pos,
                          (b, h, t, p, mp, d), mp * p, scale)


paged_verify_attention.launches = 0


def _launch_verify(entry: str, counted, q, k_new, v_new, k_plane, v_plane,
                   table, pos, dims, horizon, scale) -> torch.Tensor:
    """Check the operands of a verify launch and launch ``entry``: ``dims``
    are the geometry ints the C entry takes after the pointers, the
    ``horizon`` in :func:`read_splits` ``(horizon, d)`` splits."""
    code = _build.decode_dtype_code(q, f"{entry} q")
    b, h, t, d = q.shape
    _check_head_dim(d, entry)
    if not 1 <= t <= _build.VERIFY_MAX_ROWS:
        raise ValueError(f"{entry}: {t} query rows outside [1, "
                         f"{_build.VERIFY_MAX_ROWS}] (VERIFY_MAX_ROWS)")
    dt = q.dtype
    for x, name in ((q, "q"), (k_new, "k_new"), (v_new, "v_new")):
        _build.require(x, name, (b, h, t, d), dt)
    _build.require(k_plane, "k_plane", tuple(k_plane.shape), dt)
    _build.require(v_plane, "v_plane", tuple(k_plane.shape), dt)
    _build.require(pos, "pos", (b,), torch.int32)
    ptrs = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_plane.data_ptr(), v_plane.data_ptr()]
    if table is not None:
        _build.require(table, "table", tuple(table.shape), torch.int32)
        ptrs.append(table.data_ptr())
    out = torch.empty_like(q)
    ptrs += [pos.data_ptr(), out.data_ptr()]
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    rc = getattr(_build.library(), f"apex_tpu_torch_{entry}")(
        *ptrs, *dims, s_, code, *read_splits(horizon, d), _build.stream())
    _build.check(rc, entry)
    counted.launches += 1
    return out


# ---------------------------------------------------------------------------
# the quantized cache: int8 / fp8 e4m3 storage plus per-row fp32 scales
# ---------------------------------------------------------------------------

#: symmetric quantization range per storage kind (int8 keeps the signed
#: range symmetric at ±127; fp8 e4m3fn saturates at ±448)
KV_QMAX = {"int8": 127.0, "fp8": 448.0}


def kv_storage_dtype(kind: str) -> torch.dtype:
    """Torch storage dtype of a quantized-KV kind."""
    if kind == "int8":
        return torch.int8
    if kind == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantized-KV kind {kind!r}")


def kv_kind_of(dtype: torch.dtype) -> str:
    """The quantized-KV kind a storage dtype holds (the inverse of
    :func:`kv_storage_dtype`)."""
    for kind in KV_QMAX:
        if kv_storage_dtype(kind) == dtype:
            return kind
    raise TypeError(f"{dtype} is not a quantized-KV storage dtype "
                    f"(int8 or float8_e4m3fn)")


def quantize_kv_rows(x: torch.Tensor, kind: str):
    """THE KV quantizer: ``x [..., head_dim]`` (one K or V row per
    leading coordinate) → ``(q [..., head_dim] storage, scale [...]
    fp32)``. Symmetric absmax per row, round to nearest even. Every
    write path of the quantized cache (the kernels, the XLA spellings,
    bulk prefill) calls this or matches it bit for bit, as in the JAX
    package: ``scale = max(amax, 1e-12) * fp32(1 / qmax)`` (the
    reciprocal rounded once to fp32, never ``amax / qmax``), ``y = x /
    scale`` as a true division, then int8 ``clip(round(y), ±127)`` or
    fp8 ``clip(y, ±448)`` cast to e4m3fn."""
    xf = x.float()
    qmax = KV_QMAX[kind]
    amax = xf.abs().amax(dim=-1)
    recip = torch.full((), 1.0 / qmax, dtype=torch.float32,
                       device=x.device)
    scale = torch.clamp_min(amax, 1e-12) * recip
    y = xf / scale[..., None]
    if kind == "int8":
        q = torch.round(y).clamp(-qmax, qmax).to(torch.int8)
    else:
        q = y.clamp(-qmax, qmax).to(torch.float8_e4m3fn)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: ``q [..., d]`` times the
    per-row ``scale [...]``, in fp32, cast to ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A one-byte storage plane as uint8 (the cell scatters and gathers
    move bytes; fp8 has no indexed assignment everywhere), any other
    plane as it is."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _check_quant_planes(rows, k_q, k_s, v_q, v_s, kind: Optional[str],
                        what: str) -> str:
    """``k_q/v_q [n, h, cols, d]`` of one storage dtype and ``k_s/v_s [n,
    h, cols]`` fp32 beside rows ``[b, h, (T,) d]``, and ``kind`` (when
    given) the planes' storage; returns the kind."""
    if k_q.ndim != 4 or k_s.shape != k_q.shape[:3] \
            or v_q.shape != k_q.shape or v_s.shape != k_s.shape:
        raise ValueError(
            f"{what}: quantized planes {tuple(k_q.shape)}/{tuple(k_s.shape)}"
            f" and {tuple(v_q.shape)}/{tuple(v_s.shape)} are not [n, h, "
            f"cols, d] and [n, h, cols]")
    if (k_q.shape[1], k_q.shape[3]) != (rows.shape[1], rows.shape[-1]):
        raise ValueError(f"{what}: planes {tuple(k_q.shape)} inconsistent "
                         f"with rows {tuple(rows.shape)}")
    if v_q.dtype != k_q.dtype or k_s.dtype != torch.float32 \
            or v_s.dtype != torch.float32:
        raise TypeError(f"{what}: planes must be one storage dtype with "
                        f"fp32 scales")
    stored = kv_kind_of(k_q.dtype)
    if kind is not None and kind != stored:
        raise ValueError(f"{what}: kind {kind!r} but the planes hold "
                         f"{stored!r}")
    return stored


def _quant_columns_plain(k_new, v_new, k_q, k_s, v_q, v_s, pos, *,
                         table=None, clamp: bool) -> None:
    """The plain twin of every quantized write: lane ``j`` of row ``b``
    (``new [b, h, T, d]``) is quantized by :func:`quantize_kv_rows` and
    lands, data and scale, at logical column ``pos[b] + j`` — in the
    contiguous planes, or through ``table`` in the pool — clamped onto
    the horizon's last column (``clamp``) or not written past it; where
    kept lanes collide the last one wins."""
    b, _, t, _ = k_new.shape
    dev = k_q.device
    cols = _columns(pos, t, dev)
    if table is None:
        smax = k_q.shape[2]
    else:
        smax = table.shape[1] * k_q.shape[2]
    keep = (cols >= 0) if clamp else (cols >= 0) & (cols < smax)
    cols = cols.clamp(0, smax - 1)
    if table is None:
        i0 = torch.arange(b, device=dev)[:, None].expand(b, t)
        i2 = cols
    else:
        i0, i2 = _page_cells(table, cols, k_q.shape[2])
    i0, i2, keep = i0.reshape(-1), i2.reshape(-1), keep.reshape(-1)
    for new, qp, sp in ((k_new, k_q, k_s), (v_new, v_q, v_s)):
        q, sc = quantize_kv_rows(_lanes(new), kv_kind_of(qp.dtype))
        _scatter_cells(_bytes(qp), _bytes(q), i0, i2, keep, first=False)
        _scatter_cells(sp[..., None], sc[..., None], i0, i2, keep,
                       first=False)


def quant_write_geometry(h: int, d: int, dtype: torch.dtype):
    """How ``csrc/decode_attention.cu``'s quantized writes lay the 2 x h
    head rows of one (row, lane) over their blocks, from h, d and the new
    rows' dtype alone: ``(unit bytes, units a row, lanes a row, rows a
    block, blocks)``. A row's ``d * itemsize`` bytes are units of the
    widest of 16, 8, 4 and 2 bytes that divides them; a group of lanes (the
    units rounded up to a power of two, at most 32) owns a row, lane ``t``
    taking units ``t, t + group, ...``; a block of
    ``_build.QUANT_WRITE_THREADS`` threads holds ``threads / group`` rows,
    K rows ``0..h-1`` then V rows ``h..2h-1``; the grid is ``(b, T,
    blocks)``."""
    row_bytes = d * dtype.itemsize
    unit = next(u for u in (16, 8, 4, 2) if row_bytes % u == 0)
    units = row_bytes // unit
    group = min(32, 1 << (units - 1).bit_length())
    per_block = _build.QUANT_WRITE_THREADS // group
    return unit, units, group, per_block, -(-2 * h // per_block)


def _launch_quant_write(entry: str, counted, k_new, v_new, k_q, k_s, v_q,
                        v_s, pos, table, dims) -> None:
    """Check the operands of a quantized write and launch ``entry``:
    ``dims`` are the geometry ints the C entry takes after the pointers,
    before the input dtype and the storage kind."""
    kind = kv_kind_of(k_q.dtype)
    code = _build.decode_dtype_code(k_new, f"{entry} new rows")
    _build.require(k_new, "k_new", tuple(k_new.shape), k_new.dtype)
    _build.require(v_new, "v_new", tuple(k_new.shape), k_new.dtype)
    _build.require(k_q, "k_q", tuple(k_q.shape), k_q.dtype)
    _build.require(v_q, "v_q", tuple(k_q.shape), k_q.dtype)
    _build.require(k_s, "k_s", tuple(k_s.shape), torch.float32)
    _build.require(v_s, "v_s", tuple(k_s.shape), torch.float32)
    _build.require(pos, "pos", (k_new.shape[0],), torch.int32)
    ptrs = [k_new.data_ptr(), v_new.data_ptr(), k_q.data_ptr(),
            k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr()]
    if table is not None:
        _build.require(table, "table", tuple(table.shape), torch.int32)
        ptrs.append(table.data_ptr())
    ptrs.append(pos.data_ptr())
    rc = getattr(_build.library(), f"apex_tpu_torch_{entry}")(
        *ptrs, *dims, code, _build.KV_KIND_CODES[kind], _build.stream())
    _build.check(rc, entry)
    counted.launches += 1


def write_column_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s, pos,
                             kind: Optional[str] = None) -> None:
    """Plain twin of ``_write_kernel_quant``: the rows ``[b, h, d]``
    quantized by :func:`quantize_kv_rows`, data and scale at column
    ``pos[b]`` of the four planes, IN PLACE."""
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "write_column_quant")
    _quant_columns_plain(k_new[:, :, None], v_new[:, :, None], k_q, k_s,
                         v_q, v_s, pos, clamp=False)


def write_column_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos,
                       kind: Optional[str] = None) -> None:
    """Quantize ``k_new/v_new [b, h, d]`` per head row and write each row's
    data into column ``pos[b]`` of ``k_q/v_q [b, h, S, d]`` (int8 or fp8)
    and its fp32 scale into ``k_s/v_s [b, h, S]``, IN PLACE (JAX's
    ``_write_column_quant``). ``kind`` may name the storage, which must
    then match the planes'. CUDA tensors launch the kernel (counted in
    ``write_column_quant.launches``), CPU tensors run the plain
    version."""
    b, h, sk, d = _check_geometry(k_new, k_q, v_q, pos)
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "write_column_quant")
    if not _build.on_cuda(k_new, v_new, k_q, k_s, v_q, v_s, pos):
        write_column_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s, pos)
        return
    _launch_quant_write("decode_write_column_quant", write_column_quant,
                        k_new, v_new, k_q, k_s, v_q, v_s, pos, None,
                        (b, h, sk, d))


write_column_quant.launches = 0


def cache_write_columns_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s, pos,
                                    kind: Optional[str] = None) -> None:
    """Plain twin of ``_write_cols_kernel_quant``: lane ``j`` of row ``b``
    quantized and written at column ``min(pos[b] + j, S - 1)`` of the four
    planes, IN PLACE; of the lanes clamped onto ``S - 1`` the row's last
    one wins, in the data and the scale plane alike."""
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "cache_write_columns_quant")
    _quant_columns_plain(k_new, v_new, k_q, k_s, v_q, v_s, pos, clamp=True)


def cache_write_columns_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos,
                              kind: Optional[str] = None) -> None:
    """:func:`cache_write_columns` over the quantized planes: each of the
    T rows of ``k_new/v_new [b, h, T, d]`` is quantized and lands as one
    data column and one scale column at ``pos[b] + j``, lanes past the
    horizon clamped onto column ``S - 1``, IN PLACE. CUDA tensors launch
    the kernel (counted in ``cache_write_columns_quant.launches``), CPU
    tensors run the plain version."""
    if k_new.ndim != 4 or v_new.shape != k_new.shape:
        raise ValueError(f"expected new [b, h, T, d], got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    b, h, t, d = k_new.shape
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "cache_write_columns_quant")
    sk = k_q.shape[2]
    if k_q.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(f"planes {tuple(k_q.shape)} / pos "
                         f"{tuple(pos.shape)} inconsistent with new "
                         f"{tuple(k_new.shape)}")
    if not _build.on_cuda(k_new, v_new, k_q, k_s, v_q, v_s, pos):
        cache_write_columns_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s,
                                        pos)
        return
    _launch_quant_write("cache_write_columns_quant",
                        cache_write_columns_quant, k_new, v_new, k_q, k_s,
                        v_q, v_s, pos, None, (b, h, t, sk, d))


cache_write_columns_quant.launches = 0


def paged_write_column_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s, table,
                                   pos, kind: Optional[str] = None) -> None:
    """Plain twin of ``_paged_write_kernel_quant``: the quantized row and
    its scale at ``(table[b, pos // P], pos % P)`` of the pools, IN PLACE
    (a position outside the horizon is not written)."""
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "paged_write_column_quant")
    _quant_columns_plain(k_new[:, :, None], v_new[:, :, None], k_q, k_s,
                         v_q, v_s, pos, table=table, clamp=False)


def paged_write_column_quant(k_new, v_new, k_q, k_s, v_q, v_s, table, pos,
                             kind: Optional[str] = None) -> None:
    """:func:`paged_write_column` over the quantized pools ``k_q/v_q
    [num_pages, h, P, d]`` and ``k_s/v_s [num_pages, h, P]``: the rows
    ``[b, h, d]`` are quantized and land at ``(table[b, pos // P], pos %
    P)``, IN PLACE. CUDA tensors launch the kernel (counted in
    ``paged_write_column_quant.launches``), CPU tensors run the plain
    version."""
    b, h, n, p, mp, d = _check_paged(k_new, k_q, v_q, table, pos)
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "paged_write_column_quant")
    if not _build.on_cuda(k_new, v_new, k_q, k_s, v_q, v_s, table, pos):
        paged_write_column_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s,
                                       table, pos)
        return
    _launch_quant_write("paged_write_column_quant", paged_write_column_quant,
                        k_new, v_new, k_q, k_s, v_q, v_s, pos, table,
                        (b, h, p, mp, d))


paged_write_column_quant.launches = 0


def paged_write_columns_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s,
                                    table, pos,
                                    kind: Optional[str] = None) -> None:
    """Plain twin of ``_paged_write_cols_kernel_quant``: lane ``j`` of row
    ``b`` quantized at logical column ``min(pos[b] + j, max_pages * P -
    1)`` through the table, IN PLACE; where lanes collide the last one
    (row major over (b, j)) wins, data and scale alike."""
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "paged_write_columns_quant")
    _quant_columns_plain(k_new, v_new, k_q, k_s, v_q, v_s, pos, table=table,
                         clamp=True)


def paged_write_columns_quant(k_new, v_new, k_q, k_s, v_q, v_s, table, pos,
                              kind: Optional[str] = None) -> None:
    """:func:`paged_write_columns` over the quantized pools: each lane of
    ``k_new/v_new [b, h, T, d]`` is quantized and lands at logical column
    ``pos[b] + j`` through ``table``, lanes past the row's horizon
    clamped onto its last column, IN PLACE. CUDA tensors launch the
    kernel (counted in ``paged_write_columns_quant.launches``), CPU
    tensors run the plain version."""
    b, h, n, p, mp, d = _check_paged(k_new, k_q, v_q, table, pos,
                                     multi=True)
    t = k_new.shape[2]
    _check_quant_planes(k_new, k_q, k_s, v_q, v_s, kind,
                        "paged_write_columns_quant")
    if not _build.on_cuda(k_new, v_new, k_q, k_s, v_q, v_s, table, pos):
        paged_write_columns_quant_plain(k_new, v_new, k_q, k_s, v_q, v_s,
                                        table, pos)
        return
    _launch_quant_write("paged_write_columns_quant",
                        paged_write_columns_quant, k_new, v_new, k_q, k_s,
                        v_q, v_s, pos, table, (b, h, t, p, mp, d))


paged_write_columns_quant.launches = 0


def attend_cache_quant_plain(q, k_q, k_s, v_q, v_s, pos, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``_attn_kernel_quant``: fp32 scores ``(q . k_int) *
    s_k * scale`` and probabilities folded with ``s_v`` before the
    product with ``v_int``; every column past ``pos`` — its data and its
    scale — is replaced by zero BEFORE any product (stale fp8 bytes and
    scales can be NaN)."""
    b, h, sk, d = _check_geometry(q, k_q, v_q, pos)
    s_ = float(scale) if scale is not None else 1.0 / d ** 0.5
    col = torch.arange(sk, device=q.device)
    valid = (col[None] <= pos.to(q.device, torch.long)[:, None])[:, None]
    zero = torch.zeros((), device=q.device)
    kf = torch.where(valid[..., None], k_q.float(), zero)
    vf = torch.where(valid[..., None], v_q.float(), zero)
    ks = torch.where(valid, k_s, zero)
    vs = torch.where(valid, v_s, zero)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * ks * s_
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bhs,bhsd->bhd", p * vs, vf)
    return (out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _launch_quant_read(entry: str, counted, q, k_q, k_s, v_q, v_s, pos,
                       table, dims, horizon, scale) -> torch.Tensor:
    """Check the operands of a quantized read and launch ``entry``, the
    ``horizon`` in :func:`read_splits` ``(horizon, d)`` splits."""
    kind = kv_kind_of(k_q.dtype)
    code = _build.decode_dtype_code(q, f"{entry} q")
    _check_head_dim(q.shape[-1], entry)
    _build.require(q, "q", tuple(q.shape), q.dtype)
    _build.require(k_q, "k_q", tuple(k_q.shape), k_q.dtype)
    _build.require(v_q, "v_q", tuple(k_q.shape), k_q.dtype)
    _build.require(k_s, "k_s", tuple(k_s.shape), torch.float32)
    _build.require(v_s, "v_s", tuple(k_s.shape), torch.float32)
    _build.require(pos, "pos", (q.shape[0],), torch.int32)
    ptrs = [q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr()]
    if table is not None:
        _build.require(table, "table", tuple(table.shape), torch.int32)
        ptrs.append(table.data_ptr())
    out = torch.empty_like(q)
    ptrs += [pos.data_ptr(), out.data_ptr()]
    s_ = float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5
    rc = getattr(_build.library(), f"apex_tpu_torch_{entry}")(
        *ptrs, *dims, s_, code, _build.KV_KIND_CODES[kind],
        *read_splits(horizon, q.shape[-1]), _build.stream())
    _build.check(rc, entry)
    counted.launches += 1
    return out


def attend_cache_quant(q, k_q, k_s, v_q, v_s, pos, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``out [b, h, d]``: each (batch, head) row of ``q`` attends over
    columns ``0..pos[b]`` of the quantized planes ``k_q/v_q [b, h, S, d]``
    (int8 or fp8) with fp32 scales ``k_s/v_s [b, h, S]``, the scales
    folded into the scores and the probabilities (JAX's
    ``_run_attn_quant``). CUDA tensors launch the split read over the
    quantized rows, the horizon ``S`` in :func:`read_splits` ``(S, d)``
    splits as :func:`attend_cache`'s (counted in
    ``attend_cache_quant.launches``), CPU tensors run the plain
    version."""
    b, h, sk, d = _check_geometry(q, k_q, v_q, pos)
    _check_quant_planes(q, k_q, k_s, v_q, v_s, None, "attend_cache_quant")
    if not _build.on_cuda(q, k_q, k_s, v_q, v_s, pos):
        return attend_cache_quant_plain(q, k_q, k_s, v_q, v_s, pos,
                                        scale=scale)
    return _launch_quant_read("decode_attention_quant", attend_cache_quant,
                              q, k_q, k_s, v_q, v_s, pos, None, (b, h, sk, d),
                              sk, scale)


attend_cache_quant.launches = 0


def decode_attention_quantized_plain(q, k_new, v_new, k_q, k_scale, v_q,
                                     v_scale, pos, *,
                                     kind: Optional[str] = None,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain twin of :func:`decode_attention_quantized` (writes the
    column too)."""
    write_column_quant_plain(k_new, v_new, k_q, k_scale, v_q, v_scale, pos,
                             kind)
    return attend_cache_quant_plain(q, k_q, k_scale, v_q, v_scale, pos,
                                    scale=scale)


def decode_attention_quantized(q, k_new, v_new, k_q, k_scale, v_q, v_scale,
                               pos, *, kind: Optional[str] = None,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """:func:`decode_attention` over the quantized cache: ``k_new/v_new
    [b, h, d]`` are quantized (:func:`quantize_kv_rows`) into column
    ``pos[b]`` of ``k_q/v_q [b, h, S, d]`` and ``k_scale/v_scale [b, h,
    S]`` IN PLACE — where the JAX function returns the new planes — and
    ``q`` attends over ``0..pos[b]`` with the scales folded into the fp32
    scores and probabilities. Whatever the planes hold past ``pos``, NaN
    bit patterns included, never reaches the output."""
    write_column_quant(k_new, v_new, k_q, k_scale, v_q, v_scale, pos, kind)
    return attend_cache_quant(q, k_q, k_scale, v_q, v_scale, pos,
                              scale=scale)


def paged_gather_planes(plane, table) -> torch.Tensor:
    """:func:`paged_gather_xla` for any plane — ``[num_pages, h, P, d]``
    data of any dtype (one-byte storage gathered as bytes) or ``[num_pages,
    h, P]`` scales — under ``table [b, max_pages]`` → the row-contiguous
    ``[b, h, max_pages * P(, d)]``."""
    if plane.ndim == 3:
        return paged_gather_xla(plane[..., None], table)[..., 0]
    return paged_gather_xla(_bytes(plane), table).view(plane.dtype)


def paged_attention_quantized_plain(q, k_q, k_s, v_q, v_s, table, pos, *,
                                    kind: Optional[str] = None,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain twin of ``_paged_attn_kernel_quant``: the rows' pages of all
    four planes gathered into the contiguous view, then
    :func:`attend_cache_quant_plain`."""
    _check_paged(q, k_q, v_q, table, pos)
    _check_quant_planes(q, k_q, k_s, v_q, v_s, kind,
                        "paged_attention_quantized")
    g = lambda x: paged_gather_planes(x, table)
    return attend_cache_quant_plain(q, g(k_q), g(k_s), g(v_q), g(v_s), pos,
                                    scale=scale)


def paged_attention_quantized(q, k_q, k_s, v_q, v_s, table, pos, *,
                              kind: Optional[str] = None,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """:func:`paged_attention` over the quantized pools ``k_q/v_q
    [num_pages, h, P, d]`` (int8 or fp8) and ``k_s/v_s [num_pages, h,
    P]`` (fp32): the contiguous quantized read with column ``c`` (its
    row and its two scales) copied from page ``table[b, c // P]``, the
    horizon ``max_pages * P`` in :func:`read_splits` splits, so on the
    same bytes at the same horizon it returns the contiguous kernel's
    bits. CUDA tensors launch the kernel (counted in
    ``paged_attention_quantized.launches``), CPU tensors run the plain
    version."""
    b, h, n, p, mp, d = _check_paged(q, k_q, v_q, table, pos)
    _check_quant_planes(q, k_q, k_s, v_q, v_s, kind,
                        "paged_attention_quantized")
    if not _build.on_cuda(q, k_q, k_s, v_q, v_s, table, pos):
        return paged_attention_quantized_plain(q, k_q, k_s, v_q, v_s, table,
                                               pos, scale=scale)
    return _launch_quant_read("paged_attention_quant",
                              paged_attention_quantized, q, k_q, k_s, v_q,
                              v_s, pos, table, (b, h, p, mp, d), mp * p,
                              scale)


paged_attention_quantized.launches = 0
