"""apex_tpu_torch's split decode reads on the CPU: ``attend_cache`` (row
10), ``paged_attention`` (row 17), ``attend_cache_quant`` (row 12) and
``paged_attention_quantized`` (row 18), all four one split read.

Oracles:

- ``read_splits``, the geometry both wrappers hand their kernel: at
  horizons 1 to 16384 (and at ``max_pages * P`` with pages of 8 and 16)
  every column of ``[0, horizon)`` lies in exactly one split, no split
  is empty, a split's column count is a multiple of
  ``_build.READ_SPLIT_COLS`` and holds ``READ_SPLIT_MIN_VALUES`` values,
  and a row has at most ``_build.READ_MAX_SPLITS`` splits (one cluster);
- with the kernel library and the device faked, so that the wrappers'
  CUDA branch runs here: the four reads pass ``read_splits``' geometry
  after the dtype code (the quantized ones after the storage kind's code
  that follows it) and before the stream (the contiguous reads of ``S``
  and the paged reads of ``max_pages * P == S`` the same), count one
  launch a call, and never reach a plain twin; the C signatures say the
  same;
- the plain reads against JAX's ``_run_attn`` and ``paged_attention`` in
  interpret mode in fp32, bf16 and fp16 at d = 80 over a horizon of 200
  columns (7 splits, the last one short), positions on the splits' edges
  and NaN past every position, in every unmapped page and in the sink.
  Tolerances as in ``test_torch_port_decode_widths.py``: fp32 ``1e-5``;
  bf16 ``2e-2`` (JAX rounds P to bf16 before P.V, the port's twin does
  not); fp16 one fp16 ulp (JAX widens fp16 to fp32 and rounds the output
  once, as the twin does). The paged twin equals the contiguous one bit
  for bit on the same bytes;
- the quantized plain reads against JAX's ``_run_attn_quant`` and
  ``paged_attention_quantized`` in interpret mode over int8 and fp8
  planes with q in fp32, bf16 and fp16, at the same d, horizon and
  positions, with the stale byte (an fp8 NaN, or int8 -128) and a NaN
  scale past every position, in every unmapped page and in the sink:
  tolerances as above (fp32 and bf16 as in ``test_torch_port_quant.py``,
  fp16 as in ``test_torch_port_decode_widths.py``), and the paged twin
  bit-equal to the contiguous one.
"""

import ctypes
import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build

# the modules (both kernel packages re-export functions of these names)
jda = importlib.import_module("apex_tpu.kernels.decode_attention")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

HORIZONS = [1, 8, 31, 32, 192, 1024, 4096, 16384]
#: paged horizons as (max_pages, P): bench's 24 pages of 8, a horizon no
#: split count divides, and pages of 16
PAGED = [(24, 8), (25, 8), (64, 16), (13, 16)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2),
       "f16": dict(rtol=2.0 ** -10, atol=1e-6)}
KINDS = ["int8", "fp8"]
STORE = {"int8": (np.int8, torch.int8),
         "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}
#: a stale quantized cell: an fp8 NaN byte, or int8 -128 (never written)
STALE_BYTE = {"int8": 0x80, "fp8": 0x7F}


# ---------------------------------------------------------------------------
# the split geometry
# ---------------------------------------------------------------------------

def _hold_geometry(horizon, d):
    cols, n = tda.read_splits(horizon, d)
    assert cols > 0 and cols % _build.READ_SPLIT_COLS == 0
    assert cols * d >= tda.READ_SPLIT_MIN_VALUES
    assert 1 <= n <= _build.READ_MAX_SPLITS
    owners = np.zeros(horizon, np.int64)
    for s in range(n):
        lo, hi = s * cols, min((s + 1) * cols, horizon)
        assert lo < hi, f"split {s} of {n} is empty"
        owners[lo:hi] += 1
    assert (owners == 1).all()
    return cols, n


@pytest.mark.parametrize("d", [1, 80, 128])
@pytest.mark.parametrize("horizon", HORIZONS)
def test_read_splits_cover_the_horizon_once(horizon, d):
    """Every column of the horizon in exactly one non-empty split; the
    split a multiple of the kernel's sub-tile; at most one cluster of
    splits a row."""
    _hold_geometry(horizon, d)


@pytest.mark.parametrize("mp,page", PAGED)
def test_read_splits_over_paged_horizons(mp, page):
    """The paged read splits its horizon ``max_pages * P`` by the same
    rule, so at ``max_pages * P == S`` it splits as the contiguous read
    over ``S`` does (the premise of paged == contiguous bit for bit)."""
    cols, n = _hold_geometry(mp * page, 80)
    assert tda.read_splits(mp * page, 80) == (cols, n)


def test_read_splits_at_the_served_shapes():
    """The geometry at the two served decode shapes (8 splits of 128
    columns at the 2.7B's horizon 1024, 6 of 32 at the 355M's 192),
    narrow heads taking longer splits, and a bad horizon refused."""
    assert tda.read_splits(1024, 80) == (128, 8)
    assert tda.read_splits(192, 64) == (32, 6)
    assert tda.read_splits(192, 32) == (64, 3)
    assert tda.read_splits(200, 80) == (32, 7)
    with pytest.raises(ValueError, match="positive"):
        tda.read_splits(0, 80)


# ---------------------------------------------------------------------------
# the wrappers' CUDA branch, with the library and the device faked
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for the kernel library: records each entry called with
    its arguments, and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name[len("apex_tpu_torch_"):]] = args
            return 0
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: ``on_cuda`` says yes,
    the library records its calls, and every plain twin raises. The
    launch counters the faked launches move are put back afterwards
    (other tests in the process read them)."""
    lib = _FakeLibrary()
    for fn in tk.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain twin")

    for name in dir(tda):
        if name.endswith("_plain"):
            monkeypatch.setattr(tda, name, refuse)
    return lib


#: (index of d, of the dtype code, of the split geometry) in each read
#: entry's arguments (the quantized reads' storage kind code between the
#: dtype code and the geometry)
ARGS = {"decode_attention": (8, 10, 11), "paged_attention": (10, 12, 13),
        "decode_attention_quant": (10, 12, 14),
        "paged_attention_quant": (12, 14, 16)}
#: the reads' wrappers, by entry
READS = {"decode_attention": tda.attend_cache,
         "paged_attention": tda.paged_attention,
         "decode_attention_quant": tda.attend_cache_quant,
         "paged_attention_quant": tda.paged_attention_quantized}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("horizon,page,d", [(192, 8, 64), (200, 8, 80),
                                            (1024, 8, 80), (64, 16, 32),
                                            (16, 16, 100)])
def test_reads_pass_the_split_geometry(fake_cuda, horizon, page, d, dtype):
    """``attend_cache`` and ``attend_cache_quant`` over ``S == horizon``
    and ``paged_attention`` and ``paged_attention_quantized`` over
    ``max_pages * P == horizon`` each launch their entry once a call,
    counted, with ``read_splits(horizon, d)`` after the dtype code (the
    quantized reads after the storage kind's code, int8 and fp8) and the
    stream last; no call reaches a plain twin."""
    b, h, mp = 2, 3, horizon // page
    n = 2 * mp + 1
    pos = torch.zeros(b, dtype=torch.int32)
    table = torch.zeros(b, mp, dtype=torch.int32)
    q = torch.zeros(b, h, d, dtype=dtype)
    kc = torch.zeros(b, h, horizon, d, dtype=dtype)
    kp = torch.zeros(n, h, page, d, dtype=dtype)
    want = tda.read_splits(horizon, d)
    for kind in KINDS:
        st = STORE[kind][1]
        planes = [torch.zeros(b, h, horizon, d, dtype=st),
                  torch.zeros(b, h, horizon)] * 2
        pools = [torch.zeros(n, h, page, d, dtype=st),
                 torch.zeros(n, h, page)] * 2
        calls = {"decode_attention": lambda: tda.attend_cache(q, kc, kc,
                                                              pos),
                 "paged_attention": lambda: tda.paged_attention(
                     q, kp, kp, table, pos),
                 "decode_attention_quant": lambda: tda.attend_cache_quant(
                     q, *planes, pos),
                 "paged_attention_quant":
                     lambda: tda.paged_attention_quantized(q, *pools, table,
                                                           pos)}
        fake_cuda.calls.clear()
        for name, call in calls.items():
            before = READS[name].launches
            assert call().shape == (b, h, d), name
            assert READS[name].launches == before + 1, name
        assert set(fake_cuda.calls) == set(ARGS)
        for name, (i_d, i_code, i_split) in ARGS.items():
            args = fake_cuda.calls[name]
            assert (args[i_d], args[i_code]) == (
                d, _build.DECODE_DTYPE_CODES[dtype]), name
            if name.endswith("_quant"):
                assert args[i_code + 1] == _build.KV_KIND_CODES[kind], name
                assert i_split == i_code + 2, name
            assert tuple(args[i_split:i_split + 2]) == want, name
            assert args[-1] == 0 and len(args) == i_split + 3, name


def test_read_entries_declare_the_geometry():
    """The C signatures of the four reads: two ints (columns a split,
    splits a row) between the dtype code (the quantized reads: the
    storage kind's code after it) and the stream."""
    sig = _build._SIGNATURES
    for name, (i_d, i_code, i_split) in ARGS.items():
        args = sig[f"apex_tpu_torch_{name}"]
        assert len(args) == i_split + 3
        assert args[i_d] is args[i_code] is ctypes.c_int
        assert args[i_code - 1] is ctypes.c_float        # scale
        assert all(a is ctypes.c_int for a in args[i_code:i_split + 2])
        assert args[-1] is ctypes.c_void_p
    assert len(sig["apex_tpu_torch_decode_attention_quant"]) == 17
    assert len(sig["apex_tpu_torch_paged_attention_quant"]) == 19


# ---------------------------------------------------------------------------
# the plain reads against JAX's Pallas reads (interpret mode)
# ---------------------------------------------------------------------------

B, H, D, S, PG = 5, 2, 80, 200, 8
MP, N = S // PG, 5 * (S // PG) + 1
L, NSPLIT = tda.read_splits(S, D)
#: the split edges: the first column, a split's last and the next one's
#: first, and the horizon's last column
POS = np.asarray([0, L - 1, L, 2 * L - 1, S - 1], np.int32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


@pytest.fixture(scope="module")
def split_reads():
    """{dtype: (port contiguous, port paged, JAX contiguous, JAX paged)}
    over the same bytes: the contiguous cache with NaN past every
    position, and a pool of N pages of PG holding the same rows through a
    random table, every other cell (the sink page 0 among them) NaN."""
    out = {}
    for dtype in DTYPES:
        rng = np.random.default_rng(14)
        stale = (np.arange(S)[None] > POS[:, None])[:, None, :, None]
        kc, vc = (np.where(stale, np.nan, rng.standard_normal((B, H, S, D)))
                  for _ in range(2))
        table = rng.permutation(np.arange(1, N))[:B * MP].reshape(
            B, MP).astype(np.int32)
        pools = []
        for c in (kc, vc):
            pool = np.full((N, H, PG, D), np.nan)
            pool[table] = c.reshape(B, H, MP, PG, D).transpose(0, 2, 1, 3, 4)
            pools.append(pool)
        (qj, qt) = _pair(rng.standard_normal((B, H, D)), dtype)
        (kcj, kct), (vcj, vct) = _pair(kc, dtype), _pair(vc, dtype)
        (kpj, kpt), (vpj, vpt) = (_pair(p, dtype) for p in pools)
        # JAX's public read widens fp16 to fp32 at the kernel's boundary
        # and rounds the output once; so does this call of its kernel
        wide = (lambda x: x.astype(jnp.float32)) if dtype == "f16" else (
            lambda x: x)
        want = jda._run_attn(
            wide(qj).reshape(B * H, D), wide(kcj).reshape(B * H, S, D),
            wide(vcj).reshape(B * H, S, D), jnp.asarray(POS), 1.0 / D ** 0.5,
            H, None).reshape(B, H, D).astype(DTYPES[dtype][0])
        pwant = jda.paged_attention(qj, kpj, vpj, jnp.asarray(table),
                                    jnp.asarray(POS))
        pos = torch.from_numpy(POS)
        got = tda.attend_cache(qt, kct, vct, pos)
        pgot = tda.paged_attention(qt, kpt, vpt, torch.from_numpy(table),
                                   pos)
        out[dtype] = (got, pgot, want, pwant)
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_reads_match_jax_on_split_edges(split_reads, dtype, paged):
    """``attend_cache`` and ``paged_attention`` (their plain twins here)
    at d = 80 over a 200-column horizon, rows at the edges of
    ``read_splits``' splits: finite, in the rows' dtype, and within TOL
    of ``_run_attn`` / ``paged_attention`` in interpret mode; the paged
    twin equals the contiguous one bit for bit."""
    got, pgot, want, pwant = split_reads[dtype]
    g, w = (pgot, pwant) if paged else (got, want)
    assert g.shape == (B, H, D) and g.dtype == DTYPES[dtype][1]
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                               **TOL[dtype])
    assert torch.equal(pgot, got)


# ---------------------------------------------------------------------------
# the quantized plain reads against JAX's Pallas reads (interpret mode)
# ---------------------------------------------------------------------------

def _quant_pair(rng, kind, shape, stale):
    """The same quantized planes ``shape [n, h, cols, d]`` as JAX arrays
    and torch tensors: random rows through the port's quantizer, every
    cell where ``stale [n, h, cols]`` holds the stale byte and a NaN
    scale."""
    q, s = tda.quantize_kv_rows(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
        kind)
    raw = q.view(torch.uint8).numpy().copy()
    s = s.numpy().copy()
    raw[stale] = STALE_BYTE[kind]
    s[stale] = np.nan
    npd, td = STORE[kind]
    return ((jnp.asarray(raw.view(npd)), jnp.asarray(s)),
            (torch.from_numpy(raw).view(td), torch.from_numpy(s)))


@pytest.fixture(scope="module")
def quant_split_reads():
    """{(kind, dtype): (port contiguous, port paged, JAX contiguous, JAX
    paged)} over the same planes: the contiguous planes stale past every
    position, and a pool of N pages of PG holding the same cells through
    a random table, every other cell (the sink page 0 among them)
    stale."""
    out = {}
    for kind in KINDS:
        rng = np.random.default_rng(17)
        stale = np.broadcast_to(np.arange(S)[None, None] > POS[:, None, None],
                                (B, H, S))
        table = rng.permutation(np.arange(1, N))[:B * MP].reshape(
            B, MP).astype(np.int32)
        live = np.zeros((N, H, PG), bool)
        live[table] = ~stale.reshape(B, H, MP, PG).transpose(0, 2, 1, 3)
        planes, pools = [], []
        for _ in range(2):
            shape = (B, H, S, D)
            (jq, js), (tq, ts) = _quant_pair(rng, kind, shape, stale)
            planes += [(jq, tq), (js, ts)]
            # the pool: the same cells through the table, the rest stale
            raw = np.full((N, H, PG, D), STALE_BYTE[kind], np.uint8)
            sc = np.full((N, H, PG), np.nan, np.float32)
            raw[table] = tq.view(torch.uint8).numpy().reshape(
                B, H, MP, PG, D).transpose(0, 2, 1, 3, 4)
            sc[table] = ts.numpy().reshape(B, H, MP, PG).transpose(0, 2, 1, 3)
            assert not np.isnan(sc[live]).any()
            npd, td = STORE[kind]
            pools += [(jnp.asarray(raw.view(npd)),
                       torch.from_numpy(raw).view(td)),
                      (jnp.asarray(sc), torch.from_numpy(sc))]
        jp, tp = [x[0] for x in planes], [x[1] for x in planes]
        jpool, tpool = [x[0] for x in pools], [x[1] for x in pools]
        pos = torch.from_numpy(POS)
        for dtype in DTYPES:
            qj, qt = _pair(rng.standard_normal((B, H, D)), dtype)
            # JAX's public reads widen fp16 q to fp32 and round the output
            # once; so does this call of its contiguous kernel
            qw = qj.astype(jnp.float32) if dtype == "f16" else qj
            want = jda._run_attn_quant(
                qw.reshape(B * H, D), jp[0].reshape(B * H, S, D),
                jp[1].reshape(B * H, S), jp[2].reshape(B * H, S, D),
                jp[3].reshape(B * H, S), jnp.asarray(POS), 1.0 / D ** 0.5,
                H, None).reshape(B, H, D).astype(DTYPES[dtype][0])
            pwant = jda.paged_attention_quantized(
                qj, *jpool, jnp.asarray(table), jnp.asarray(POS), kind=kind)
            got = tda.attend_cache_quant(qt, *tp, pos)
            pgot = tda.paged_attention_quantized(
                qt, *tpool, torch.from_numpy(table), pos, kind=kind)
            out[kind, dtype] = (got, pgot, want, pwant)
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_plain_reads_match_jax_on_split_edges(
        quant_split_reads, kind, dtype, paged):
    """``attend_cache_quant`` and ``paged_attention_quantized`` (their
    plain twins here) at d = 80 over a 200-column horizon of int8 or fp8
    planes, rows at the edges of ``read_splits``' splits, stale bytes and
    NaN scales past every position, in unmapped pages and in the sink:
    finite, in q's dtype, and within TOL of ``_run_attn_quant`` /
    ``paged_attention_quantized`` in interpret mode; the paged twin
    equals the contiguous one bit for bit."""
    got, pgot, want, pwant = quant_split_reads[kind, dtype]
    g, w = (pgot, pwant) if paged else (got, want)
    assert g.shape == (B, H, D) and g.dtype == DTYPES[dtype][1]
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                               **TOL[dtype])
    assert torch.equal(pgot, got)
