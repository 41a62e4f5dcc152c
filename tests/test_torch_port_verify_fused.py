"""apex_tpu_torch's speculative verify on the CPU: ``decode_verify_attention``
and ``paged_verify_attention``, the multi-column write (rows 8 and 15)
inside one launch of a T-row split read.

Oracles:

- the plain twins (the write, then every query row through the single
  read's plain twin at ``pos + t``) against JAX's kernel-impl verify
  attention (``gpt._decode_attend_multi`` / ``_paged_attend_multi``: the
  Pallas ``cache_write_columns`` / ``paged_write_columns`` in interpret
  mode, then the materialised read), at head widths 64 and 80 in fp32 and
  bf16 with T 4 and 8, over a horizon of 200 columns (7 splits of
  ``read_splits``, the last one short), pages of 8, positions on the
  splits' edges and past the horizon (the clamp onto its last column),
  NaN past every position, in every unmapped page and in the sink: the
  caches and pools equal JAX's bit for bit (NaN cells included), ``out``
  the same bits over NaN cells as over finite ones and within
  ``test_torch_port_decode_split.py``'s TOL of JAX's over the finite ones
  (JAX's read multiplies P by V, so a NaN cell reaches its ``out``), and
  the paged output equal to the contiguous one bit for bit; each query row
  of the plain verify bit for bit the single read's plain twin at ``pos +
  t``;
- ``verify_route`` and the row bounds against ``csrc/decode_common.cuh``;
- with the kernel library and the device faked, so that the wrappers'
  CUDA branch runs here: a compute-dtype ``gpt.decode_verify`` (contiguous
  and paged) calls the verify entry once a layer, with the new rows'
  pointers, that layer's planes and ``read_splits``' geometry, and never
  the stand-alone multi-column writes nor any decode-step entry; T past
  the route's maximum calls the write entry and no verify entry; the int8
  verify still calls its quantizing write and no verify entry;
- the verify entries' ctypes declarations against their C parameter
  lists.
"""

import ctypes
import importlib
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build
from apex_tpu_torch.models import gpt as tgpt

jgpt = importlib.import_module("apex_tpu.models.gpt")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
#: as test_torch_port_decode_split.py's TOL: fp32 summation order; bf16
#: JAX rounds q * scale and P to bf16, the port's twin does not
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
WIDTHS = [64, 80]
ROWS = [4, 8]
B, H, S, PG = 6, 2, 200, 8
MP, N = S // PG, 6 * (S // PG) + 1


def _np(t):
    return t.detach().float().cpu().numpy()


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _positions(d, t):
    """Positions whose T lanes touch the edges of ``read_splits(S, d)``:
    column 0, lanes across a split's last column and the next one's first,
    a split's last and its next split's first column, the horizon's last
    columns (lanes clamped onto S - 1) and a position past the horizon
    (only lane T - 1 lands, on S - 1; every query row reads all S)."""
    cols, _ = tda.read_splits(S, d)
    return np.asarray([0, cols - t // 2, 2 * cols - 1, 3 * cols, S - 2,
                       S + 1], np.int32)


def _jax_cfg(d, dtype):
    return jgpt.GPTConfig(vocab_size=64, hidden_size=H * d, num_layers=1,
                          num_heads=H, seq_len=S, remat=False,
                          compute_dtype=DTYPES[dtype][0],
                          decode_attn_impl="kernel")


# ---------------------------------------------------------------------------
# the plain twins against JAX's kernel-impl verify attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def verify_layers():
    """{(d, dtype, T): {stale: (port, JAX), "q": q}}: each side (out, K, V,
    paged out, K pool, V pool) after one verify over the same bytes, the
    contiguous caches holding ``stale`` past every position ("nan": NaN;
    "finite": other normal draws) and a pool of N pages of PG holding the
    same rows through a random table, every other cell (the sink page 0
    among them) NaN. JAX's materialised read multiplies P by V, so its
    ``out`` is NaN over NaN cells: only the finite run's is compared."""
    out = {}
    for d in WIDTHS:
        for t in ROWS:
            pos_np = _positions(d, t)
            for dtype in DTYPES:
                rng = np.random.default_rng(20 + d + t)
                live = (np.arange(S)[None] <= pos_np[:, None])[
                    :, None, :, None]
                kc, vc, kg, vg = (rng.standard_normal((B, H, S, d))
                                  for _ in range(4))
                table = rng.permutation(np.arange(1, N))[:B * MP].reshape(
                    B, MP).astype(np.int32)
                (qj, qt), (knj, knt), (vnj, vnt) = (
                    _pair(rng.standard_normal((B, H, t, d)), dtype)
                    for _ in range(3))
                pos_j, pos_t = jnp.asarray(pos_np), torch.from_numpy(pos_np)
                tbl_j, tbl_t = jnp.asarray(table), torch.from_numpy(table)
                cfg = _jax_cfg(d, dtype)
                runs = {"q": qt}
                for stale in ("nan", "finite"):
                    caches = [np.where(live, c, np.nan if stale == "nan"
                                       else g)
                              for c, g in ((kc, kg), (vc, vg))]
                    pools = []
                    for c in caches:
                        pool = np.full((N, H, PG, d), np.nan)
                        pool[table] = c.reshape(B, H, MP, PG, d).transpose(
                            0, 2, 1, 3, 4)
                        pools.append(pool)
                    (kcj, kct), (vcj, vct) = (_pair(c, dtype) for c in caches)
                    (kpj, kpt), (vpj, vpt) = (_pair(p, dtype) for p in pools)
                    want, kv = jgpt._decode_attend_multi(
                        cfg, qj, knj, vnj, jnp.stack([kcj, vcj]), pos_j)
                    pwant, pkv = jgpt._paged_attend_multi(
                        cfg, qj, knj, vnj, jnp.stack([kpj, vpj]), pos_j,
                        tbl_j)
                    got = tda.decode_verify_attention(qt, knt, vnt, kct, vct,
                                                      pos_t)
                    pgot = tda.paged_verify_attention(qt, knt, vnt, kpt, vpt,
                                                      tbl_t, pos_t)
                    runs[stale] = ((got, kct, vct, pgot, kpt, vpt),
                                   (want, kv[0], kv[1], pwant, pkv[0],
                                    pkv[1]))
                out[d, dtype, t] = runs
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("t", ROWS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_verify_plain_twins_match_jax_on_split_edges(verify_layers, d, dtype,
                                                     t, paged):
    """``decode_verify_attention`` / ``paged_verify_attention`` (their
    plain twins here) with lanes across the splits' edges and past the
    horizon: the caches (pools) equal JAX's kernel write bit for bit,
    every cell outside the written columns and every NaN included; ``out``
    finite, in the rows' dtype, the same bits over NaN cells as over
    finite ones, and within TOL of JAX's materialised read (over the
    finite cells); the paged output bit-equal to the contiguous one."""
    runs = verify_layers[d, dtype, t]
    i = 3 if paged else 0
    for stale in ("nan", "finite"):
        port, jax_ = runs[stale]
        for x, j in zip(port[i + 1:i + 3], jax_[i + 1:i + 3]):
            np.testing.assert_array_equal(_np(x), np.asarray(j, np.float32))
        assert torch.equal(port[3], port[0])
    got, fin = runs["nan"][0][i], runs["finite"][0][i]
    assert got.shape == (B, H, t, d) and got.dtype == DTYPES[dtype][1]
    assert torch.isfinite(got).all() and torch.equal(got, fin)
    np.testing.assert_allclose(_np(fin),
                               np.asarray(runs["finite"][1][i], np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("t", ROWS)
def test_verify_rows_are_the_single_read_at_each_position(verify_layers, t):
    """Query row ``r`` of the contiguous plain verify is the single read's
    plain twin at ``pos + r`` over the written cache, bit for bit, rows
    past the horizon (every column) included."""
    d = 80
    runs = verify_layers[d, "bf16", t]
    got, kt, vt = runs["nan"][0][:3]
    q = runs["q"]
    pos = torch.from_numpy(_positions(d, t)).long()
    for r in range(t):
        want = tda.attend_cache_plain(q[:, :, r], kt, vt, pos + r)
        assert torch.equal(got[:, :, r], want), r


def test_verify_route_and_row_bounds_match_the_source():
    """T from 2 to VERIFY_MAX_ROWS takes the launch, T = 1 (the decode
    step's own launch) and past the maximum do not; the maximum (at least
    8, spec_k <= 7) and the short bound are ``kVerifyMaxRows`` and
    ``kVerifyShortRows`` of ``csrc/decode_common.cuh``."""
    src = (_build.CSRC_DIR / "decode_common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kVerify\w+) = (\d+);", src))
    assert int(consts["kVerifyMaxRows"]) == _build.VERIFY_MAX_ROWS >= 8
    assert int(consts["kVerifyShortRows"]) == _build.VERIFY_SHORT_ROWS
    assert [tk.verify_route(t) for t in range(11)] == (
        [False, False] + [True] * 7 + [False, False])


# ---------------------------------------------------------------------------
# the model's verify forward, with the library and the device faked
# ---------------------------------------------------------------------------

class _CallLog:
    """Stands in for the kernel library: logs every entry called, in
    order, with its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name[len("apex_tpu_torch_"):], args))
            return 0
        return entry

    def of(self, name):
        return [args for n, args in self.calls if n == name]


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: ``on_cuda`` says yes,
    the library logs its calls, and every plain twin raises. The launch
    counters the faked launches move are put back afterwards (other tests
    in the process read them)."""
    lib = _CallLog()
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


#: a 3-layer GPT with 2 heads of 80, every decode read through the kernels
SMALL = dict(vocab_size=64, hidden_size=160, num_layers=3, num_heads=2,
             seq_len=64, remat=False, compute_dtype=torch.float32,
             attn_impl="xla", ln_impl="xla", decode_attn_impl="kernel")
VERIFY = ("decode_verify_attention", "paged_verify_attention")
#: the entries a compute-dtype verify on the route no longer calls, and
#: the decode step's, which no verify calls
WRITES = ("cache_write_columns", "paged_write_columns")
STEP = ("decode_write_column", "decode_attention", "paged_write_column",
        "paged_attention", "decode_attention_write", "paged_attention_write")


def _verify(kind: str, paged: bool, t: int):
    """One ``gpt.decode_verify`` of T tokens for 2 rows (positions 5 and
    62, the second's lanes past the horizon of 64) over a cache of horizon
    64, contiguous or in a pool of 17 pages of 8 through a table: returns
    the config, the cache and the table."""
    cfg = tgpt.GPTConfig(**SMALL, kv_cache_dtype=kind)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, page = 2, 8
    pos = torch.tensor([5, 62], dtype=torch.int32)
    tokens = torch.arange(b * t).view(b, t) % cfg.vocab_size
    if paged:
        mp = cfg.seq_len // page
        table = (torch.randperm(b * mp, generator=torch.Generator()
                                .manual_seed(1)) + 1).to(torch.int32).view(
            b, mp)
        cache = tgpt.init_cache(cfg, params, b * mp + 1, page)
    else:
        table = None
        cache = tgpt.init_cache(cfg, params, b, cfg.seq_len)
    tgpt.decode_verify(cfg, params, cache, tokens, pos, table)
    return cfg, cache, table


@pytest.mark.parametrize("paged", [False, True])
def test_compute_verify_launches_the_verify_entry(fake_cuda, paged):
    """A compute-dtype verify of T = 4 calls the verify entry once a
    layer: q, the new K and V rows (three buffers of their own), that
    layer's two planes, pos, out, the geometry with T, the scale, the fp32
    code and ``read_splits``' split of the horizon, the stream last; it
    never calls a multi-column write or a decode-step entry, and the
    verify wrapper counts a launch a layer."""
    t = 4
    before = {n: tk.KERNEL_WRAPPERS[n].launches for n in VERIFY}
    cfg, cache, table = _verify("compute", paged, t)
    L, d, h = cfg.num_layers, cfg.head_dim, cfg.num_heads
    name = VERIFY[paged]
    assert [n for n, _ in fake_cuda.calls] == [name] * L
    for n in WRITES + STEP:
        assert not fake_cuda.of(n), n
    assert tk.KERNEL_WRAPPERS[name].launches == before[name] + L
    other = VERIFY[not paged]
    assert tk.KERNEL_WRAPPERS[other].launches == before[other]
    for l, args in enumerate(fake_cuda.of(name)):
        k_plane, v_plane = cache[l, 0].data_ptr(), cache[l, 1].data_ptr()
        assert args[3:5] == (k_plane, v_plane), l
        rows = set(args[:3])
        assert len(rows) == 3 and 0 not in rows, l
        assert not rows & {k_plane, v_plane}, l
        if paged:
            assert args[5] == table.data_ptr()
            dims, rest = args[8:14], args[14:]
            assert dims == (2, h, t, 8, table.shape[1], d)
            horizon = table.shape[1] * 8
        else:
            dims, rest = args[7:12], args[12:]
            assert dims == (2, h, t, cfg.seq_len, d)
            horizon = cfg.seq_len
        assert math.isclose(rest[0], 1.0 / math.sqrt(d))
        assert rest[1] == _build.DECODE_DTYPE_CODES[torch.float32]
        assert tuple(rest[2:4]) == tda.read_splits(horizon, d)
        assert rest[4] == 0 and len(rest) == 5


@pytest.mark.parametrize("paged", [False, True])
def test_verify_past_the_route_keeps_the_write(fake_cuda, paged):
    """T = VERIFY_MAX_ROWS + 1 takes the parent's pair: the multi-column
    write once a layer (its T in the call), then the materialised read,
    which launches nothing; no verify entry."""
    t = _build.VERIFY_MAX_ROWS + 1
    cfg, _, _ = _verify("compute", paged, t)
    write = WRITES[paged]
    assert [n for n, _ in fake_cuda.calls] == [write] * cfg.num_layers
    for args in fake_cuda.of(write):
        assert args[8 if paged else 7] == t


@pytest.mark.parametrize("paged", [False, True])
def test_int8_verify_keeps_its_quantized_write(fake_cuda, paged):
    """The int8 cache's verify still writes with its quantizing kernel,
    once a layer, and never calls a verify entry."""
    cfg, _, _ = _verify("int8", paged, 4)
    write = ("paged_" if paged else "cache_") + "write_columns_quant"
    assert [n for n, _ in fake_cuda.calls] == [write] * cfg.num_layers
    for n in VERIFY:
        assert not fake_cuda.of(n), n


# ---------------------------------------------------------------------------
# the entries' declarations
# ---------------------------------------------------------------------------

#: (pointers, index of d, of the dtype code, of the split geometry)
ENTRIES = {"decode_verify_attention": (7, 11, 13, 14),
           "paged_verify_attention": (8, 13, 15, 16)}
C_KINDS = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def _c_params(name: str):
    """The parameter types of ``extern "C" int apex_tpu_torch_<name>(...)``
    in ``csrc/decode_verify.cu``, as ``void*``, ``int`` or ``float``."""
    src = (_build.CSRC_DIR / "decode_verify.cu").read_text()
    m = re.search(r'extern "C" int apex_tpu_torch_%s\(([^)]*)\)' % name,
                  src)
    assert m, name
    kinds = []
    for p in m[1].split(","):
        p = " ".join(p.split())
        kinds.append("void*" if "*" in p else p.rsplit(" ", 1)[0])
    return kinds


@pytest.mark.parametrize("name", list(ENTRIES))
def test_verify_entries_declare_their_arguments(name):
    """Each verify entry: the pointers (q, k_new, v_new, the two planes,
    the table when paged, pos, out), the ints of the geometry with T and
    d, the fp32 scale, the dtype code, the two ints of the split geometry
    and the stream, declared for ctypes as the C entry takes them."""
    n_ptr, i_d, i_code, i_split = ENTRIES[name]
    sig = _build._SIGNATURES[f"apex_tpu_torch_{name}"]
    assert len(sig) == i_split + 3
    assert all(a is ctypes.c_void_p for a in sig[:n_ptr])
    assert all(a is ctypes.c_int for a in sig[n_ptr:i_d + 1])
    assert sig[i_code - 1] is ctypes.c_float
    assert all(a is ctypes.c_int for a in sig[i_code:i_split + 2])
    assert sig[-1] is ctypes.c_void_p
    assert [C_KINDS[k] for k in _c_params(name)] == list(sig)
