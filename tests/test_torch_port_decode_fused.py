"""apex_tpu_torch's fused decode step on the CPU: ``decode_attention`` and
``paged_decode_attention``, the single-column write (rows 7 and 13) inside
the launch of the split read (rows 10 and 17).

Oracles:

- the plain twins (the write, then the read) against JAX's
  ``decode_attention`` (``_write_column`` + ``_run_attn``) and JAX's
  ``paged_write_column`` + ``paged_attention``, in interpret mode, at head
  widths 64 and 80 in fp32 and bf16 over a horizon of 200 columns (7
  splits of ``read_splits``, the last one short), pages of 8, positions
  on the splits' edges (0, a split's last column and the next one's
  first, the horizon's last), NaN past every position, in every unmapped
  page and in the sink: the caches and pools equal JAX's bit for bit (NaN
  cells included), ``out`` within ``test_torch_port_decode_split.py``'s
  TOL, and the paged output equal to the contiguous one bit for bit;
- with the kernel library and the device faked, so that the wrappers'
  CUDA branch runs here: a compute-dtype ``gpt.decode_step`` (contiguous
  and paged) calls the fused entry once a layer, with the new rows'
  pointers, that layer's cache planes and ``read_splits``' geometry, and
  never the stand-alone write or read entries; the int8 step still calls
  its write and read entries once a layer each and no fused entry;
- the fused entries' ctypes declarations: their argument lists, and the
  same count and kinds as the C entries in ``csrc/decode_attention.cu``.
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

jda = importlib.import_module("apex_tpu.kernels.decode_attention")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
#: as test_torch_port_decode_split.py's TOL: fp32 summation order; bf16
#: JAX rounds P to bf16 before P.V, the port's twin does not
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
WIDTHS = [64, 80]
B, H, S, PG = 5, 2, 200, 8
MP, N = S // PG, 5 * (S // PG) + 1


def _np(t):
    return t.detach().float().cpu().numpy()


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _positions(d):
    """The split edges of ``read_splits(S, d)``: the first column, a
    split's last and the next one's first, and the horizon's last."""
    cols, _ = tda.read_splits(S, d)
    return np.asarray([0, cols - 1, cols, 2 * cols - 1, S - 1], np.int32)


# ---------------------------------------------------------------------------
# the plain twins against JAX's Pallas write and read (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_steps():
    """{(d, dtype): (port, JAX)}, each (out, K, V, paged out, K pool, V
    pool) after one decode step over the same bytes: the contiguous caches
    NaN past every position, and a pool of N pages of PG holding the same
    rows through a random table, every other cell (the sink page 0 among
    them) NaN."""
    out = {}
    for d in WIDTHS:
        pos_np = _positions(d)
        for dtype in DTYPES:
            rng = np.random.default_rng(19 + d)
            stale = (np.arange(S)[None] > pos_np[:, None])[:, None, :, None]
            kc, vc = (np.where(stale, np.nan, rng.standard_normal(
                (B, H, S, d))) for _ in range(2))
            table = rng.permutation(np.arange(1, N))[:B * MP].reshape(
                B, MP).astype(np.int32)
            pools = []
            for c in (kc, vc):
                pool = np.full((N, H, PG, d), np.nan)
                pool[table] = c.reshape(B, H, MP, PG, d).transpose(
                    0, 2, 1, 3, 4)
                pools.append(pool)
            (qj, qt), (knj, knt), (vnj, vnt) = (
                _pair(rng.standard_normal((B, H, d)), dtype)
                for _ in range(3))
            (kcj, kct), (vcj, vct) = _pair(kc, dtype), _pair(vc, dtype)
            (kpj, kpt), (vpj, vpt) = (_pair(p, dtype) for p in pools)
            pos_j, pos_t = jnp.asarray(pos_np), torch.from_numpy(pos_np)
            tbl_j, tbl_t = jnp.asarray(table), torch.from_numpy(table)
            want, kj, vj = jda.decode_attention(qj, knj, vnj, kcj, vcj, pos_j)
            kpj, vpj = jda.paged_write_column(knj, vnj, kpj, vpj, tbl_j,
                                              pos_j)
            pwant = jda.paged_attention(qj, kpj, vpj, tbl_j, pos_j)
            got = tda.decode_attention(qt, knt, vnt, kct, vct, pos_t)
            pgot = tda.paged_decode_attention(qt, knt, vnt, kpt, vpt, tbl_t,
                                              pos_t)
            out[d, dtype] = ((got, kct, vct, pgot, kpt, vpt),
                             (want, kj, vj, pwant, kpj, vpj))
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_fused_plain_twins_match_jax_on_split_edges(fused_steps, d, dtype,
                                                    paged):
    """``decode_attention`` / ``paged_decode_attention`` (their plain twins
    here) at positions on the splits' edges: the caches (pools) equal
    JAX's write bit for bit, every cell outside the written columns
    included; ``out`` finite, in the rows' dtype and within TOL of JAX's
    read; the paged output bit-equal to the contiguous one."""
    port, jax_ = fused_steps[d, dtype]
    i = 3 if paged else 0
    got, kt, vt = port[i:i + 3]
    want, kj, vj = jax_[i:i + 3]
    for t, j in ((kt, kj), (vt, vj)):
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    assert got.shape == (B, H, d) and got.dtype == DTYPES[dtype][1]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    assert torch.equal(port[3], port[0])


# ---------------------------------------------------------------------------
# the model's decode step, with the library and the device faked
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
#: the stand-alone decode entries a compute-dtype step no longer calls
ALONE = ("decode_write_column", "decode_attention", "paged_write_column",
         "paged_attention")
FUSED = ("decode_attention_write", "paged_attention_write")


def _step(kind: str, paged: bool):
    """One ``gpt.decode_step`` of 2 rows (positions 5 and 63) over a cache
    of horizon 64, contiguous or in a pool of 17 pages of 8 through a
    table: returns the config, the cache, the table and pos."""
    cfg = tgpt.GPTConfig(**SMALL, kv_cache_dtype=kind)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, page = 2, 8
    pos = torch.tensor([5, 63], dtype=torch.int32)
    tok = torch.tensor([3, 7])
    if paged:
        mp = cfg.seq_len // page
        table = (torch.randperm(b * mp, generator=torch.Generator()
                                .manual_seed(1)) + 1).to(torch.int32).view(
            b, mp)
        cache = tgpt.init_cache(cfg, params, b * mp + 1, page)
    else:
        table = None
        cache = tgpt.init_cache(cfg, params, b, cfg.seq_len)
    tgpt.decode_step(cfg, params, cache, tok, pos, table)
    return cfg, cache, table, pos


@pytest.mark.parametrize("paged", [False, True])
def test_compute_decode_step_launches_the_fused_entry(fake_cuda, paged):
    """A compute-dtype decode step calls the fused entry once a layer:
    q, the new K and V rows (two buffers of their own), that layer's two
    cache planes, pos, out, the geometry, the scale, the fp32 code and
    ``read_splits``' split of the horizon, the stream last; it never
    calls a stand-alone write or read entry, and the fused wrapper counts
    a launch a layer."""
    before = {n: tk.KERNEL_WRAPPERS[n].launches for n in FUSED}
    cfg, cache, table, pos = _step("compute", paged)
    L, d, h = cfg.num_layers, cfg.head_dim, cfg.num_heads
    name = FUSED[paged]
    calls = fake_cuda.of(name)
    assert [n for n, _ in fake_cuda.calls] == [name] * L
    for n in ALONE:
        assert not fake_cuda.of(n), n
    assert tk.KERNEL_WRAPPERS[name].launches == before[name] + L
    other = FUSED[not paged]
    assert tk.KERNEL_WRAPPERS[other].launches == before[other]
    for l, args in enumerate(calls):
        k_plane, v_plane = cache[l, 0].data_ptr(), cache[l, 1].data_ptr()
        assert args[3:5] == (k_plane, v_plane), l
        new = set(args[1:3])
        assert len(new) == 2 and 0 not in new, l
        assert not new & {args[0], k_plane, v_plane}, l
        if paged:
            assert args[5] == table.data_ptr()
            dims, rest = args[8:13], args[13:]
            assert dims == (2, h, 8, table.shape[1], d)
            horizon = table.shape[1] * 8
        else:
            dims, rest = args[7:11], args[11:]
            assert dims == (2, h, cfg.seq_len, d)
            horizon = cfg.seq_len
        assert math.isclose(rest[0], 1.0 / math.sqrt(d))
        assert rest[1] == _build.DECODE_DTYPE_CODES[torch.float32]
        assert tuple(rest[2:4]) == tda.read_splits(horizon, d)
        assert rest[4] == 0 and len(rest) == 5


@pytest.mark.parametrize("paged", [False, True])
def test_int8_decode_step_keeps_its_write_and_read(fake_cuda, paged):
    """The int8 cache's step still writes with its quantizing kernel and
    then reads, once a layer each in that order, and never calls a fused
    or a compute-dtype decode entry."""
    cfg, _, _, _ = _step("int8", paged)
    pre = "paged_" if paged else "decode_"
    write, read = pre + "write_column_quant", pre + "attention_quant"
    assert [n for n, _ in fake_cuda.calls] == [write, read] * cfg.num_layers
    for n in FUSED + ALONE:
        assert not fake_cuda.of(n), n


# ---------------------------------------------------------------------------
# the entries' declarations
# ---------------------------------------------------------------------------

#: (pointers, index of d, of the dtype code, of the split geometry)
ENTRIES = {"decode_attention_write": (7, 10, 12, 13),
           "paged_attention_write": (8, 12, 14, 15)}
C_KINDS = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def _c_params(name: str):
    """The parameter types of ``extern "C" int apex_tpu_torch_<name>(...)``
    in ``csrc/decode_attention.cu``, as ``void*``, ``int`` or ``float``."""
    src = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    m = re.search(r'extern "C" int apex_tpu_torch_%s\(([^)]*)\)' % name,
                  src)
    assert m, name
    kinds = []
    for p in m[1].split(","):
        p = " ".join(p.split())
        kinds.append("void*" if "*" in p else p.rsplit(" ", 1)[0])
    return kinds


@pytest.mark.parametrize("name", list(ENTRIES))
def test_fused_entries_declare_their_arguments(name):
    """Each fused entry: the pointers (q, k_new, v_new, the two planes,
    the table when paged, pos, out), the ints of the geometry with d, the
    fp32 scale, the dtype code, the two ints of the split geometry and the
    stream, declared for ctypes as the C entry takes them."""
    n_ptr, i_d, i_code, i_split = ENTRIES[name]
    sig = _build._SIGNATURES[f"apex_tpu_torch_{name}"]
    assert len(sig) == i_split + 3
    assert all(a is ctypes.c_void_p for a in sig[:n_ptr])
    assert all(a is ctypes.c_int for a in sig[n_ptr:i_d + 1])
    assert sig[i_code - 1] is ctypes.c_float
    assert all(a is ctypes.c_int for a in sig[i_code:i_split + 2])
    assert sig[-1] is ctypes.c_void_p
    assert [C_KINDS[k] for k in _c_params(name)] == list(sig)
