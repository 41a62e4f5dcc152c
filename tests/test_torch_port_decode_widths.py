"""apex_tpu_torch's decode reads at head widths other than 64, and fp16
serving, against the JAX package on the CPU.

Oracles:

- the four reads (``attend_cache`` through ``decode_attention``,
  ``paged_attention``, ``attend_cache_quant`` through
  ``decode_attention_quantized``, ``paged_attention_quantized``; their
  plain twins here) against JAX's Pallas reads in interpret mode at head
  widths 32, 80 and 128: fp32, bf16 and fp16 rows for the plain reads,
  int8 and fp8 planes with fp32 or bf16 q for the quantized ones, NaN
  (or the stale byte and a NaN scale) past every row's position, in every
  unmapped page and in the sink. Tolerances: fp32 ``1e-5``; bf16 ``2e-2``
  (JAX rounds P to bf16 before P.V, the port's twin does not); fp16 one
  fp16 ulp (JAX widens fp16 to fp32 and rounds the output once, as the
  twin does);
- a 2-layer GPT with 2 heads of 80 through the port's ``Engine`` +
  ``Scheduler`` in fp32 with ``decode_attn_impl="kernel"`` (the decode
  wrappers; their plain twins on the CPU): greedy streams equal JAX's
  ``generate`` token for token, contiguous, paged and int8; and in fp16
  (the compute-dtype cache) against JAX's fp16 ``generate``;
- with the kernel library and the device faked, so that the wrappers'
  CUDA branch runs here: every decode wrapper takes fp16 at d = 80 and
  passes the width and the fp16 code to its entry, no CUDA call reaches
  a plain twin, the reads refuse a width past ``HM_MAX_HEAD_DIM`` naming
  it, and ``_build.DTYPE_CODES`` still refuses fp16 (the LayerNorm,
  flat-op and fp32 flash wrappers widen it first).
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import Engine, EngineConfig, Request, Scheduler

# the modules (both kernel packages re-export functions of these names)
jda = importlib.import_module("apex_tpu.kernels.decode_attention")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

WIDTHS = [32, 80, 128]
KINDS = ["int8", "fp8"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2),
       "f16": dict(rtol=2.0 ** -10, atol=1e-6)}
STORE = {"int8": (np.int8, torch.int8),
         "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}
#: a stale quantized cell: an fp8 NaN byte, or int8 -128 (never written)
STALE_BYTE = {"int8": 0x80, "fp8": 0x7F}
B, H, S = 3, 2, 16                     # contiguous cache [B, H, S, d]
N, PG, MP = 13, 4, 4                   # pool of N pages of PG, MP a row
POS = np.asarray([0, 7, S - 1], np.int32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _table(rng):
    """Distinct pages 1..N-1 for every row, in random order."""
    return rng.permutation(np.arange(1, N))[:B * MP].reshape(B, MP).astype(
        np.int32)


def _live(table):
    """[N, PG] cells some row holds at or before its position."""
    live = np.zeros((N, PG), bool)
    for r in range(B):
        for c in range(POS[r] + 1):
            live[table[r, c // PG], c % PG] = True
    return live


# ---------------------------------------------------------------------------
# the reads against JAX's Pallas reads (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_reads():
    """{(d, dtype): (port outputs, JAX outputs)} of the contiguous write +
    read and the paged read, built once."""
    out = {}
    for d in WIDTHS:
        for dtype in DTYPES:
            rng = np.random.default_rng(d)
            stale = (np.arange(S)[None] > POS[:, None])[:, None, :, None]
            kc, vc = (np.where(stale, np.nan, rng.standard_normal(
                (B, H, S, d))) for _ in range(2))
            (kcj, kct), (vcj, vct) = _pair(kc, dtype), _pair(vc, dtype)
            (qj, qt), (knj, knt), (vnj, vnt) = (
                _pair(rng.standard_normal((B, H, d)), dtype)
                for _ in range(3))
            want, kj, vj = jda.decode_attention(qj, knj, vnj, kcj, vcj,
                                                jnp.asarray(POS))
            got = tda.decode_attention(qt, knt, vnt, kct, vct,
                                       torch.from_numpy(POS))
            table = _table(rng)
            stale = ~_live(table)[:, None, :, None]
            kp, vp = (np.where(stale, np.nan, rng.standard_normal(
                (N, H, PG, d))) for _ in range(2))
            (kpj, kpt), (vpj, vpt) = _pair(kp, dtype), _pair(vp, dtype)
            pwant = jda.paged_attention(qj, kpj, vpj, jnp.asarray(table),
                                        jnp.asarray(POS))
            pgot = tda.paged_attention(qt, kpt, vpt, torch.from_numpy(table),
                                       torch.from_numpy(POS))
            out[d, dtype] = ((got, kct, vct, pgot), (want, kj, vj, pwant))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_reads_match_jax_at_any_width(plain_reads, d, dtype):
    """``decode_attention`` (the column write, then ``attend_cache``) and
    ``paged_attention`` at head width ``d``: caches equal to JAX's bit
    for bit, outputs finite and within TOL of the Pallas reads."""
    (got, kct, vct, pgot), (want, kj, vj, pwant) = plain_reads[d, dtype]
    assert got.shape == pgot.shape == (B, H, d)
    np.testing.assert_array_equal(_np(kct), np.asarray(kj, np.float32))
    np.testing.assert_array_equal(_np(vct), np.asarray(vj, np.float32))
    for g, w in ((got, want), (pgot, pwant)):
        assert g.dtype == DTYPES[dtype][1] and torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **TOL[dtype])


def _quant_planes(rng, kind, shape, stale):
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
def quant_reads():
    """{(d, kind, dtype): ((port contiguous, paged), (JAX contiguous,
    paged))} of the quantized reads, built once."""
    out = {}
    for d in WIDTHS:
        for kind in KINDS:
            rng = np.random.default_rng(100 + d)
            stale = np.broadcast_to(
                np.arange(S)[None, None] > POS[:, None, None], (B, H, S))
            (kj, ksj), (kt, kst) = _quant_planes(rng, kind, (B, H, S, d),
                                                 stale)
            (vj, vsj), (vt, vst) = _quant_planes(rng, kind, (B, H, S, d),
                                                 stale)
            table = _table(rng)
            pstale = np.broadcast_to(~_live(table)[:, None], (N, H, PG))
            (kpj, kpsj), (kpt, kpst) = _quant_planes(rng, kind,
                                                     (N, H, PG, d), pstale)
            (vpj, vpsj), (vpt, vpst) = _quant_planes(rng, kind,
                                                     (N, H, PG, d), pstale)
            for dtype in ("f32", "bf16"):
                qj, qt = _pair(rng.standard_normal((B, H, d)), dtype)
                want = jda._run_attn_quant(
                    qj.reshape(B * H, d), kj.reshape(B * H, S, d),
                    ksj.reshape(B * H, S), vj.reshape(B * H, S, d),
                    vsj.reshape(B * H, S), jnp.asarray(POS),
                    1.0 / d ** 0.5, H, None).reshape(B, H, d)
                got = tda.attend_cache_quant(qt, kt, kst, vt, vst,
                                             torch.from_numpy(POS))
                pwant = jda.paged_attention_quantized(
                    qj, kpj, kpsj, vpj, vpsj, jnp.asarray(table),
                    jnp.asarray(POS), kind=kind)
                pgot = tda.paged_attention_quantized(
                    qt, kpt, kpst, vpt, vpst, torch.from_numpy(table),
                    torch.from_numpy(POS), kind=kind)
                out[d, kind, dtype] = ((got, pgot), (want, pwant))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_quantized_reads_match_jax_at_any_width(quant_reads, d, kind,
                                                dtype):
    """``attend_cache_quant`` and ``paged_attention_quantized`` at head
    width ``d`` over int8 / fp8 planes whose stale cells hold NaN bytes
    and NaN scales: finite, and within TOL of ``_run_attn_quant`` and
    ``paged_attention_quantized`` in interpret mode."""
    (got, pgot), (want, pwant) = quant_reads[d, kind, dtype]
    for g, w in ((got, want), (pgot, pwant)):
        assert g.shape == (B, H, d) and torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   **TOL[dtype])


# ---------------------------------------------------------------------------
# the slice: a heads-of-80 GPT through Engine + Scheduler
# ---------------------------------------------------------------------------

VOCAB = 256
# init_std 0.2: at the default 0.02 a random model's greedy stream repeats
# its last prompt token, which would make token identity an empty check
WIDE = dict(vocab_size=VOCAB, hidden_size=160, num_layers=2, num_heads=2,
            seq_len=128, remat=False, init_std=0.2)
#: prompt lengths (two buckets of max_prompt_len 16; JAX generates each
#: length's rows in one call) and each request's budget
LENGTHS = (5, 5, 12, 12)
MAX_TOKENS = 6
#: the port's sides: (JAX compute dtype, kv_cache_dtype, EngineConfig
#: fields beyond the common ones)
SIDES = {"contiguous": ("f32", "auto", {}),
         "paged": ("f32", "auto", {"page_size": 8}),
         "int8": ("f32", "int8", {}),
         "fp16": ("f16", "auto", {})}


@pytest.fixture(scope="module")
def wide():
    """(JAX params, mesh, the port's params) of the heads-of-80 model: one
    set of weights, the JAX init tree crossed over."""
    jcfg = jgpt.GPTConfig(**WIDE, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    return params, mesh, tparams


def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, VOCAB, n).tolist() for n in LENGTHS]


_JAX_STREAMS = {}


def _jax_streams(wide, dtype, kv):
    """JAX's greedy ``generate`` of every prompt (the rows of one length
    in one call), once per (compute dtype, cache dtype)."""
    if (dtype, kv) not in _JAX_STREAMS:
        params, mesh, _ = wide
        jcfg = jgpt.GPTConfig(**WIDE, compute_dtype=DTYPES[dtype][0],
                              kv_cache_dtype=kv)
        gen = jax.jit(jax.shard_map(
            lambda p, t: jgpt.generate(jcfg, p, t, MAX_TOKENS,
                                       pad_token_id=0),
            mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P()),
            out_specs=P(), check_vma=False))
        prompts = _prompts()
        streams = [None] * len(prompts)
        for n in sorted(set(LENGTHS)):
            idx = [i for i, p in enumerate(prompts) if len(p) == n]
            toks = np.asarray(gen(params, jnp.asarray(
                [prompts[i] for i in idx], jnp.int32)))
            for i, row in zip(idx, toks):
                streams[i] = [int(t) for t in row]
        _JAX_STREAMS[dtype, kv] = streams
    return _JAX_STREAMS[dtype, kv]


@pytest.mark.parametrize("side", list(SIDES))
def test_heads_of_80_streams_match_jax_generate(wide, side):
    """The 4 prompts through 3 slots (one waits), chunks of 2, with the
    decode wrappers (``decode_attn_impl="kernel"``): every greedy stream
    equals JAX's ``generate`` of its prompt, contiguous, paged, int8 and
    fp16 (the fp16 compute-dtype cache against JAX's fp16 model)."""
    dtype, kv, extra = SIDES[side]
    _, _, tparams = wide
    cfg = tgpt.GPTConfig(**WIDE, compute_dtype=DTYPES[dtype][1],
                         kv_cache_dtype=kv, decode_attn_impl="kernel")
    assert cfg.head_dim == 80
    ecfg = EngineConfig(slots=3, max_prompt_len=16, max_seq_len=32,
                        decode_chunk=2, **extra)
    sched = Scheduler(Engine(cfg, tparams, ecfg, device="cpu"))
    reqs = [Request(f"r{i}", p, max_tokens=MAX_TOKENS)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    want = _jax_streams(wide, dtype, kv)
    for r, w in zip(reqs, want):
        assert sched.completions[r.request_id].tokens == w, r.request_id


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


def _zeros(*shape, dtype=torch.float16):
    return torch.zeros(shape, dtype=dtype)


def test_decode_wrappers_take_fp16_at_any_width(fake_cuda):
    """Every decode wrapper at d = 80 with fp16 rows launches its entry
    with the fp16 code (2) and the width, and never its plain twin;
    ``_build.DTYPE_CODES`` still refuses fp16."""
    d, T = 80, 3
    f16 = torch.float16
    pos = torch.zeros(B, dtype=torch.int32)
    table = torch.zeros(B, MP, dtype=torch.int32)
    q, kn, vn = _zeros(B, H, d), _zeros(B, H, d), _zeros(B, H, d)
    knt, vnt = _zeros(B, H, T, d), _zeros(B, H, T, d)
    kc, vc = _zeros(B, H, S, d), _zeros(B, H, S, d)
    kp, vp = _zeros(N, H, PG, d), _zeros(N, H, PG, d)
    assert tda.decode_attention(q, kn, vn, kc, vc, pos).dtype == f16
    tda.write_column(kn, vn, kc, vc, pos)
    assert tda.attend_cache(q, kc, vc, pos).dtype == f16
    tda.cache_write_columns(knt, vnt, kc, vc, pos)
    tda.paged_write_column(kn, vn, kp, vp, table, pos)
    tda.paged_write_columns(knt, vnt, kp, vp, table, pos)
    assert tda.paged_attention(q, kp, vp, table, pos).dtype == f16
    assert tda.paged_decode_attention(q, kn, vn, kp, vp, table,
                                      pos).dtype == f16
    planes = [_zeros(B, H, S, d, dtype=torch.int8),
              _zeros(B, H, S, dtype=torch.float32)] * 2
    pools = [_zeros(N, H, PG, d, dtype=torch.float8_e4m3fn),
             _zeros(N, H, PG, dtype=torch.float32)] * 2
    assert tda.decode_attention_quantized(q, kn, vn, *planes, pos).dtype \
        == f16
    tda.cache_write_columns_quant(knt, vnt, *planes, pos)
    tda.paged_write_column_quant(kn, vn, *pools, table, pos)
    tda.paged_write_columns_quant(knt, vnt, *pools, table, pos)
    assert tda.paged_attention_quantized(q, *pools, table, pos).dtype == f16
    # (entry, index of d, index of the dtype code) in each entry's args
    where = {"decode_write_column": (8, 9), "decode_attention": (8, 10),
             "cache_write_columns": (9, 10), "paged_write_column": (10, 11),
             "paged_write_columns": (11, 12), "paged_attention": (10, 12),
             "decode_attention_write": (10, 12),
             "paged_attention_write": (12, 14),
             "decode_write_column_quant": (10, 11),
             "decode_attention_quant": (10, 12),
             "cache_write_columns_quant": (11, 12),
             "paged_write_column_quant": (12, 13),
             "paged_write_columns_quant": (13, 14),
             "paged_attention_quant": (12, 14)}
    assert set(fake_cuda.calls) == set(where)
    for name, (i_d, i_code) in where.items():
        args = fake_cuda.calls[name]
        assert (args[i_d], args[i_code]) == (d, 2), name
    assert _build.DECODE_DTYPE_CODES[f16] == 2
    assert f16 not in _build.DTYPE_CODES
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.dtype_code(q, "a CUDA-core kernel")


@pytest.mark.parametrize("d,ok", [(1, True), (100, True), (128, True),
                                  (129, False)])
def test_reads_take_widths_up_to_the_cap(fake_cuda, d, ok):
    """The three read entries take any width from 1 to HM_MAX_HEAD_DIM
    (128) and pass it on; past it each wrapper raises naming the cap."""
    pos = torch.zeros(B, dtype=torch.int32)
    table = torch.zeros(B, MP, dtype=torch.int32)
    q = _zeros(B, H, d, dtype=torch.bfloat16)
    kc = _zeros(B, H, S, d, dtype=torch.bfloat16)
    kp = _zeros(N, H, PG, d, dtype=torch.bfloat16)
    planes = [_zeros(B, H, S, d, dtype=torch.int8),
              _zeros(B, H, S, dtype=torch.float32)] * 2
    reads = {"decode_attention": lambda: tda.attend_cache(q, kc, kc, pos),
             "paged_attention": lambda: tda.paged_attention(q, kp, kp, table,
                                                            pos),
             "decode_attention_quant": lambda: tda.attend_cache_quant(
                 q, *planes, pos)}
    at = {"decode_attention": 8, "paged_attention": 10,
          "decode_attention_quant": 10}        # d's index in the args
    for name, call in reads.items():
        if ok:
            assert call().shape == (B, H, d)
            assert fake_cuda.calls[name][at[name]] == d, name
        else:
            with pytest.raises(ValueError, match="HM_MAX_HEAD_DIM"):
                call()
    assert (set(fake_cuda.calls) == set(reads)) == ok
