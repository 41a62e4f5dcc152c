"""apex_tpu_torch's quantized KV cache (int8, fp8) against the JAX package,
on the CPU.

Oracles:

- ``GPTConfig.kv_cache_dtype``: every spelling JAX resolves (``"auto"``,
  ``"bf16"``, ``"compute"``, ``"int8"``, ``"fp8"``) constructs and
  resolves to the same storage kind; an unknown kind raises a
  ``ValueError`` naming ``kv_cache_dtype``;
- ``quantize_kv_rows``: bit for bit JAX's (data bytes and scales), int8
  and fp8, fp32 and bf16 rows: random rows over six decades of scale, an
  all-zero row, rows whose values land exactly on .5 ties (int8) or on
  midpoints between e4m3 values (fp8) after the division, rows that
  saturate at ±127 / ±448; ``quantize_cache_block`` and
  ``dequantize_cache_block`` bit for bit JAX's;
- the six plain twins against the Pallas kernels in interpret mode: the
  four writes bit for bit in both planes (lanes clamped past the horizon
  included), the reads at ``rtol=atol=1e-5`` (fp32) and ``2e-2`` (bf16,
  rounded at other points), with fp8 NaN bytes and NaN scales past every
  row's position, in every unmapped page and in the sink;
- ``decode_step`` x4, ``decode_verify`` (T=3) and one more
  ``decode_step``: logits within ``QUANT_TOL`` of JAX's (fp32, "xla" on
  both sides), and the port's paged run bit-equal to its contiguous run
  through a scrambled table, for both ``decode_attn_impl`` values;
- quantized logits within JAX's ``_KV_TOL`` of the compute cache's
  (``test_kv_quant_decode_oracle`` re-pointed);
- ``Engine.cache_bytes()`` is ``n * d + 4 * n`` for ``n = L * 2 * B * h
  * S`` (``test_cache_bytes_reduction_and_accessor`` re-pointed),
  contiguous and paged;
- int8 ``Scheduler`` streams: paged == contiguous and ``spec_k=2`` ==
  plain (``test_spec_int8_kv_parity`` re-pointed); greedy int8
  ``generate`` equals JAX's.

The reference's own paged quantized parity test
(``test_paged_cache.py::test_paged_decode_logits_oracle[int8]``) fails on
this host's jax; the paged oracle here is the port's paged run against
its contiguous run, bit for bit, plus the contiguous run against JAX.
"""

import dataclasses
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
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
)

# the modules (both kernel packages re-export functions of these names)
jda = importlib.import_module("apex_tpu.kernels.decode_attention")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

KINDS = ["int8", "fp8"]
IMPLS = ["kernel", "xla"]
VOCAB = 256
# init_std 0.2, as the paged and spec suites: at 0.02 a random model's
# greedy stream repeats its last prompt token
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
#: JAX's decode-logit band of a quantized cache against the compute cache
#: (tests/test_kv_cache.py _KV_TOL)
KV_TOL = {"int8": dict(rtol=4e-2, atol=4e-2),
          "fp8": dict(rtol=8e-2, atol=8e-2)}
#: port vs JAX logits through the quantized cache, fp32: the two
#: packages' K/V differ by float rounding (matmuls reduce in other
#: orders), and a value within an ulp of a rounding boundary lands one
#: quantization step apart (1/127 of the row's absmax in int8, an e4m3
#: ulp in fp8), which moves a logit by up to ~1e-3 in this model
QUANT_TOL = {"int8": dict(rtol=2e-3, atol=2e-3),
             "fp8": dict(rtol=4e-3, atol=4e-3)}
STORE = {"int8": (np.int8, torch.int8),
         "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}
#: a stale cell: an fp8 NaN byte, or int8 -128 (never written)
STALE_BYTE = {"int8": 0x80, "fp8": 0x7F}


def _np(t):
    return t.detach().float().cpu().numpy()


def _bits(a):
    """Raw bits of an array or tensor as a numpy integer array (NaN bits
    compare equal to themselves)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        t = t.view(torch.uint8) if t.element_size() == 1 else t.view(
            torch.int32)
        return t.numpy()
    a = np.asarray(a)
    return a.view(np.uint8 if a.itemsize == 1 else np.int32)


def _rows(x, dtype):
    """The same rows as a JAX array and a torch tensor (``dtype`` f32 or
    bf16)."""
    j = jnp.asarray(x, jnp.float32)
    if dtype == "bf16":
        j = j.astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    return j, t


def _planes(kind, data_bytes, scales):
    """The same quantized planes as JAX arrays and torch tensors, from raw
    bytes and fp32 scales."""
    npd, td = STORE[kind]
    j = (jnp.asarray(data_bytes.view(npd)), jnp.asarray(scales))
    t = (torch.from_numpy(data_bytes.copy()).view(td),
         torch.from_numpy(scales.copy()))
    return j, t


def _quant_planes(rng, kind, shape, stale):
    """Random quantized planes ``shape [n, h, cols, d]`` (bytes, scales):
    cells where ``stale [n, h, cols]`` hold the stale byte and a NaN
    scale."""
    q, s = tda.quantize_kv_rows(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
        kind)
    b = q.view(torch.uint8).numpy().copy()
    s = s.numpy().copy()
    b[stale] = STALE_BYTE[kind]
    s[stale] = np.nan
    return b, s


# ---------------------------------------------------------------------------
# the config repair and the quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spelling", ["auto", "bf16", "compute", "int8",
                                      "fp8"])
def test_kv_cache_dtype_spellings_match_jax(spelling):
    """Every spelling JAX resolves constructs and resolves alike: the port
    refused ``"compute"`` (and, before this slice, the quantized kinds)."""
    want = jgpt._kv_cache_dtype(jgpt.GPTConfig(**SMALL,
                                               kv_cache_dtype=spelling))
    cfg = tgpt.GPTConfig(**SMALL, kv_cache_dtype=spelling)
    assert tgpt._kv_cache_dtype(cfg) == want
    cache = tgpt.init_cache(cfg, tgpt.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"), 2, 8)
    if want == "compute":
        assert isinstance(cache, torch.Tensor)
        assert cache.dtype == cfg.compute_dtype
    else:
        assert cache["kv"].dtype == STORE[want][1]
        assert cache["scale"].dtype == torch.float32
        assert tuple(cache["scale"].shape) == tuple(cache["kv"].shape[:-1])


def test_unknown_kv_cache_dtype_raises_naming_the_field():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        jgpt._kv_cache_dtype(jgpt.GPTConfig(**SMALL, kv_cache_dtype="int4"))
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tgpt.GPTConfig(**SMALL, kv_cache_dtype="int4")


def _tie_rows(kind, rng, n=16, d=64):
    """Rows whose values, divided by the row's scale in fp32, land on a
    rounding tie: k + .5 (int8) or the midpoint of two e4m3 values (fp8).
    Element 0 holds the absmax that fixes the scale. Returns the rows and
    how many of their values are exact ties in fp32."""
    qmax = tda.KV_QMAX[kind]
    recip = np.float32(1.0 / qmax)
    grid = np.arange(256, dtype=np.uint8).view(
        ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = np.unique(np.abs(grid[np.isfinite(grid)]))
    mids = (grid[:-1] + grid[1:]) / 2
    rows = np.zeros((n, d), np.float32)
    for i in range(n):
        amax = np.float32(rng.uniform(0.5, 50.0))
        scale = np.float32(amax * recip)
        if kind == "int8":
            ys = rng.integers(-126, 126, d).astype(np.float32) + 0.5
        else:
            ys = rng.choice(mids, d) * rng.choice([-1, 1], d)
        x = np.clip((ys * scale).astype(np.float32), -amax, amax)
        x[0] = amax
        rows[i] = x
    scale = np.abs(rows).max(1, keepdims=True).astype(np.float32) * recip
    y = (rows / scale)[:, 1:]
    if kind == "int8":
        ties = int((np.abs(y - np.floor(y)) == 0.5).sum())
    else:
        ties = int(np.isin(np.abs(y), mids).sum())
    return rows, ties


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_kv_rows_matches_jax_bit_for_bit(kind, dtype):
    rng = np.random.default_rng(0)
    rand = rng.standard_normal((256, 64)) * 10.0 ** rng.uniform(-3, 3,
                                                                (256, 1))
    ties, n_ties = _tie_rows(kind, rng)
    assert n_ties > 100          # fp32 rows; in bf16 most move off the ties
    rows = np.concatenate([rand, np.zeros((1, 64)), ties]).astype(np.float32)
    jx, tx = _rows(rows, dtype)
    jq, js = jda.quantize_kv_rows(jx, kind)
    tq, ts = tda.quantize_kv_rows(tx, kind)
    assert tq.dtype == STORE[kind][1] and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    qmax = tda.KV_QMAX[kind]
    assert float(tq.float().abs().max()) == qmax      # saturates at qmax
    assert float(ts[256]) == np.float32(np.float32(1e-12)
                                        * np.float32(1.0 / qmax))
    assert not tq[256].float().any()                  # the zero row
    back = tda.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_allclose(_np(back), np.asarray(
        jgpt.dequantize_kv(jq, js, jnp.float32)), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["auto"] + KINDS)
def test_cache_block_round_trip_matches_jax(kind):
    """``quantize_cache_block`` (prefill's one quantization) and
    ``dequantize_cache_block`` on an [L, 2, b, h, P, d] block: bit for
    bit JAX's, both ways."""
    block = np.random.default_rng(3).standard_normal(
        (2, 2, 3, 4, 8, 16)).astype(np.float32)
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32,
                          kv_cache_dtype=kind)
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                          kv_cache_dtype=kind)
    want = jgpt.quantize_cache_block(jcfg, jnp.asarray(block))
    got = tgpt.quantize_cache_block(tcfg, torch.from_numpy(block))
    if kind == "auto":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    np.testing.assert_array_equal(_bits(got["kv"]), _bits(want["kv"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))
    np.testing.assert_array_equal(
        tgpt.dequantize_cache_block(tcfg, got).numpy(),
        np.asarray(jgpt.dequantize_cache_block(jcfg, want)))


# ---------------------------------------------------------------------------
# the kernels' plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _contig_inputs(kind, dtype, seed, b=3, h=2, s=16, d=64, t=3):
    """Rows ``[b, h, t, d]``, q ``[b, h, d]`` and quantized planes ``[b, h,
    s, d]`` whose cells past ``pos`` are stale."""
    rng = np.random.default_rng(seed)
    pos = np.asarray([0, 7, s - 1], np.int32)
    stale = np.arange(s)[None, None] > pos[:, None, None]
    stale = np.broadcast_to(stale, (b, h, s))
    kb, ks = _quant_planes(rng, kind, (b, h, s, d), stale)
    vb, vs = _quant_planes(rng, kind, (b, h, s, d), stale)
    rows = [_rows(rng.standard_normal((b, h, t, d)), dtype)
            for _ in range(2)]
    q = _rows(rng.standard_normal((b, h, d)), dtype)
    return pos, (kb, ks, vb, vs), rows, q


def _paged_inputs(kind, dtype, seed, b=3, h=2, n=13, p=4, mp=4, d=64, t=3):
    """The paged twin of :func:`_contig_inputs`: a pool of ``n`` pages of
    ``p``, each row's ``mp`` pages a random set of pages 1..n-1; every
    cell no row holds at or before its position is stale."""
    rng = np.random.default_rng(seed)
    table = rng.permutation(np.arange(1, n))[:b * mp].reshape(b, mp).astype(
        np.int32)
    pos = np.asarray([0, 7, mp * p - 1], np.int32)
    live = np.zeros((n, h, p), bool)
    for r in range(b):
        for c in range(pos[r] + 1):
            live[table[r, c // p], :, c % p] = True
    kb, ks = _quant_planes(rng, kind, (n, h, p, d), ~live)
    vb, vs = _quant_planes(rng, kind, (n, h, p, d), ~live)
    rows = [_rows(rng.standard_normal((b, h, t, d)), dtype)
            for _ in range(2)]
    q = _rows(rng.standard_normal((b, h, d)), dtype)
    return pos, table, (kb, ks, vb, vs), rows, q


def _jt(kind, raw):
    """Planes ``(kb, ks, vb, vs)`` as JAX ``(k_q, k_s, v_q, v_s)`` and
    torch ``(k_q, k_s, v_q, v_s)``."""
    (jk, jks), (tk, tks) = _planes(kind, raw[0], raw[1])
    (jv, jvs), (tv, tvs) = _planes(kind, raw[2], raw[3])
    return (jk, jks, jv, jvs), [tk, tks, tv, tvs]


def _assert_planes_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_write_column_quant_plain_matches_jax_kernel(kind, dtype):
    """One quantized column per row (the first, a middle and the last
    column of the horizon): the four planes bit for bit JAX's."""
    pos, raw, ((kj, kt), (vj, vt)), _ = _contig_inputs(kind, dtype, 0)
    jp, tp = _jt(kind, raw)
    want = jda._write_column_quant(kj[:, :, 0], vj[:, :, 0], *jp,
                                   jnp.asarray(pos), kind)
    tda.write_column_quant(kt[:, :, 0].contiguous(), vt[:, :, 0].contiguous(),
                           *tp, torch.from_numpy(pos), kind)
    _assert_planes_equal(tp, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_cache_write_columns_quant_plain_matches_jax_kernel(kind, dtype):
    """Three columns per row, one row starting at the horizon's last
    column: lanes past it clamp onto that column and the last lane wins,
    in the data and the scale plane."""
    pos, raw, ((kj, kt), (vj, vt)), _ = _contig_inputs(kind, dtype, 1)
    pos = np.asarray([2, 15, 14], np.int32)
    jp, tp = _jt(kind, raw)
    want = jda.cache_write_columns_quant(kj, vj, *jp, jnp.asarray(pos), kind)
    tda.cache_write_columns_quant(kt, vt, *tp, torch.from_numpy(pos), kind)
    _assert_planes_equal(tp, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_paged_write_column_quant_plain_matches_jax_kernel(kind, dtype):
    pos, table, raw, ((kj, kt), (vj, vt)), _ = _paged_inputs(kind, dtype, 2)
    jp, tp = _jt(kind, raw)
    want = jda.paged_write_column_quant(
        kj[:, :, 0], vj[:, :, 0], *jp, jnp.asarray(table), jnp.asarray(pos),
        kind)
    tda.paged_write_column_quant(
        kt[:, :, 0].contiguous(), vt[:, :, 0].contiguous(), *tp,
        torch.from_numpy(table), torch.from_numpy(pos), kind)
    _assert_planes_equal(tp, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_paged_write_columns_quant_plain_matches_jax_kernel(kind, dtype):
    """Three columns per row through the table, rows at the horizon's last
    column and two short of it: clamped lanes as in the Pallas grid."""
    _, table, raw, ((kj, kt), (vj, vt)), _ = _paged_inputs(kind, dtype, 3)
    pos = np.asarray([2, 15, 14], np.int32)
    jp, tp = _jt(kind, raw)
    want = jda.paged_write_columns_quant(kj, vj, *jp, jnp.asarray(table),
                                         jnp.asarray(pos), kind)
    tda.paged_write_columns_quant(kt, vt, *tp, torch.from_numpy(table),
                                  torch.from_numpy(pos), kind)
    _assert_planes_equal(tp, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_reads_plain_match_jax_kernels(kind, dtype):
    """The contiguous read alone (``_run_attn_quant``), the write + read
    (``decode_attention_quantized``) and the paged read, over planes whose
    stale cells hold NaN bytes (fp8) and NaN scales: finite, and within
    TOL of the Pallas kernels."""
    pos, raw, ((kj, kt), (vj, vt)), (qj, qt) = _contig_inputs(kind, dtype, 4)
    jp, tp = _jt(kind, raw)
    b, h, s, d = raw[0].shape
    want = jda._run_attn_quant(
        qj.reshape(b * h, d), jp[0].reshape(b * h, s, d),
        jp[1].reshape(b * h, s), jp[2].reshape(b * h, s, d),
        jp[3].reshape(b * h, s), jnp.asarray(pos), 1.0 / d ** 0.5, h, None)
    got = tda.attend_cache_quant(qt, *tp, torch.from_numpy(pos))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(
        want, np.float32).reshape(b, h, d), **TOL[dtype])
    want, *planes = jda.decode_attention_quantized(
        qj, kj[:, :, 0], vj[:, :, 0], *jp, jnp.asarray(pos), kind=kind)
    got = tda.decode_attention_quantized(
        qt, kt[:, :, 0].contiguous(), vt[:, :, 0].contiguous(), *tp,
        torch.from_numpy(pos), kind=kind)
    _assert_planes_equal(tp, planes)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    pos, table, raw, _, (qj, qt) = _paged_inputs(kind, dtype, 5)
    jp, tp = _jt(kind, raw)
    want = jda.paged_attention_quantized(qj, *jp, jnp.asarray(table),
                                         jnp.asarray(pos), kind=kind)
    got = tda.paged_attention_quantized(qt, *tp, torch.from_numpy(table),
                                        torch.from_numpy(pos), kind=kind)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_quantized_wrappers_refuse_a_mismatched_kind():
    pos, raw, ((_, kt), (_, vt)), (_, qt) = _contig_inputs("int8", "f32", 6)
    _, tp = _jt("int8", raw)
    with pytest.raises(ValueError, match="kind"):
        tda.write_column_quant(kt[:, :, 0].contiguous(),
                               vt[:, :, 0].contiguous(), *tp,
                               torch.from_numpy(pos), "fp8")
    with pytest.raises(TypeError):
        tda.attend_cache_quant(qt, tp[0].float(), tp[1], tp[2].float(),
                               tp[3], torch.from_numpy(pos))


# ---------------------------------------------------------------------------
# the model: chained decode steps and a verify, port vs JAX, paged == contig
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """(JAX params, mesh, port params) — one set of weights, the JAX init
    tree crossed over."""
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    return params, mesh, tparams


B, S_MAX, PAGE_SZ = 2, 24, 4
TOKS = np.random.default_rng(5).integers(0, VOCAB, (9, B)).astype(np.int32)
POS0 = np.asarray([0, 3], np.int32)


def _jax_chain(model, kind):
    """JAX (fp32, "xla"): 4 decode steps from a zero cache, a verify of 3
    tokens, one more step; the logits of all six calls."""
    params, mesh, _ = model
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32,
                          kv_cache_dtype=kind, decode_attn_impl="xla")

    def run(p, tk):
        cache = jgpt.init_cache(jcfg, p, B, S_MAX)
        pos = jnp.asarray(POS0)
        outs = []
        for j in range(4):
            lg, cache = jgpt.decode_step(jcfg, p, cache, tk[j], pos + j)
            outs.append(lg)
        lgv, cache = jgpt.decode_verify(jcfg, p, cache, tk[4:7].T, pos + 4)
        lg, cache = jgpt.decode_step(jcfg, p, cache, tk[7], pos + 7)
        return jnp.stack(outs), lgv, lg

    return jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P()),
        out_specs=(P(), P(), P()), check_vma=False))(params,
                                                    jnp.asarray(TOKS))


_JAX_CHAIN = {}


def _port_chain(tparams, kind, impl, table=None):
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                         kv_cache_dtype=kind, decode_attn_impl=impl)
    if table is None:
        cache = tgpt.init_cache(cfg, tparams, B, S_MAX)
    else:
        cache = tgpt.init_cache(cfg, tparams, 16, PAGE_SZ)
        table = torch.from_numpy(table)
    pos = torch.from_numpy(POS0)
    toks = torch.from_numpy(TOKS)
    outs = []
    for j in range(4):
        lg, cache = tgpt.decode_step(cfg, tparams, cache, toks[j], pos + j,
                                     table)
        outs.append(lg)
    lgv, cache = tgpt.decode_verify(cfg, tparams, cache, toks[4:7].T
                                    .contiguous(), pos + 4, table)
    lg, cache = tgpt.decode_step(cfg, tparams, cache, toks[7], pos + 7,
                                 table)
    return torch.stack(outs), lgv, lg


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_decode_and_verify_chain_matches_jax_and_paged_equals_contig(
        model, kind, impl):
    """Four steps, a T=3 verify and a step through the quantized cache:
    every logit within QUANT_TOL of JAX's, and the paged run through a
    scrambled table (pages of 4) bit for bit the contiguous run."""
    if kind not in _JAX_CHAIN:
        _JAX_CHAIN[kind] = [np.asarray(x) for x in _jax_chain(model, kind)]
    want = _JAX_CHAIN[kind]
    _, _, tparams = model
    got = _port_chain(tparams, kind, impl)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, **QUANT_TOL[kind])
    table = np.random.RandomState(1).permutation(np.arange(1, 16))[
        :B * (S_MAX // PAGE_SZ)].reshape(B, -1).astype(np.int32)
    paged = _port_chain(tparams, kind, impl, table)
    for g, p in zip(got, paged):
        assert torch.equal(g, p)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_logits_within_kv_tol_of_compute_cache(kind, impl):
    """JAX's ``test_kv_quant_decode_oracle`` on the port: JAX's config
    (vocab 96, hidden 64, 2 layers, seq 32, fp32) and weights, prefill of
    6 tokens and two greedy steps; the quantized cache's logits within
    ``_KV_TOL`` of the compute cache's."""
    cfg0 = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                seq_len=32, remat=False)
    params = jgpt.init(jgpt.GPTConfig(**cfg0, compute_dtype=jnp.float32),
                       jax.random.PRNGKey(0))
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, 96, (2, 6)))
    tok0 = torch.from_numpy(rng.integers(0, 96, 2))

    def logits(kv):
        cfg = tgpt.GPTConfig(**cfg0, compute_dtype=torch.float32,
                             kv_cache_dtype=kv, decode_attn_impl=impl)
        cache, _ = tgpt.prefill(cfg, tparams, prompt, max_len=32)
        pos, tok, outs = torch.tensor([6, 3], dtype=torch.int32), tok0, []
        for _ in range(2):
            lg, cache = tgpt.decode_step(cfg, tparams, cache, tok, pos)
            outs.append(lg)
            tok, pos = lg.argmax(-1), pos + 1
        return torch.stack(outs).numpy()

    np.testing.assert_allclose(logits(kind), logits("auto"), **KV_TOL[kind])


# ---------------------------------------------------------------------------
# the engine and the scheduler over the quantized cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [0, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_cache_bytes_counts_both_planes(model, kind, page_size):
    """``cache_bytes()`` is the data plane (a byte a value) plus the fp32
    scale plane, exactly, against ``4 n d`` for the fp32 compute cache,
    and the scheduler's summary carries it."""
    _, _, tparams = model
    ecfg = EngineConfig(slots=2, max_prompt_len=8, max_seq_len=16,
                        page_size=page_size)
    eng = {k: Engine(tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                                    kv_cache_dtype=k), tparams, ecfg,
                     device="cpu") for k in ("auto", kind)}
    cfg = tgpt.GPTConfig(**SMALL)
    cols = (eng[kind].describe()["num_pages"] * page_size if page_size
            else ecfg.slots * ecfg.max_seq_len)
    n = cfg.num_layers * 2 * cfg.num_heads * cols
    d = cfg.head_dim
    assert eng[kind].cache_bytes() == n * d + 4 * n
    assert eng["auto"].cache_bytes() == n * d * 4
    assert eng[kind].describe()["kv_cache_kind"] == kind
    assert Scheduler(eng[kind]).summary()["cache_bytes"] == float(
        eng[kind].cache_bytes())


def _trace(n, sampled=True, seed=0, max_tokens=None):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = rng.integers(0, VOCAB, 1 + (7 * i + 3) % 16).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=i)
              if sampled and i % 2 else SamplingParams())
        reqs.append(Request(f"r{i}", p, sampling=sp,
                            max_tokens=max_tokens or 6 + 2 * i))
    return reqs


def _serve(tparams, reqs, kind, impl, **ecfg_kw):
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                         kv_cache_dtype=kind, decode_attn_impl=impl)
    ecfg = EngineConfig(**{**dict(slots=3, max_prompt_len=16,
                                  max_seq_len=40), **ecfg_kw})
    sched = Scheduler(Engine(cfg, tparams, ecfg, device="cpu"))
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return {k: c.tokens for k, c in sched.completions.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_int8_paged_and_spec_streams_equal_contiguous_plain(model, impl):
    """int8: paged streams (greedy and sampled) equal contiguous ones, and
    greedy ``spec_k=2`` streams equal plain ones (the verify quantizes
    through the same quantizer as the plain write)."""
    _, _, tparams = model
    contig = _serve(tparams, _trace(6), "int8", impl, decode_chunk=3)
    paged = _serve(tparams, _trace(6), "int8", impl, decode_chunk=3,
                   page_size=4)
    assert paged == contig
    plain = _serve(tparams, _trace(4, sampled=False), "int8", impl,
                   decode_chunk=2)
    spec = _serve(tparams, _trace(4, sampled=False), "int8", impl,
                  decode_chunk=2, spec_k=2)
    assert spec == plain


def test_int8_greedy_generate_matches_jax(model):
    """Greedy ``generate`` through the int8 cache, port vs JAX, fp32."""
    params, mesh, tparams = model
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32,
                          kv_cache_dtype="int8")
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                          kv_cache_dtype="int8")
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 7)).astype(
        np.int32)
    want = jax.jit(jax.shard_map(
        lambda p, t: jgpt.generate(jcfg, p, t, 10), mesh=mesh,
        in_specs=(jgpt.param_specs(jcfg), P()), out_specs=P(),
        check_vma=False))(params, jnp.asarray(prompt))
    got = tgpt.generate(tcfg, tparams, torch.from_numpy(prompt), 10,
                        device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
