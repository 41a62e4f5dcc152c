"""apex_tpu_torch: the shared-prefix pool on the CPU, against the JAX package.

Oracles:

- ``gpt.prefill_extend`` against JAX's on the same numpy inputs (weights,
  a prefix block, right-padded tails), fp32 and bf16, both
  ``attn_score_dtype`` branches: the tail K/V and the logits;
- ``gpt.cache_gather_page`` bit-equal to JAX's, and ``cache_insert_slot(
  pos=)`` writing at the offset as JAX's does;
- ``Engine._resolve_prefix_variants`` equal to JAX's staticmethod over a
  grid of buckets, prompt lengths and horizons;
- greedy streams of prefix hits through the port's ``Scheduler`` —
  contiguous, paged copy-on-write and int8 — token-identical to JAX's solo
  ``generate`` of the whole prompt; seeded sampled hits identical to the
  port's own cold admissions (sampling is the port's own draw);
- copy-on-write hits identical to pooled-slot hits, the shared pages'
  refcounts while they are mapped, their bytes unchanged by decode, only
  the registration's pins left after the drain;
- registration, matching and admission errors with JAX's wording.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
)
from apex_tpu_torch.serving.engine import Admission

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 256
# init_std 0.2: at the default 0.02 a random model's greedy stream repeats
# its last prompt token, which would make token identity an empty check
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2)

#: the pooled geometry of JAX's copy-on-write oracle
#: (tests/test_paged_cache.py): splits 8 and 16, tails up to 16
POOL = dict(slots=3, max_prompt_len=32, max_seq_len=48, decode_chunk=2,
            prompt_buckets=(8, 16, 32), admit_batch_sizes=(1, 2),
            prefix_pool_slots=1)
TEMPLATE = np.random.default_rng(900).integers(0, VOCAB, 16).tolist()
N_NEW = 6


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


def _trace():
    """Six requests: five share the template (tails of 1..5 tokens, so
    one tail bucket), one misses; odd ones sampled with a seed."""
    reqs = []
    for i in range(6):
        tail = np.random.default_rng(100 + i).integers(
            0, VOCAB, 1 + i % 5).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=5, seed=i) if i % 2
              else SamplingParams())
        prompt = tail + tail if i == 4 else TEMPLATE + tail
        reqs.append(Request(f"p{i}", prompt, max_tokens=N_NEW, sampling=sp))
    return reqs


def _serve(tparams, kind="auto", register=True, depth=1, waves=1, **over):
    """Serve ``_trace()`` ``waves`` times on one engine; returns each
    wave's streams, the last summary and the engine."""
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                         kv_cache_dtype=kind)
    eng = Engine(cfg, tparams, EngineConfig(**{**POOL, **over}),
                 device="cpu")
    if register:
        eng.register_prefix(TEMPLATE)
    out = []
    for w in range(waves):
        sched = Scheduler(eng, pipeline_depth=depth)
        for r in _trace():
            sched.submit(r)
        sched.run_until_idle()
        out.append({k: c.tokens for k, c in sched.completions.items()})
    return out, sched.summary(), eng


_JAX_SOLO = {}


def _jax_greedy(model, kind):
    """JAX's solo greedy ``generate`` of every greedy request of the
    trace, batched by prompt length (greedy rows are independent)."""
    if kind not in _JAX_SOLO:
        params, mesh, _ = model
        jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32,
                              kv_cache_dtype=kind)
        gen = jax.jit(jax.shard_map(
            lambda p, t: jgpt.generate(jcfg, p, t, N_NEW), mesh=mesh,
            in_specs=(jgpt.param_specs(jcfg), P()), out_specs=P(),
            check_vma=False))
        by_len = {}
        for r in _trace():
            if r.sampling.temperature == 0.0:
                by_len.setdefault(len(r.prompt), []).append(r)
        out = {}
        for rs in by_len.values():
            toks = np.asarray(gen(params, jnp.asarray(
                [r.prompt for r in rs], jnp.int32)))
            out.update({r.request_id: row.tolist()
                        for r, row in zip(rs, toks)})
        _JAX_SOLO[kind] = out
    return _JAX_SOLO[kind]


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

def _extend_inputs(model, jcfg, jdt, b, pfx, tb):
    """A prefix block as the serving path gives it — JAX's prefill of
    ``pfx`` random tokens, as numpy — right-padded tails and their ends."""
    params, mesh, _ = model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, VOCAB, (b, pfx)).astype(np.int32)
    prefix, _ = jax.jit(jax.shard_map(
        lambda p, t: jgpt.prefill_many(
            jcfg, p, t, jnp.full((b,), pfx - 1, jnp.int32), max_len=pfx),
        mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P()),
        out_specs=(P(), P()), check_vma=False))(params, jnp.asarray(toks))
    prefix = np.array(prefix.astype(jnp.float32))
    tail = rng.integers(0, VOCAB, (b, tb)).astype(np.int32)
    last = np.asarray([tb - 1, 2], np.int32)[:b]
    return prefix, tail, last


def _jax_extend(model, jcfg, jdt, prefix, tail, last, pfx):
    params, mesh, _ = model
    kv, lg = jax.jit(jax.shard_map(
        lambda p, x, t, l: jgpt.prefill_extend(jcfg, p, x, t, l,
                                               prefix_len=pfx),
        mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))(
            params, jnp.asarray(prefix, jdt), jnp.asarray(tail),
            jnp.asarray(last))
    return np.asarray(kv, np.float32), np.asarray(lg, np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("score", ["f32", "compute"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_extend_matches_jax(model, dtype, score):
    """The tail K/V and logits against JAX's. The two frameworks round
    the ported cold prefill apart by about the stated tolerances already
    (on these weights: fp32 1.2e-5 on K/V up to 9.3; bf16 0.125, an ulp
    at 8..16, which the LM head carries into the logits: 1.3% of their
    norm, where bf16 itself is 1.4% off fp32). So fp32 is held within
    rtol 1e-5 and 1e-5 of the tensor's largest magnitude; bf16's K/V
    within 2e-2 of their norm, and its logits' error against JAX's fp32
    extend of the same inputs to at most twice JAX's bf16 extend's."""
    _, _, tparams = model
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jdt, attn_score_dtype=score)
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=tdt, attn_score_dtype=score)
    pfx, tb = 16, 8
    prefix, tail, last = _extend_inputs(model, jcfg, jdt, 2, pfx, tb)
    want_kv, want_lg = _jax_extend(model, jcfg, jdt, prefix, tail, last,
                                   pfx)
    got_kv, got_lg = tgpt.prefill_extend(
        tcfg, tgpt.cast_params(tcfg, tparams),
        torch.from_numpy(prefix).to(tdt), torch.from_numpy(tail),
        torch.from_numpy(last), prefix_len=pfx)
    assert got_kv.dtype == tdt and tuple(got_kv.shape) == want_kv.shape
    got_kv, got_lg = got_kv.float().numpy(), got_lg.numpy()
    if dtype == "float32":
        for got, want in ((got_kv, want_kv), (got_lg, want_lg)):
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        return
    assert _rel(got_kv, want_kv) <= 2e-2
    _, ref_lg = _jax_extend(
        model, dataclasses.replace(jcfg, compute_dtype=jnp.float32),
        jnp.float32, prefix, tail, last, pfx)
    assert _rel(got_lg, ref_lg) <= 2 * _rel(want_lg, ref_lg)


def test_prefill_extend_refuses_what_jax_refuses(model):
    _, _, tparams = model
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    prefix = torch.zeros((2, 2, 1, 2, 60, 64))
    with pytest.raises(ValueError, match="position table"):
        tgpt.prefill_extend(tcfg, tparams, prefix,
                            torch.zeros((1, 8), dtype=torch.int64),
                            torch.zeros((1,), dtype=torch.int64),
                            prefix_len=60)


def test_cache_gather_page_bit_equal():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((2, 2, 3, 2, 16, 8)).astype(np.float32)
    quant = {"kv": rng.integers(-127, 128, pool.shape).astype(np.int8),
             "scale": rng.random(pool.shape[:-1]).astype(np.float32)}
    for page, length in ((0, 8), (2, 16), (1, 1)):
        want = np.asarray(jgpt.cache_gather_page(jnp.asarray(pool), page,
                                                 length))
        got = tgpt.cache_gather_page(torch.from_numpy(pool), page, length)
        np.testing.assert_array_equal(got.numpy(), want)
        want_q = jgpt.cache_gather_page(
            {k: jnp.asarray(v) for k, v in quant.items()}, page, length)
        got_q = tgpt.cache_gather_page(
            {k: torch.from_numpy(v) for k, v in quant.items()}, page, length)
        for k in quant:
            np.testing.assert_array_equal(got_q[k].numpy(),
                                          np.asarray(want_q[k]))


def test_cache_insert_slot_at_an_offset_matches_jax():
    rng = np.random.default_rng(5)
    cache = rng.standard_normal((2, 2, 3, 2, 24, 8)).astype(np.float32)
    block = rng.standard_normal((2, 2, 1, 2, 8, 8)).astype(np.float32)
    want = np.asarray(jgpt.cache_insert_slot(
        jnp.asarray(cache), jnp.asarray(block), 1, pos=16))
    got = tgpt.cache_insert_slot(torch.from_numpy(cache.copy()),
                                 torch.from_numpy(block), 1, pos=16)
    np.testing.assert_array_equal(got.numpy(), want)


_VARIANT_GRID = [
    dict(max_prompt_len=mpl, max_seq_len=msl, prompt_buckets=bk)
    for mpl, msl, bk in (
        (10, 24, None), (32, 48, (8, 16, 32)), (128, 144, None),
        (64, 64, None), (16, 17, None), (33, 40, (4, 9, 33)),
        (256, 288, None), (8, 12, None), (5, 40, (1, 2, 5)))]


@pytest.mark.parametrize("geom", _VARIANT_GRID,
                         ids=lambda g: f"{g['max_prompt_len']}-"
                                       f"{g['max_seq_len']}")
def test_resolve_prefix_variants_matches_jax(geom):
    jc = JEngineConfig(slots=2, prefix_pool_slots=1, **geom)
    tc = EngineConfig(slots=2, prefix_pool_slots=1, **geom)
    buckets = Engine._resolve_buckets(tc)
    assert buckets == JEngine._resolve_buckets(jc)
    try:
        want = JEngine._resolve_prefix_variants(jc, buckets)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Engine._resolve_prefix_variants(tc, buckets)
        assert str(got.value) == str(e)
        return
    assert Engine._resolve_prefix_variants(tc, buckets) == want
    off = dataclasses.replace(tc, prefix_pool_slots=0)
    assert Engine._resolve_prefix_variants(off, buckets) == ((), ())


# ---------------------------------------------------------------------------
# the engine and the scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,paged", [("auto", False), ("auto", True),
                                        ("int8", False), ("int8", True)])
def test_prefix_hit_streams_match_jax_solo_generate(model, kind, paged):
    """Greedy hits (contiguous, copy-on-write, int8) emit JAX's solo
    ``generate`` of the whole prompt; every stream, sampled ones
    included, equals the port's own cold admissions."""
    _, _, tparams = model
    over = dict(page_size=8) if paged else {}
    (hit,), s, _ = _serve(tparams, kind, **over)
    (cold,), s_cold, _ = _serve(tparams, kind, register=False,
                                prefix_pool_slots=0, **over)
    assert s["prefix_hits"] == 5.0 and s["prefix_misses"] == 1.0
    assert s_cold["prefix_hits"] == s_cold["prefix_misses"] == 0.0
    assert hit == cold
    want = _jax_greedy(model, kind)
    assert {rid: hit[rid] for rid in want} == want
    if paged:
        assert s["page_share_hits"] == s["prefix_hits"]


@pytest.mark.parametrize("kind", ["auto", "int8"])
def test_cow_hits_equal_pooled_hits_and_pages_drain(model, kind):
    """Copy-on-write hits emit the pooled-slot hits' streams; a second
    wave still shares; after the drain only the registration's pins are
    in use and no page is shared."""
    _, _, tparams = model
    (pooled,), _, _ = _serve(tparams, kind)
    (w1, w2), s, eng = _serve(tparams, kind, waves=2, page_size=8)
    assert w1 == pooled and w2 == pooled
    assert s["page_share_hits"] == s["prefix_hits"] == 5.0
    assert s["pages_in_use"] == 16 / 8
    assert s["pages_shared"] == 0.0
    assert eng.page_allocator.used_tokens == 16


def test_shared_pages_refcounts_and_bytes_unchanged(model):
    """While hits map them, the prefix pages hold one pin per slot plus
    the registration's; decode never writes them (their bytes are the
    same after the trace); the private pages return at release."""
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    eng = Engine(cfg, tparams, EngineConfig(**POOL, page_size=8),
                 device="cpu")
    assert eng.register_prefix(TEMPLATE) == 0
    pinned = eng._prefix_pages[0]
    assert len(pinned) == 2
    before = eng.cache[:, :, pinned].clone()
    sched = Scheduler(eng)
    for r in _trace()[:3]:
        sched.submit(r)
    sched.step()                 # three hits admitted, one chunk decoded
    refs = [eng.page_allocator._ref[p] for p in pinned]
    assert refs == [4, 4]
    assert eng.page_stats()["pages_shared"] == 2.0
    for slot in sched.active:
        assert list(eng._tables[slot][:2]) == pinned
    sched.run_until_idle()
    assert torch.equal(eng.cache[:, :, pinned], before)
    assert [eng.page_allocator._ref[p] for p in pinned] == [1, 1]
    assert eng.page_stats()["pages_in_use"] == 2.0


def test_pipeline_depth_two_and_serial_admission_match(model):
    """Depth 2 emits depth 1's streams (hits, the miss, sampled rows);
    ``max_admit_batch=1`` hands ``admit_many`` one request a call."""
    _, _, tparams = model
    (d1,), _, _ = _serve(tparams, page_size=8)
    (d2,), s2, _ = _serve(tparams, page_size=8, depth=2)
    assert d2 == d1 and s2["pipeline_depth"] == 2.0
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    eng = Engine(cfg, tparams, EngineConfig(**POOL), device="cpu")
    eng.register_prefix(TEMPLATE)
    calls = []
    real = eng.admit_many
    eng.admit_many = lambda items: calls.append(len(items)) or real(items)
    sched = Scheduler(eng, max_admit_batch=1)
    for r in _trace():
        sched.submit(r)
    sched.run_until_idle()
    assert calls and set(calls) == {1}
    s = sched.summary()
    assert s["admit_dispatches"] == s["admitted_requests"] == 6.0
    assert {k: c.tokens for k, c in sched.completions.items()} == d1


def test_register_and_match_follow_jax(model):
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    ecfg = EngineConfig(slots=2, max_prompt_len=10, max_seq_len=24,
                        prefix_pool_slots=1)
    eng = Engine(cfg, tparams, ecfg, device="cpu")
    assert eng.prefix_splits == (8,) and eng.prefix_pool_enabled
    template = list(range(1, 10))
    assert eng.register_prefix(template) == 0
    assert eng.register_prefix(template) == 0        # no new page
    assert eng.register_prefix(template[:8]) == 0    # the same stored cut
    with pytest.raises(ValueError, match="full"):
        eng.register_prefix(list(range(20, 29)))
    with pytest.raises(ValueError, match="shorter"):
        eng.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="vocab"):
        eng.register_prefix([VOCAB] * 8)
    assert eng.match_prefix(template[:8] + [50]) == (0, 8)
    assert eng.match_prefix(template[:8]) is None       # no tail
    assert eng.match_prefix([9] + template[:7]) is None
    assert eng.pool_bytes() == 2 * 2 * 1 * 2 * 8 * 64 * 4
    with pytest.raises(ValueError, match="does not match"):
        eng.admit_many([Admission(slot=0, prompt=[9] * 9, max_tokens=2,
                                  prefix_page=0, prefix_len=8)])
    with pytest.raises(ValueError, match="prefix_len 7 is not a usable"):
        eng.admit_many([Admission(slot=0, prompt=template[:8] + [1],
                                  max_tokens=2, prefix_page=0,
                                  prefix_len=7)])
    with pytest.raises(ValueError, match="without prefix_page"):
        eng.admit_many([Admission(slot=0, prompt=template[:8] + [1],
                                  max_tokens=2, prefix_len=8)])
    with pytest.raises(ValueError, match="outside the 1 registered"):
        eng.admit_many([Admission(slot=0, prompt=template[:8] + [1],
                                  max_tokens=2, prefix_page=1,
                                  prefix_len=8)])
    res = eng.admit_many([Admission(slot=1, prompt=template[:8] + [9, 9],
                                    max_tokens=2, prefix_page=0,
                                    prefix_len=8)])[0]
    assert res.bucket == 8 and res.batch_size == 1
    assert eng.prefix_admits == 1 and eng.admit_groups == 0
    cold = Engine(cfg, tparams, dataclasses.replace(
        ecfg, prefix_pool_slots=0), device="cpu")
    assert not cold.prefix_pool_enabled and cold.pool_bytes() == 0
    assert cold.match_prefix(template) is None
    with pytest.raises(ValueError, match="disabled"):
        cold.register_prefix(template)
    with pytest.raises(ValueError, match="prefix pool is disabled"):
        cold.admit_many([Admission(slot=0, prompt=template, max_tokens=2,
                                   prefix_page=0, prefix_len=8)])


def test_failed_registration_resets_the_pool(model):
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    eng = Engine(cfg, tparams, EngineConfig(**{**POOL,
                                               "prefix_pool_slots": 2},
                                            page_size=8), device="cpu")
    t1 = TEMPLATE
    assert eng.register_prefix(t1) == 0
    real = tgpt.cache_insert_slot

    def boom(*a, **kw):
        raise RuntimeError("injected pool-insert failure")

    tgpt.cache_insert_slot = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.register_prefix(list(range(20, 36)))
    finally:
        tgpt.cache_insert_slot = real
    assert eng._prefix_used == 0 and eng.match_prefix(t1 + [5]) is None
    assert eng.page_stats()["pages_in_use"] == 0.0
    assert eng.register_prefix(t1) == 0
    assert eng.match_prefix(t1 + [3]) == (0, 16)


def test_engine_geometry_errors_have_jax_wording(model):
    """Each bad prefix geometry raises the JAX engine's message (both
    raise before building anything)."""
    params, mesh, tparams = model
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    for over in (dict(prefix_pool_slots=-1),
                 dict(max_prompt_len=8, max_seq_len=12,
                      prompt_buckets=(8,)),
                 dict(max_prompt_len=16, max_seq_len=24,
                      prompt_buckets=(4, 12, 16), page_size=8)):
        geom = {**dict(slots=2, max_prompt_len=10, max_seq_len=24,
                       prefix_pool_slots=1), **over}
        with pytest.raises(ValueError) as want:
            JEngine(jcfg, params, mesh, JEngineConfig(**geom))
        with pytest.raises(ValueError) as got:
            Engine(tcfg, tparams, EngineConfig(**geom), device="cpu")
        assert str(got.value) == str(want.value)
    paged = Engine(tcfg, tparams, EngineConfig(
        slots=2, max_prompt_len=16, max_seq_len=24,
        prompt_buckets=(4, 8, 16), prefix_pool_slots=1, page_size=8),
        device="cpu")
    assert paged.prefix_splits == (8,)


def test_submit_never_fits_rule_reads_the_private_need(model):
    """Submit's never-fits guard (JAX's rule) prices a hit at its
    private pages: the shared prefix pages pin, they do not allocate."""
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    eng = Engine(cfg, tparams, EngineConfig(**POOL, page_size=8),
                 device="cpu")
    eng.register_prefix(TEMPLATE)
    sched = Scheduler(eng)
    r = Request("h", TEMPLATE + [1, 2], max_tokens=20)
    sched.submit(r)
    assert sched._prefix_hits["h"] == (0, 16)
    assert sched._request_pages_needed(r) == eng.pages_needed(18, 20, 16) \
        == 5 - 2
    assert eng.pages_needed(18, 20) == 5
