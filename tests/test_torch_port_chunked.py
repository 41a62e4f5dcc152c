"""apex_tpu_torch: chunked prefill and the pipelined scheduler on the CPU.

Oracles:

- greedy streams of chunked admissions (a long prompt admitted one
  ``prefill_chunk`` forward a tick, chunk 0 a cold prefill, the rest
  ``gpt.prefill_extend``) through the port's ``Scheduler`` — contiguous,
  paged and int8 — token-identical to JAX's solo ``generate``; every
  stream, sampled ones included, identical to the port's monolithic
  admissions; ``chunked_admissions`` and ``chunked_chunks`` counted as JAX
  counts them;
- ``pipeline_depth=2`` emits depth 1's streams on a trace that mixes
  prefix hits, a chunked admission and cold ones, and no chunk it
  dispatches is all pad;
- the engine's chunked API (``admit_chunked_start`` /
  ``admit_chunked_step``) and its refusals; the ``prefill_chunk`` and
  scheduler-knob validation errors with JAX's wording.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.scheduler import Scheduler as JScheduler
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

#: bench's chunked A/B cut to the small model: prompts up to 32 admitted
#: in chunks of 8 (bench: 256 in chunks of 64)
GEOM = dict(slots=3, max_prompt_len=32, max_seq_len=48, decode_chunk=2,
            admit_batch_sizes=(1, 2))
CHUNK = 8
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
    """Two long prompts (30 tokens: chunk 0 and three extends, the last
    one partial; 17: chunk 0, two extends) first, then short ones; odd
    requests sampled with a seed."""
    lens = [30, 3, 17, 5, 1, 8]
    reqs = []
    for i, n in enumerate(lens):
        prompt = np.random.default_rng(600 + i).integers(0, VOCAB,
                                                         n).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=5, seed=i) if i % 2
              else SamplingParams())
        reqs.append(Request(f"c{i}", prompt, max_tokens=N_NEW, sampling=sp))
    return reqs


def _serve(tparams, kind="auto", chunk=CHUNK, **kw):
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                         kv_cache_dtype=kind)
    over = {k: kw.pop(k) for k in ("page_size",) if k in kw}
    eng = Engine(cfg, tparams, EngineConfig(**GEOM, prefill_chunk=chunk,
                                            **over), device="cpu")
    sched = Scheduler(eng, **kw)
    for r in _trace():
        sched.submit(r)
    sched.run_until_idle()
    return ({k: c.tokens for k, c in sched.completions.items()},
            sched.summary(), eng)


_JAX_SOLO = {}


def _jax_greedy(model, kind):
    """JAX's solo greedy ``generate`` of each greedy request."""
    if kind not in _JAX_SOLO:
        params, mesh, _ = model
        jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32,
                              kv_cache_dtype=kind)
        gen = jax.jit(jax.shard_map(
            lambda p, t: jgpt.generate(jcfg, p, t, N_NEW), mesh=mesh,
            in_specs=(jgpt.param_specs(jcfg), P()), out_specs=P(),
            check_vma=False))
        _JAX_SOLO[kind] = {
            r.request_id: np.asarray(gen(params, jnp.asarray(
                [r.prompt], jnp.int32)))[0].tolist()
            for r in _trace() if r.sampling.temperature == 0.0}
    return _JAX_SOLO[kind]


@pytest.mark.parametrize("kind,paged", [("auto", False), ("auto", True),
                                        ("int8", False)])
def test_chunked_streams_match_jax_solo_and_monolithic(model, kind, paged):
    _, _, tparams = model
    over = dict(page_size=8) if paged else {}
    got, s, eng = _serve(tparams, kind, **over)
    mono, s_mono, _ = _serve(tparams, kind, chunk=0, **over)
    assert got == mono
    want = _jax_greedy(model, kind)
    assert {rid: got[rid] for rid in want} == want
    # JAX counts chunk 0 and every extend: 4 + 3 forwards, 2 admissions
    assert s["chunked_admissions"] == 2.0 and s["chunked_chunks"] == 7.0
    assert eng.chunk_prefills == 7
    assert "chunked_admissions" not in s_mono
    if paged:
        assert s["pages_in_use"] == 0.0


def test_chunked_admission_interleaves_decode(model):
    """While the 30-token prompt admits, the short ones already decode:
    each tick runs one chunk forward and one decode chunk."""
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    eng = Engine(cfg, tparams, EngineConfig(**GEOM, prefill_chunk=CHUNK),
                 device="cpu")
    sched = Scheduler(eng)
    reqs = _trace()
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()         # c1 admits, c0 starts (chunk 0), c1 decodes
    assert sched._chunked is not None
    assert [a.request.request_id for a in sched.active.values()] == ["c1"]
    assert sched.summary()["chunked_chunks"] == 1.0
    steps0 = eng.decode_steps_taken
    sched.step()         # extend 1, a decode chunk
    sched.step()         # extend 2
    sched.step()         # extend 3 (the partial last chunk)
    assert sched._chunked is not None
    assert eng.decode_steps_taken > steps0
    sched.step()         # the finish: c0 occupies its slot
    assert sched._chunked is None
    assert "c0" in [a.request.request_id for a in sched.active.values()]
    sched.run_until_idle()
    assert sched.summary()["chunked_chunks"] == 4.0


def test_pipeline_depth_two_equals_depth_one(model):
    """Depth 2 emits depth 1's streams with prefix hits, a chunked
    admission and cold ones in the trace, keeps chunks in flight, and
    never dispatches a chunk that cannot emit a token."""
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    template = _trace()[0].prompt[:16]
    reqs = _trace() + [Request(f"h{i}", template + [7 + i] * (1 + i),
                               max_tokens=N_NEW) for i in range(3)]
    out = {}
    for depth in (1, 2):
        eng = Engine(cfg, tparams, EngineConfig(
            **GEOM, prefill_chunk=CHUNK, prefix_pool_slots=1,
            prompt_buckets=(8, 16, 32), page_size=8), device="cpu")
        eng.register_prefix(template)
        sched = Scheduler(eng, pipeline_depth=depth)
        inflight = []
        real = sched._dispatch_chunk

        def spy():
            went = real()
            inflight.append(len(sched._inflight))
            return went

        sched._dispatch_chunk = spy
        for r in reqs:
            sched.submit(r)
        sched.run_until_idle()
        s = sched.summary()
        # c0 starts with the template: a hit, never chunked; c2 chunks
        assert s["prefix_hits"] == 4.0 and s["chunked_admissions"] == 1.0
        assert s["pages_in_use"] == 2.0 and s["pages_shared"] == 0.0
        out[depth] = ({k: c.tokens for k, c in sched.completions.items()},
                      max(inflight), eng.decode_steps_taken)
    assert out[2][0] == out[1][0]
    assert out[1][1] == 1 and out[2][1] == 2
    # the guard: depth 2 never runs more decode steps than needed to give
    # the longest-lived slot its budget plus the chunks already in flight
    assert out[2][2] <= out[1][2] + GEOM["decode_chunk"]


def test_chunked_engine_api_and_refusals(model):
    _, _, tparams = model
    cfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    eng = Engine(cfg, tparams, EngineConfig(**GEOM, prefill_chunk=CHUNK),
                 device="cpu")
    assert eng.chunked_prefill_enabled
    assert eng.chunked_for(9) and not eng.chunked_for(8)
    long_p = _trace()[0].prompt
    with pytest.raises(ValueError, match="fits one 8-token chunk"):
        eng.admit_chunked_start(Admission(slot=0, prompt=long_p[:8],
                                          max_tokens=2))
    ca = eng.admit_chunked_start(Admission(slot=0, prompt=long_p,
                                           max_tokens=N_NEW))
    assert ca.chunks_total == 4 and ca.next_chunk == 1
    with pytest.raises(RuntimeError, match="already in progress"):
        eng.admit_chunked_start(Admission(slot=1, prompt=long_p,
                                          max_tokens=2))
    steps = []
    while True:
        res = eng.admit_chunked_step(ca)
        if res is not None:
            break
        steps.append(ca.next_chunk)
    assert steps == [2, 3, 4] and ca.done_prefilling
    assert res.bucket == CHUNK and res.batch_size == 1
    with pytest.raises(ValueError, match="stale"):
        eng.admit_chunked_step(ca)
    solo = tgpt.generate(cfg, tparams, torch.tensor([long_p]), 1,
                         device="cpu")[0].tolist()
    assert res.first_token == solo[0]
    off = Engine(cfg, tparams, EngineConfig(**GEOM), device="cpu")
    assert not off.chunked_prefill_enabled and not off.chunked_for(30)
    with pytest.raises(ValueError, match="chunked prefill disabled"):
        off.admit_chunked_start(Admission(slot=0, prompt=long_p,
                                          max_tokens=2))
    pool = Engine(cfg, tparams, EngineConfig(
        **GEOM, prefill_chunk=CHUNK, prefix_pool_slots=1), device="cpu")
    pool.register_prefix(long_p[:16])
    with pytest.raises(ValueError, match="does not compose with prefix"):
        pool.admit_chunked_start(Admission(slot=0, prompt=long_p,
                                           max_tokens=2, prefix_page=0,
                                           prefix_len=16))


@pytest.mark.parametrize("over", [
    dict(prefill_chunk=-1), dict(prefill_chunk=12),
    dict(prefill_chunk=32), dict(prefill_chunk=16, max_prompt_len=24,
                                 prompt_buckets=(8, 16, 24))],
    ids=["negative", "not-a-bucket", "not-smaller", "not-dividing"])
def test_prefill_chunk_errors_have_jax_wording(model, over):
    params, mesh, tparams = model
    geom = {**GEOM, **over}
    with pytest.raises(ValueError) as want:
        JEngine(jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32), params,
                mesh, JEngineConfig(**geom))
    with pytest.raises(ValueError) as got:
        Engine(tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32),
               tparams, EngineConfig(**geom), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(pipeline_depth=0),
                                dict(max_admit_batch=0)])
def test_scheduler_knob_errors_have_jax_wording(model, kw):
    _, _, tparams = model
    with pytest.raises(ValueError) as want:
        JScheduler(None, **kw)
    eng = Engine(tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32),
                 tparams, EngineConfig(**GEOM), device="cpu")
    with pytest.raises(ValueError) as got:
        Scheduler(eng, **kw)
    assert str(got.value) == str(want.value)
