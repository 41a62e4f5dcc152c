"""apex_tpu_torch: the host-swap tier on the CPU, against the JAX package.

Oracles, on one set of weights (a 2-layer GPT, hidden 64, 4 heads, vocab
96, fp32; JAX's init crossed over through numpy), the JAX suite's engine
geometry (3 slots, pages of 8, horizon 32, chunks of 2, admission
batches of 1 or 2) and a 5-request trace of numpy prompts, half greedy
and half seeded-sampled:

- the host units: ``swap_rungs`` / ``plan_rungs``, ``LRUIndex``,
  ``HostPageTier``'s capacity eviction and the allocator's host-tier
  counters give JAX's outputs on the same call sequence;
- ``gpt.cache_gather_pages`` equals JAX's gather byte for byte in bf16,
  fp16, int8 and fp8, is a copy, and the round trip through a host copy
  and ``cache_insert_pages(..., pages[:, None])`` is bit-exact;
  ``Engine.park_slot`` / ``resume_slot`` bring a slot's pages and state
  row back bit for bit, into another slot, after its pages were reused;
- pause after two ticks, then resume, under ``swap``, ``recompute`` and
  ``auto``: the port's streams equal its uninterrupted run's and JAX's
  uninterrupted run's; ``pauses``, ``swap_resumes`` and
  ``recompute_resumes`` equal JAX's paused run's (``auto``'s choice is
  timed, so it is held on streams only); composed with LoRA, spec and
  int8 the same; a host tier of 3 pages downgrades to recompute with
  JAX's counts; a starved pool (5 pages, three tenants, ``preempt=True``)
  gives JAX's streams and preemption count, every finish natural;
- adapter paging: 2 usable rows serving 4 adapters give the streams of an
  all-resident pool and JAX's ``adapter_paging_stats``; without the host
  tier the cap raises; with more cold adapters in one admission batch
  than rows, JAX's engine evicts a row it just paged in for an earlier
  request of the same batch (that request decodes with another adapter's
  weights), while the port pins the batch's rows and its scheduler waits
  for a row instead;
- every replayed request's concatenated ``StreamEvent`` tokens equal its
  completion's; the configuration refusals in JAX's words; the
  ``serve_gpt --host-swap`` demo.

Held against JAX are the greedy streams: the port draws sampled tokens
from its own counter-based noise, not ``jax.random``'s, so its sampled
streams are held against its own uninterrupted run. The schedulers run
on a frozen clock (the tenants' fair-queue picks and the chunk-latency
EWMA then depend on no timing), except ``auto``'s, which needs the
measured latencies it prices with.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import hostswap as jhostswap
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.pages import PageAllocator as JPageAllocator
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.request import SamplingParams as JSamplingParams
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    PageAllocator,
    Request,
    SamplingParams,
    Scheduler,
    hostswap,
)
from apex_tpu_torch.serving.engine import Admission

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
GEOM = dict(slots=3, max_prompt_len=16, max_seq_len=32, decode_chunk=2,
            prompt_buckets=(8, 16), admit_batch_sizes=(1, 2), page_size=8,
            host_swap=True)
LORA = dict(adapter_rank=4, adapter_alpha=8.0)
#: the adapters' std: at the registry's 0.02 a rank-4 adapter moves
#: few greedy tokens of this model
LORA_STD = 0.1
TENANTS = ("t0", "t1", "t2")
PORT = (Request, SamplingParams, Scheduler)
JAX = (JRequest, JSamplingParams, JScheduler)


def frozen():
    return 0.0


def _register(eng, seeds):
    """The adapters of ``seeds`` (``init_lora_weights`` at LORA_STD, the
    same arrays for both packages)."""
    for s in seeds:
        eng.register_adapter(tgpt.init_lora_weights(
            _tcfg(), LORA["adapter_rank"], s, std=LORA_STD),
            name=f"adapter-{s}")


def _greedy(streams):
    """The greedy requests' streams (even request numbers)."""
    return {k: v for k, v in streams.items() if int(k[1:]) % 2 == 0}


def _trace(lib, n=5, mt=12, tenants=None, adapters=0):
    """The JAX suite's trace shape with numpy prompts: prompt length
    ``1 + (7 i + 3) % 14``, odd requests sampled (temperature 0.9, top-k
    20, seed ``i``), ``tenants`` round-robin, request ``i`` on adapter
    ``i % (adapters + 1)``."""
    req_cls, sp_cls, _ = lib
    reqs = []
    for i in range(n):
        prompt = np.random.default_rng(50 + i).integers(
            0, VOCAB, 1 + (7 * i + 3) % 14).tolist()
        sp = (sp_cls(temperature=0.9, top_k=20, seed=i) if i % 2
              else sp_cls())
        reqs.append(req_cls(
            f"r{i}", prompt, max_tokens=mt, sampling=sp,
            tenant=tenants[i % len(tenants)] if tenants else "default",
            adapter=(i % (adapters + 1)) if adapters else 0))
    return reqs


def _run(lib, engine, reqs, **kw):
    sched = lib[2](engine, **{"clock": frozen, **kw})
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return ({rid: c.tokens for rid, c in sched.completions.items()},
            sched.summary(), sched)


def _run_paused(lib, engine, reqs, pause_after=2, resume_after=2, **kw):
    """A few ticks in, pause every active conversation, keep serving,
    resume them all, drain (the JAX suite's drive)."""
    sched = lib[2](engine, **{"clock": frozen, **kw})
    for r in reqs:
        sched.submit(r)
    for _ in range(pause_after):
        sched.step()
    paused = [rid for rid in sorted(a.request.request_id
                                    for a in sched.active.values())
              if sched.pause(rid)]
    assert paused, "nothing was mid-stream to pause"
    for _ in range(resume_after):
        sched.step()
    for rid in paused:
        assert sched.resume(rid)
    sched.run_until_idle()
    return ({rid: c.tokens for rid, c in sched.completions.items()},
            sched.summary(), sched)


COUNTS = ("pauses", "swap_resumes", "recompute_resumes",
          "swap_capacity_drops", "preemptions", "parked_conversations",
          "pages_in_use", "pages_swapped", "swap_bytes")


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jcfg, params, mesh, tparams


def _tcfg(**over):
    return tgpt.GPTConfig(**{**SMALL, "compute_dtype": torch.float32,
                             **over})


def _engines(model, kv="auto", **over):
    """A JAX engine and a port engine of one geometry."""
    jcfg, params, mesh, tparams = model
    geom = {**GEOM, **over}
    jeng = JEngine(dataclasses.replace(jcfg, kv_cache_dtype=kv), params,
                   mesh, JEngineConfig(**geom))
    # JAX's register_adapter refuses an engine before warmup(), which
    # compiles every program up front; marked warm, it compiles each on
    # first use instead, as it does without adapters
    jeng._warmed = True
    teng = Engine(_tcfg(kv_cache_dtype=kv), tparams, EngineConfig(**geom),
                  device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def jax_runs(model):
    """JAX's runs, each built once: the uninterrupted trace, the paused
    runs under ``swap`` and ``recompute``, and the 3-page host tier."""
    out = {}
    for policy, over in (("swap", {}), ("recompute", {}),
                         ("swap3", dict(host_swap_pages=3))):
        jeng, _ = _engines(model, resume_policy=policy.rstrip("3"), **over)
        if policy == "swap":
            out["base"] = _run(JAX, jeng, _trace(JAX))[0]
        toks, summ, _ = _run_paused(JAX, jeng, _trace(JAX))
        out[policy] = (toks, {k: summ[k] for k in COUNTS})
    return out


# -- the host units -----------------------------------------------------------

def _rung_outputs(mod):
    out = [mod.swap_rungs(m) for m in (1, 4, 6, 24, 33)]
    out += [mod.plan_rungs(n) for n in range(0, 40)]
    for bad in ((mod.plan_rungs, -1), (mod.swap_rungs, 0)):
        with pytest.raises(ValueError) as e:
            bad[0](bad[1])
        out.append(str(e.value))
    return out


def test_swap_rungs_match_jax():
    got = _rung_outputs(hostswap)
    assert got == _rung_outputs(jhostswap)
    for n in range(1, 40):
        plan = hostswap.plan_rungs(n)
        assert sum(plan) == n and plan == sorted(plan, reverse=True)
        assert set(plan) <= set(hostswap.swap_rungs(n))


def _lru_ops(mod):
    lru = mod.LRUIndex()
    out = []
    rng = np.random.default_rng(3)
    for _ in range(60):
        op, k = int(rng.integers(0, 4)), int(rng.integers(0, 6))
        if op == 0:
            lru.touch(k)
        elif op == 1:
            lru.discard(k)
        elif op == 2:
            out.append(lru.pop_coldest(
                pinned=set(rng.integers(0, 6, 2).tolist())))
        else:
            out.append((list(lru), len(lru), k in lru))
    return out


def test_lru_index_matches_jax():
    assert _lru_ops(hostswap) == _lru_ops(jhostswap)


def _tier_ops(mod):
    tier = mod.HostPageTier(capacity_pages=4)
    out = [[k for k, _ in tier.park("a", "pay-a", 2, 100)],
           [k for k, _ in tier.park("b", "pay-b", 2, 100)],
           [k for k, _ in tier.park("c", "pay-c", 2, 100)]]
    tier.touch("b")
    out.append([k for k, _ in tier.park("d", "pay-d", 2, 100)])
    out.append([k for k, _ in tier.park("big", "pay", 5, 500)])
    ent = tier.take("b")
    out.append(None if ent is None else (ent.payload, ent.n_pages,
                                         ent.nbytes))
    out.append(tier.take("b"))
    tier.park("e", "pay-e", 1, 10)
    with pytest.raises(ValueError) as e:
        tier.park("e", "again", 1, 1)
    out.append(str(e.value))
    with pytest.raises(ValueError) as e:
        mod.HostPageTier(-1)
    out.append(str(e.value))
    out.append((len(tier), "e" in tier, tier.stats()))
    return out


def test_host_tier_capacity_eviction_matches_jax():
    got = _tier_ops(hostswap)
    assert got == _tier_ops(jhostswap)
    assert got[2] == ["a"] and got[3] == ["c"]


def _alloc_ops(cls):
    a = cls(num_pages=9, page_size=8)
    out = []
    for op, n, b in (("out", 3, 300), ("out", 2, 200), ("in", 3, 300),
                     ("drop", 2, 200), ("out", 4, 400)):
        getattr(a, f"note_swap_{op}")(n, b)
        out.append(a.stats())
    a.reset()                   # the device pool; the host tier survives
    out.append(a.stats())
    return out


def test_page_allocator_host_counters_match_jax():
    got = _alloc_ops(PageAllocator)
    assert got == _alloc_ops(JPageAllocator)
    assert got[-1]["pages_swapped"] == 4.0
    assert got[-1]["swap_outs_total"] == 9.0


# -- the gather and the engine's round trip ------------------------------------

_TORCH_DT = {"bf16": torch.bfloat16, "fp16": torch.float16}
_NP_DT = {"bf16": ml_dtypes.bfloat16, "fp16": np.float16}


def _pool_planes(kind, rng, shape):
    """Random finite bit patterns of one pool, as numpy planes: ``{"kv":
    ...}`` plus ``"scale"`` for a quantized kind (XLA rewrites a NaN's
    payload when it moves one, so NaNs stay out)."""
    if kind in _NP_DT:
        dt = np.uint16
        bits = rng.integers(0, 2 ** 16, shape, dtype=dt)
        vals = bits.view(_NP_DT[kind])
        bits[~np.isfinite(vals.astype(np.float32))] = 0
        return {"kv": bits.view(_NP_DT[kind])}
    q = rng.integers(0, 256, shape, dtype=np.uint8)
    q[(q & 0x7F) == 0x7F] = 0          # the fp8 NaNs
    q = q.view(np.int8) if kind == "int8" else q.view(
        ml_dtypes.float8_e4m3fn)
    return {"kv": q, "scale": rng.normal(size=shape[:-1]).astype(
        np.float32)}


def _torch_plane(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _raw(t):
    """A tensor's bytes as a numpy array (any dtype, fp8 included)."""
    t = t.contiguous()
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.view({2: torch.int16, 4: torch.int32}[t.element_size()]
                    ).numpy()


def _planes(c):
    return c if isinstance(c, dict) else {"kv": c}


@pytest.mark.parametrize("kind", ["bf16", "fp16", "int8", "fp8"])
def test_cache_gather_pages_matches_jax_and_round_trips(kind):
    rng = np.random.default_rng(11)
    planes = _pool_planes(kind, rng, (2, 2, 9, 4, 8, 16))
    tcache = {k: _torch_plane(v) for k, v in planes.items()}
    if kind in _NP_DT:
        tcache = tcache["kv"]
    pages = [3, 1, 7]
    got = tgpt.cache_gather_pages(tcache, pages)
    want = jgpt.cache_gather_pages(
        {k: jnp.asarray(v) for k, v in planes.items()},
        np.asarray(pages, np.int32))
    for k, g in _planes(got).items():
        assert g.dtype == _planes(tcache)[k].dtype
        assert g.shape[2] == len(pages)
        w = np.asarray(want[k])
        np.testing.assert_array_equal(_raw(g), w.view(_raw(g).dtype))
    # a copy, not a view: later writes to the pool do not reach it
    host = tgpt._cache_map(lambda t: t.clone(), got)
    for c in _planes(tcache).values():
        c.view(torch.uint8)[:, :, pages] = 0
    assert all(np.array_equal(_raw(a), _raw(b)) for a, b in zip(
        _planes(got).values(), _planes(host).values()))
    tgpt.cache_insert_pages(tcache, host, [[p] for p in pages],
                            page_size=8)
    for k, v in planes.items():
        np.testing.assert_array_equal(_raw(_planes(tcache)[k]),
                                      v.view(_raw(_planes(tcache)[k]).dtype))


@pytest.mark.parametrize("kind", ["bf16", "fp16", "int8", "fp8"])
def test_park_resume_slot_round_trips_bit_for_bit(model, kind):
    """Park slot 0 after a decode chunk, let a new request take slot 0 and
    the freed pages and decode over them, then resume the conversation
    into slot 2: its pages and its state row are the parked ones, bit for
    bit."""
    tparams = model[3]
    if kind in _TORCH_DT:
        cfg = _tcfg(compute_dtype=_TORCH_DT[kind])
    else:
        cfg = _tcfg(kv_cache_dtype=kind)
    eng = Engine(cfg, tparams, EngineConfig(**{**GEOM, "spec_k": 2,
                                               "spec_hist": 8}),
                 device="cpu")
    rng = np.random.default_rng(5)
    eng.admit_many([
        Admission(slot=s, prompt=rng.integers(0, VOCAB, 9).tolist(),
                  max_tokens=14, temperature=0.9 * s, top_k=20, seed=s)
        for s in (0, 1)])
    eng.step()
    priv = eng._slot_pages[0][0]
    pages0 = tgpt._cache_map(lambda t: t.clone(),
                             tgpt.cache_gather_pages(eng.cache, priv))
    row0 = {k: v[0].clone() for k, v in eng.state.items()}
    free0 = eng.page_allocator.free_pages
    assert eng.park_slot(0, "a") == []
    assert eng.page_allocator.free_pages == free0 + len(priv)
    assert bool(eng.state["done"][0]) and 0 not in eng._slot_pages
    nbytes = sum(t.numel() * t.element_size()
                 for t in _planes(pages0).values())
    assert eng.parked_pages("a") == len(priv)
    assert eng.parked_bytes("a") == nbytes
    assert eng.host_tier_stats()["pages"] == len(priv)
    assert eng.page_stats()["swap_bytes"] == nbytes
    # the freed pages go to another request, which decodes over them
    eng.admit_many([Admission(slot=0, prompt=[1, 2, 3], max_tokens=20)])
    assert set(eng._slot_pages[0][0]) & set(priv)
    eng.step()
    with pytest.raises(ValueError, match="still holds a page mapping"):
        eng.resume_slot(0, "a")
    eng.resume_slot(2, "a")
    back = tgpt.cache_gather_pages(eng.cache, eng._slot_pages[2][0])
    for a, b in zip(_planes(back).values(), _planes(pages0).values()):
        np.testing.assert_array_equal(_raw(a), _raw(b))
    for k, v in row0.items():
        assert torch.equal(eng.state[k][2], v), k
    assert not eng.host_parked("a") and eng.parked_pages("a") == 0
    ps = eng.page_stats()
    assert ps["pages_swapped"] == 0 and ps["swap_ins_total"] == len(priv)
    assert eng.swap_in_cost_s(2) > 0
    eng.free_slot(1)
    with pytest.raises(KeyError):
        eng.resume_slot(1, "a")


# -- pause / resume parity ------------------------------------------------------

@pytest.mark.parametrize("policy", ["swap", "recompute", "auto"])
def test_pause_resume_matches_jax(model, jax_runs, policy):
    _, teng = _engines(model, resume_policy=policy)
    base = _run(PORT, teng, _trace(PORT))[0]
    assert _greedy(base) == _greedy(jax_runs["base"])
    kw = {} if policy != "auto" else dict(clock=time.monotonic)
    toks, summ, sched = _run_paused(PORT, teng, _trace(PORT), **kw)
    assert toks == base
    assert summ["parked_conversations"] == 0.0
    assert summ["pages_in_use"] == 0.0 and summ["pages_swapped"] == 0.0
    if policy == "auto":
        assert summ["swap_resumes"] + summ["recompute_resumes"] \
            == summ["pauses"] >= 1.0
        return
    jtoks, jcounts = jax_runs[policy]
    assert _greedy(jtoks) == _greedy(base)
    assert {k: summ[k] for k in COUNTS} == jcounts
    assert summ[f"{policy}_resumes"] >= 1.0


@pytest.mark.parametrize("kind", ["lora", "spec", "int8"])
def test_pause_resume_composed_matches_jax(model, kind):
    over, kv, adapters, pause_after = dict(resume_policy="swap"), "auto", 0, 2
    if kind == "lora":
        over.update(adapter_slots=3, **LORA)
        adapters = 2
    elif kind == "spec":
        # one tick: a wave emits up to decode_chunk x (spec_k + 1) tokens
        over.update(spec_k=2, spec_hist=12)
        pause_after = 1
    else:
        kv = "int8"
    jeng, teng = _engines(model, kv=kv, **over)
    for eng in (jeng, teng):
        _register(eng, range(70, 70 + adapters))
    want = _run(JAX, jeng, _trace(JAX, adapters=adapters))[0]
    base = _run(PORT, teng, _trace(PORT, adapters=adapters))[0]
    toks, summ, _ = _run_paused(PORT, teng, _trace(PORT, adapters=adapters),
                                pause_after=pause_after)
    assert _greedy(base) == _greedy(want)
    assert toks == base
    assert summ["swap_resumes"] >= 1.0


def test_host_tier_capacity_downgrades_like_jax(model, jax_runs):
    _, teng = _engines(model, resume_policy="swap", host_swap_pages=3)
    toks, summ, sched = _run_paused(PORT, teng, _trace(PORT))
    jtoks, jcounts = jax_runs["swap3"]
    assert _greedy(toks) == _greedy(jtoks) == _greedy(jax_runs["base"])
    assert toks == _run(PORT, teng, _trace(PORT))[0]
    assert {k: summ[k] for k in COUNTS} == jcounts
    assert summ["swap_capacity_drops"] >= 1.0
    assert summ["recompute_resumes"] >= 1.0 and summ["swap_resumes"] >= 1.0
    _check_events(sched)


def _check_events(sched):
    """Each request's streamed tokens, concatenated, are its completion's
    (a replay streams no re-derived token twice, and drops none)."""
    streamed = {}
    for e in sched.events:
        if e.token is not None:
            streamed.setdefault(e.request_id, []).append(e.token)
    for rid, c in sched.completions.items():
        assert streamed.get(rid, []) == c.tokens, rid


def test_recompute_replay_streams_each_token_once(model):
    _, teng = _engines(model, resume_policy="recompute")
    _, summ, sched = _run_paused(PORT, teng, _trace(PORT))
    assert summ["recompute_resumes"] >= 1.0
    _check_events(sched)


@pytest.mark.parametrize("n", [5, 9])
def test_preempt_starved_pool_matches_jax(model, jax_runs, n):
    """Five pages (the sink and two 2-page conversations) for three
    tenants: admission pressure preempts, the victims replay, and every
    stream is the unstarved one. JAX's preemption count and step count
    are the port's; with 9 requests both storm (a victim's re-derived
    tokens charge no service, so its tenant stays ahead and is preempted
    again mid-replay): 37 preemptions for 9 requests."""
    jeng, teng = _engines(model, num_pages=5)
    out = []
    for lib, eng in ((JAX, jeng), (PORT, teng)):
        toks, summ, sched = _run(lib, eng, _trace(lib, n=n,
                                                  tenants=TENANTS),
                                 preempt=True)
        reasons = {rid: c.finish_reason
                   for rid, c in sched.completions.items()}
        out.append((toks, (summ["preemptions"], summ["steps"]), reasons,
                    sched))
    (jtoks, jcounts, _, _), (toks, counts, reasons, sched) = out
    assert _greedy(toks) == _greedy(jtoks)
    _, ample = _engines(model)
    assert toks == _run(PORT, ample, _trace(PORT, n=n, tenants=TENANTS))[0]
    if n == 5:
        assert _greedy(toks) == _greedy(jax_runs["base"])
    assert counts == jcounts and counts[0] >= 1.0
    if n == 9:
        assert counts[0] >= 3 * n
    assert all(r in ("stop", "length", "eos") for r in reasons.values())
    _check_events(sched)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_parked_and_replaying_deadlines_match_jax(model, policy):
    """Deadlines past while parked (``swap``: the resume waits for a
    slot) or while the replay waits in the queue (``recompute``): each
    such request times out with the stream its client saw, as JAX's
    does."""
    jeng, teng = _engines(model, resume_policy=policy)
    out = []
    for lib, eng in ((JAX, jeng), (PORT, teng)):
        clock = _Clock()
        sched = lib[2](eng, clock=clock)
        for r in _trace(lib):
            r.deadline = 5.0
            sched.submit(r)
        for _ in range(2):
            sched.step()
        paused = sorted(a.request.request_id for a in sched.active.values())
        for rid in paused:
            assert sched.pause(rid)
        sched.step()
        for rid in paused:
            assert sched.resume(rid)
        clock.t = 10.0
        sched.run_until_idle()
        assert not sched.parked_requests
        ends = [e for e in sched.events if e.finished]
        out.append(({k: (c.finish_reason, c.tokens)
                     for k, c in sched.completions.items()},
                    sorted((e.request_id, e.finish_reason) for e in ends)))
    (jcomp, jends), (tcomp, tends) = out
    assert tends == jends
    assert {k: v[0] for k, v in tcomp.items()} == \
        {k: v[0] for k, v in jcomp.items()}
    assert _greedy({k: v[1] for k, v in tcomp.items()}) == \
        _greedy({k: v[1] for k, v in jcomp.items()})
    # the parked ones timed out with what they had streamed, not nothing
    assert all(tcomp[rid][0] == "timeout" and len(tcomp[rid][1]) >= 2
               for rid in paused)


def test_preempt_needs_the_host_tier(model):
    _, _, _, tparams = model
    eng = Engine(_tcfg(), tparams, EngineConfig(
        **{**GEOM, "host_swap": False}), device="cpu")
    with pytest.raises(ValueError, match="preempt=True needs"):
        Scheduler(eng, preempt=True)
    assert not Scheduler(eng).preempt
    with pytest.raises(ValueError, match="needs EngineConfig.host_swap"):
        Scheduler(eng).pause("r0")


# -- adapter paging ---------------------------------------------------------------

SEEDS = (70, 71, 72, 73)


def test_adapter_paging_matches_resident_pool_and_jax(model):
    runs = {}
    for slots in (len(SEEDS) + 1, 3):
        jeng, teng = _engines(model, adapter_slots=slots,
                              resume_policy="swap", **LORA)
        for lib, eng in ((JAX, jeng), (PORT, teng)):
            _register(eng, SEEDS)
            toks, summ, _ = _run(lib, eng, _trace(lib, n=8,
                                                  adapters=len(SEEDS)))
            runs[(slots, lib is JAX)] = (toks, eng.adapter_paging_stats())
    resident, paged = runs[(5, False)], runs[(3, False)]
    assert paged[0] == resident[0]
    # the adapters move streams: the same prompts on the base model differ
    base = _run(PORT, teng, _trace(PORT, n=8))[0]
    assert sum(paged[0][k] != base[k] for k in base) >= 2
    assert _greedy(paged[0]) == _greedy(runs[(5, True)][0]) \
        == _greedy(runs[(3, True)][0])
    assert paged[1] == runs[(3, True)][1]
    assert paged[1]["registered"] == 4.0 and paged[1]["rows"] == 2.0
    assert paged[1]["spills_total"] >= 1.0
    assert paged[1]["pageins_total"] >= 1.0


def test_adapter_hard_cap_without_host_tier(model):
    _, _, _, tparams = model
    eng = Engine(_tcfg(), tparams, EngineConfig(
        **{**GEOM, "host_swap": False, "adapter_slots": 2, **LORA}),
        device="cpu")
    eng.register_adapter(seed=70)
    with pytest.raises(ValueError, match="adapter pool full"):
        eng.register_adapter(seed=71)
    assert eng.adapter_paging_stats() is None


def test_one_batch_with_more_cold_adapters_than_rows(model):
    """Three requests on three adapters in one admission batch of a pool
    with two rows: JAX's engine pages adapter 3 into the row it paged
    adapter 1 into for the batch's first request, which then decodes
    with adapter 3's weights; the port's engine refuses the batch, and
    its scheduler admits two and keeps the third waiting for a row. Every
    port stream is its request's on an all-resident pool."""
    geom = dict(admit_batch_sizes=(1, 3), resume_policy="swap", **LORA)
    prompts = [np.random.default_rng(90 + i).integers(0, VOCAB, 6).tolist()
               for i in range(3)]
    reqs = lambda lib: [lib[0](f"a{i}", prompts[i], max_tokens=8,
                               adapter=i + 1) for i in range(3)]
    jeng, teng = _engines(model, adapter_slots=3, **geom)
    _, reng = _engines(model, adapter_slots=4, **geom)
    jres, _ = _engines(model, adapter_slots=4, **geom)
    for eng in (jeng, teng, reng, jres):
        _register(eng, SEEDS[:3])
    want = _run(PORT, reng, reqs(PORT))[0]
    assert _run(JAX, jres, reqs(JAX))[0] == want
    jgot = _run(JAX, jeng, reqs(JAX))[0]
    assert jgot["a0"] != want["a0"]             # the reference's caveat
    assert jgot["a1"] == want["a1"] and jgot["a2"] == want["a2"]
    with pytest.raises(ValueError, match="adapter pool thrash"):
        teng.admit_many([Admission(slot=i, prompt=prompts[i], max_tokens=8,
                                   adapter=i + 1) for i in range(3)])
    got, summ, _ = _run(PORT, teng, reqs(PORT))
    assert got == want
    assert summ["adapter_waits"] >= 1.0


# -- refusals and the example -----------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(resume_policy="sometimes"), dict(host_swap_pages=-1),
    dict(page_size=0), dict(host_swap=False, host_swap_pages=4)])
def test_engine_refusals_match_jax(model, over):
    msgs = []
    for eng_cls, cfg_cls, args in (
            (JEngine, JEngineConfig, (model[0], model[1], model[2])),
            (Engine, EngineConfig, (_tcfg(), model[3]))):
        with pytest.raises(ValueError) as e:
            kw = {} if eng_cls is JEngine else dict(device="cpu")
            eng_cls(*args, cfg_cls(**{**GEOM, **over}), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _serve(*flags):
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.examples.serve_gpt",
         "--preset", "tiny", "--device", "cpu", "--page-size", "8",
         *flags], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.splitlines()


def test_example_park_and_resume_demo():
    plain = _serve()
    demo = _serve("--host-swap", "--resume-policy", "swap")
    parked = [line for line in demo if line.startswith("parked ")]
    assert parked == ["parked 2 conversation(s) to host RAM (swap "
                      "resume): ['r0', 'r1']"]
    assert any(line.startswith("host tier: ") for line in demo)
    streams = lambda lines: [line for line in lines
                             if line.startswith("request r")]
    assert len(streams(demo)) == 6 and streams(demo) == streams(plain)


def test_example_host_swap_needs_pages():
    from apex_tpu_torch.examples import serve_gpt

    with pytest.raises(SystemExit, match="--host-swap needs --page-size"):
        serve_gpt.main(["--preset", "tiny", "--device", "cpu",
                        "--host-swap"])
