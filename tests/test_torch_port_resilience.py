"""apex_tpu_torch: fault injection, the health machine and recovery, on
the CPU, against the JAX package.

Oracles, on one set of weights (a 2-layer GPT, hidden 64, 4 heads, vocab
96, fp32; JAX's init crossed over through numpy), JAX's chaos-suite
geometry (2 slots, prompts up to 8, horizon 24, chunks of 2) and, paged,
pages of 8 with one pooled 8-token prefix that half the trace hits:

- fault plans: ``FaultPlan.random``, ``FleetFaultPlan.random`` /
  ``.kill`` and ``parse_fault_plan`` draw JAX's specs and raise JAX's
  errors; ``HealthMonitor`` under one event script gives JAX's
  transitions, ``healthz()`` bodies and Prometheus text, byte for byte;
- each seam (admit error and nan, dispatch error, fetch error and nan,
  retire error, a hang against the watchdog, nan in a released lane), on
  the contiguous and the paged cache: the greedy streams equal the port's
  unfaulted run and JAX's unfaulted run token for token (sampled ones the
  port's own unfaulted run: its sampler is its own), the events carry
  each token once, and the fault, retry, rebuild, replay and watchdog
  counters equal JAX's under the same plan, trace and fake clock;
- a poisoned engine refuses until ``rebuild_slots()``, which works in
  place (the same tensors, the prefix pages' bytes kept);
- the limits: retry exhaustion ends in ``error`` completions, a rebuild
  storm fails terminally without crashing (then ``EngineFailed``, and the
  API server's ``/healthz`` and chat answer 503), ``QueueFull`` gives its
  hint under a flood, deadline shedding, the tuner's ``watchdog`` and
  ``rebuild`` freezes and the flight recorder's events; the chaos smoke
  (its randomized soak is slow, as in JAX).
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import resilience as jres
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.request import SamplingParams as JSamplingParams
from apex_tpu.serving.scheduler import QueueFull as JQueueFull
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu.telemetry import Registry as JRegistry
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    resilience,
)
from apex_tpu_torch.serving.scheduler import QueueFull
from apex_tpu_torch.telemetry import (
    FlightRecorder,
    Registry,
    parse_prometheus_text,
)

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
GEOM = {
    "contiguous": dict(slots=2, max_prompt_len=8, max_seq_len=24,
                       decode_chunk=2),
    "paged": dict(slots=2, max_prompt_len=16, max_seq_len=32,
                  decode_chunk=2, prompt_buckets=(8, 16), page_size=8,
                  prefix_pool_slots=1),
}
PREFIX = [int(t) for t in np.random.default_rng(99).integers(0, VOCAB, 8)]
#: the counters a faulted run must share with JAX's
COUNTS = ("rebuilds", "retries", "retry_exhausted", "watchdog_trips",
          "shed", "evicted_requests", "health_state", "requests_completed",
          "tokens_emitted")
FAMILIES = ("serving_faults_detected_total", "serving_retries_total",
            "serving_rebuilds_total", "serving_watchdog_trips_total",
            "serving_replayed_tokens_total", "serving_requests_shed_total",
            "serving_health_state", "serving_health_transitions_total",
            "serving_requests_finished_total")


class _Lib:
    """One package's serving surface, so a helper drives either."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.Request = JRequest if jax_side else Request
        self.SamplingParams = JSamplingParams if jax_side else SamplingParams
        self.Scheduler = JScheduler if jax_side else Scheduler
        self.res = jres if jax_side else resilience
        self.Registry = JRegistry if jax_side else Registry


PORT, JAX = _Lib(False), _Lib(True)


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jcfg, params, mesh, tparams


_TCFG = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_engines(model):
    """One JAX engine a layout, reused by every JAX run of the module
    (a run sets its plan and rebuilds the slots first)."""
    jcfg, params, mesh, _ = model
    out = {}
    for layout, geom in GEOM.items():
        eng = JEngine(jcfg, params, mesh, JEngineConfig(**geom))
        if layout == "paged":
            eng.register_prefix(PREFIX)
        out[layout] = eng
    return out


def _port_engine(model, layout, plan=None, **over):
    eng = Engine(_TCFG, model[3], EngineConfig(**{**GEOM[layout], **over}),
                 device="cpu", fault_plan=plan)
    if layout == "paged":
        eng.register_prefix(PREFIX)
    return eng


def _trace(lib, layout, n=3, seed0=7000, max_tokens=7):
    """JAX's chaos trace shape with numpy prompts: prompt length ``2 +
    3i % 6``, odd requests sampled (temperature 0.9, top-k 7, their own
    seed); paged, the even ones start with the pooled prefix."""
    out = []
    for i in range(n):
        prompt = np.random.default_rng(seed0 + i).integers(
            0, VOCAB, 2 + (3 * i) % 6).tolist()
        if layout == "paged" and i % 2 == 0:
            prompt = PREFIX + prompt[:2]
        sp = (lib.SamplingParams(temperature=0.9, top_k=7, seed=seed0 + i)
              if i % 2 else lib.SamplingParams())
        out.append(lib.Request(f"c{i}", prompt, max_tokens=max_tokens,
                               sampling=sp))
    return out


def _plan(lib, specs, now):
    return lib.res.FaultPlan(
        [lib.res.FaultSpec(*s[:3], **(s[3] if len(s) > 3 else {}))
         for s in specs],
        hang_fn=lambda s: now.__setitem__(0, now[0] + s))


def _serve(lib, engine, reqs, now, *, rcfg=None, mid=None, **kw):
    """Submit ``reqs`` and serve to idle on the fake clock ``now`` (backoffs
    and hangs advance it); ``mid(sched, now)`` runs after the first tick.
    Returns the scheduler, the completions' streams and each request's
    streamed tokens (its events, concatenated)."""
    sched = lib.Scheduler(
        engine, clock=lambda: now[0],
        sleep=lambda s: now.__setitem__(0, now[0] + s),
        resilience=lib.res.ResilienceConfig(**(rcfg or dict(
            backoff_base_s=0.005))), registry=lib.Registry(), **kw)
    for r in reqs:
        sched.submit(r)
    if mid is not None:
        sched.step()
        mid(sched, now)
    sched.run_until_idle()
    streamed = {}
    for e in list(sched.events):
        if e.token is not None:
            streamed.setdefault(e.request_id, []).append(e.token)
    return sched, {k: c.tokens for k, c in sched.completions.items()}, \
        streamed


def _counts(sched):
    s = sched.summary()
    text = sched._registry.to_prometheus_text()
    fams = parse_prometheus_text(text)
    return ({k: s[k] for k in COUNTS},
            {f: fams.get(f) for f in FAMILIES})


def _retire_scenario(lib, layout, n=None, **_):
    """JAX's retire-seam drive: a request whose deadline lands after the
    first chunk (its retire is the faulted call) beside a batch-mate."""
    doomed = lib.Request("doomed", [1, 2, 3], max_tokens=10, deadline=5.0)
    mate = _trace(lib, layout, n=1, seed0=7950, max_tokens=8)[0]
    return [doomed, mate]


def _deadline_mid(sched, now):
    now[0] = 6.0


#: seam -> (plan specs, trace kwargs, scheduler kwargs, resilience kwargs)
SEAMS = {
    "admit_error": ([("admit", 0, "error")], {}, {}, {}),
    "admit_nan": ([("admit", 0, "nan", {"slots": (0,)})], {}, {}, {}),
    "dispatch_error": ([("dispatch", 1, "error")], {},
                       {"pipeline_depth": 2}, {}),
    "fetch_error": ([("fetch", 1, "error")], {}, {"pipeline_depth": 2},
                    {}),
    "fetch_nan": ([("fetch", 1, "nan", {"slots": (1,)})], {}, {}, {}),
    "retire_error": ([("retire", 0, "error")], "retire", {},
                     {"backoff_base_s": 0.0}),
    "hang_watchdog": ([("fetch", 1, "hang", {"hang_s": 35.0})], {}, {},
                      {"watchdog_timeout_s": 30.0, "recovery_chunks": 2}),
    "nan_released_lane": ([("fetch", 1, "nan", {"slots": (1,)})],
                          {"n": 1, "max_tokens": 8}, {}, {}),
}


def _requests(lib, layout, how):
    if how == "retire":
        return _retire_scenario(lib, layout)
    return _trace(lib, layout, **how)


@pytest.fixture(scope="module")
def clean_runs(model, jax_engines):
    """Each (layout, seam)'s unfaulted streams, the port's and JAX's,
    built on first use."""
    cache = {}

    def get(layout, seam):
        _, how, kw, _ = SEAMS[seam]
        key = (layout, json.dumps(how, sort_keys=True), json.dumps(kw))
        if key not in cache:
            mid = _deadline_mid if how == "retire" else None
            _, port, _ = _serve(PORT, _port_engine(model, layout),
                                _requests(PORT, layout, how), [0.0],
                                mid=mid, **kw)
            jeng = jax_engines[layout]
            jeng.fault_plan = None
            jeng.rebuild_slots()
            _, jx, _ = _serve(JAX, jeng, _requests(JAX, layout, how),
                              [0.0], mid=mid, **kw)
            cache[key] = port, jx
        return cache[key]
    return get


@pytest.mark.parametrize("layout", list(GEOM))
@pytest.mark.parametrize("seam", list(SEAMS))
def test_fault_at_each_seam_matches_unfaulted_and_jax(model, jax_engines,
                                                      clean_runs, seam,
                                                      layout):
    specs, how, kw, rkw = SEAMS[seam]
    mid = _deadline_mid if how == "retire" else None
    rcfg = {"backoff_base_s": 0.005, **rkw}
    base_port, base_jax = clean_runs(layout, seam)
    now = [0.0]
    plan = _plan(PORT, specs, now)
    sched, got, streamed = _serve(
        PORT, _port_engine(model, layout, plan),
        _requests(PORT, layout, how), now, rcfg=rcfg, mid=mid, **kw)
    jnow = [0.0]
    jplan = _plan(JAX, specs, jnow)
    jeng = jax_engines[layout]
    jeng.fault_plan = jplan
    jeng.rebuild_slots()
    jsched, jgot, _ = _serve(JAX, jeng, _requests(JAX, layout, how), jnow,
                             rcfg=rcfg, mid=mid, **kw)
    jeng.fault_plan = None
    assert len(plan.injected) == len(specs) == len(jplan.injected)
    assert plan.counts() == jplan.counts()
    # every stream is the unfaulted run's; the greedy ones JAX's too
    assert got == base_port
    reqs = _requests(PORT, layout, how)
    greedy = [r.request_id for r in reqs if r.sampling.temperature == 0]
    assert greedy and all(got[r] == base_jax[r] == jgot[r]
                          for r in greedy), (got, jgot)
    # each streamed token once, in order, despite the replay
    for r in reqs:
        assert streamed.get(r.request_id, []) == got[r.request_id]
    assert sched.summary()["tokens_emitted"] == sum(
        len(t) for t in got.values())
    counts, families = _counts(sched)
    assert (counts, families) == _counts(jsched)
    if seam == "hang_watchdog":
        assert counts["watchdog_trips"] == 1 and counts["rebuilds"] == 0
    else:
        assert counts["rebuilds"] == 1
    assert not sched.engine.poisoned
    if layout == "paged":
        # the registered prefix survived the rebuild: hits after it
        assert sched.summary()["prefix_hits"] >= 1
        assert sched.engine.page_stats()["pages_in_use"] == 1


# -- fault plans and the health machine ----------------------------------------


def _plan_rows(mod):
    out = []
    for seed in (0, 1, 11, 12, 12345):
        for kw in ({}, dict(points=("fetch", "retire", "submit"),
                            max_index=5, slots=3, hang_s=0.25)):
            out.append([dataclasses.asdict(s) for s in
                        mod.FaultPlan.random(seed, 6, **kw).specs])
    for seed, n in ((3, 2), (7, 3)):
        fp = mod.FleetFaultPlan.random(seed, n, 4, max_index=9)
        out.append([[dataclasses.asdict(s) for s in p.specs] for p in fp])
        out.append(fp.describe())
    kp = mod.FleetFaultPlan.kill(1, 3, at=5, rebuilds=2)
    out.append([[dataclasses.asdict(s) for s in p.specs] for p in kp])
    out.append(kp.describe())
    for text in ("fetch:2:nan:1,dispatch:5:error,fetch:7:hang:0.5",
                 "random:3:4", "random:9", " submit:0:flood "):
        p = mod.parse_fault_plan(text)
        out.append([dataclasses.asdict(s) for s in p.specs])
        out.append([s.describe() for s in p.specs])
    plan = mod.FaultPlan([mod.FaultSpec("fetch", 1, "nan", slots=(1,)),
                          mod.FaultSpec("admit", 0, "error")])
    seen = []
    plan.on_inject = lambda s: seen.append(s.describe())
    out.append([None if s is None else s.describe() for s in (
        plan.take("fetch"), plan.take("fetch"), plan.take("fetch"),
        plan.take("admit"), plan.take("admit"))])
    out.append((plan.counts(), seen, len(plan.injected)))
    plan.reset()
    out.append((plan.counts(), plan.injected))
    cfg = mod.ResilienceConfig(backoff_base_s=0.05, backoff_factor=3.0)
    out.append([cfg.backoff_s(a) for a in range(0, 5)])
    out.append(dataclasses.asdict(mod.ResilienceConfig()))
    return out


def _plan_errors(mod):
    out = []
    for bad in ([mod.FaultSpec("teleport", 0, "error")],
                [mod.FaultSpec("dispatch", 0, "nan")],
                [mod.FaultSpec("fetch", -1, "error")],
                [mod.FaultSpec("fetch", 1, "error"),
                 mod.FaultSpec("fetch", 1, "hang")]):
        with pytest.raises(ValueError) as e:
            mod.FaultPlan(bad)
        out.append(str(e.value))
    for call in (lambda: mod.parse_fault_plan("fetch:1"),
                 lambda: mod.FleetFaultPlan([]),
                 lambda: mod.FleetFaultPlan.random(1, 0),
                 lambda: mod.FleetFaultPlan.kill(2, 2),
                 lambda: mod.HealthMonitor(recovery_chunks=0)):
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("what", ["specs", "errors"])
def test_fault_plans_match_jax(what):
    fn = _plan_rows if what == "specs" else _plan_errors
    assert fn(resilience) == fn(jres)


def _health_script(mod, reg_cls):
    reg = reg_cls()
    seen = []
    h = mod.HealthMonitor(registry=reg, recovery_chunks=2,
                          on_transition=lambda *a: seen.append(a))
    out = [(h.state, h.code, h.healthz())]
    for op, arg in (("record_fault", "watchdog"), ("record_progress", None),
                    ("record_progress", None), ("begin_drain", None),
                    ("record_fault", "fetch"), ("end_drain", None),
                    ("record_progress", None), ("begin_drain", None),
                    ("begin_drain", None), ("end_drain", None),
                    ("record_fault", "queue_full"), ("fail", "storm"),
                    ("record_fault", "x"), ("record_progress", None),
                    ("begin_drain", None), ("end_drain", None)):
        getattr(h, op)(*(() if arg is None else (arg,)))
        out.append((op, h.state, h.code, h.last_cause, h.healthz()))
    return out, seen, reg.to_prometheus_text()


def test_health_machine_matches_jax_byte_for_byte():
    got = _health_script(resilience, Registry)
    want = _health_script(jres, JRegistry)
    assert got == want
    assert got[0][-1][1] == "failed"
    assert "serving_health_transitions_total" in got[2]


# -- the engine: poisoning and the in-place rebuild -----------------------------


def test_poisoned_engine_refuses_until_rebuild(model):
    plan = resilience.FaultPlan([resilience.FaultSpec("dispatch", 0,
                                                      "error")])
    eng = _port_engine(model, "contiguous", plan)
    eng.admit(0, [1, 2, 3], 5)
    with pytest.raises(resilience.EngineFault, match="injected"):
        eng.step_async()
    assert eng.poisoned and eng.describe()["poisoned"]
    for call in (eng.step_async, lambda: eng.admit(1, [4], 2),
                 lambda: eng.retire(0)):
        with pytest.raises(resilience.EngineFault, match="poisoned"):
            call()
    eng.rebuild_slots()
    assert not eng.poisoned
    eng.admit(0, [1, 2, 3], 5)
    eng.step()
    # an injected fetch error poisons through the handle; a fetch seam is
    # taken on the first fetch only
    plan = resilience.FaultPlan([resilience.FaultSpec("fetch", 0, "error")])
    eng = _port_engine(model, "contiguous", plan)
    eng.admit(0, [1, 2, 3], 5)
    h = eng.step_async()
    with pytest.raises(resilience.InjectedFault):
        h.fetch()
    assert eng.poisoned and plan.counts()["fetch"] == 1


def test_rebuild_is_in_place_and_keeps_the_prefix_pages(model):
    eng = _port_engine(model, "paged")
    page = eng._prefix_pages[0]
    pinned = eng.cache[:, :, page].clone()
    sched, before, _ = _serve(PORT, eng, _trace(PORT, "paged"), [0.0])
    eng.admit(0, PREFIX + [5, 6], 4)
    eng.step()
    planes = [eng.cache] + list(eng.state.values())
    ptrs = [t.data_ptr() for t in planes]
    tables = eng._tables_dev
    assert tables is not None
    eng.rebuild_slots()
    assert [t.data_ptr() for t in
            [eng.cache] + list(eng.state.values())] == ptrs
    # the block table's device copy too: written, not dropped
    assert eng._tables_dev is tables and not tables.any()
    assert torch.equal(eng.cache[:, :, page], pinned)
    others = [p for p in range(eng._num_pages) if p not in page]
    assert not eng.cache[:, :, others].any()
    assert bool(eng.state["done"].all()) and not eng.state["pos"].any()
    assert eng.page_stats()["pages_in_use"] == len(page)
    # a prefix hit after the rebuild streams what it streamed before
    _, after, _ = _serve(PORT, eng, _trace(PORT, "paged"), [0.0])
    assert after == before


# -- the limits ----------------------------------------------------------------


def _storm(lib, engine):
    now = [0.0]
    plan = _plan(lib, [("admit", i, "error") for i in range(6)], now)
    engine.fault_plan = plan
    if lib.jax:
        engine.rebuild_slots()
    sched, got, _ = _serve(lib, engine, _trace(lib, "contiguous", n=2),
                           now, rcfg=dict(max_retries=10,
                                          backoff_base_s=0.001,
                                          max_consecutive_rebuilds=2))
    engine.fault_plan = None
    return sched, got


def test_rebuild_storm_fails_terminally_and_the_api_answers_503(
        model, jax_engines):
    sched, got = _storm(PORT, _port_engine(model, "contiguous"))
    jsched, jgot = _storm(JAX, jax_engines["contiguous"])
    assert sched.health.state == jsched.health.state == "failed"
    assert {k: c.finish_reason for k, c in sched.completions.items()} == \
        {k: c.finish_reason for k, c in jsched.completions.items()} == \
        {"c0": "error", "c1": "error"}
    assert _counts(sched) == _counts(jsched)
    with pytest.raises(resilience.EngineFailed):
        sched.submit(Request("late", [1, 2], max_tokens=2))
    sched.step()                 # a terminal tick does nothing
    assert sched.health.healthz() == jsched.health.healthz()
    from apex_tpu_torch.serving.api import start_api_server

    # the front end's byte-level codec needs a vocab of 256: the same
    # storm on a model of that width
    cfg256 = tgpt.GPTConfig(**{**SMALL, "vocab_size": 256,
                               "seq_len": 128},
                            compute_dtype=torch.float32)
    eng = Engine(cfg256, tgpt.init(cfg256, torch.Generator().manual_seed(0),
                                   device="cpu"),
                 EngineConfig(slots=2, max_prompt_len=64, max_seq_len=96,
                              decode_chunk=2), device="cpu")
    sched, _ = _storm(PORT, eng)
    assert sched.health.state == "failed"
    api = start_api_server(sched, port=0)
    try:
        try:
            urllib.request.urlopen(api.url + "/healthz", timeout=30)
            status, body = 200, ""
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read().decode("utf-8")
        assert (status, body) == (503, sched.health.healthz()[1])
        req = urllib.request.Request(
            api.url + "/v1/chat/completions", method="POST",
            data=json.dumps({"messages": [{"role": "user",
                                           "content": "hi"}],
                             "max_tokens": 2}).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        err = json.loads(e.value.read().decode("utf-8"))["error"]
        assert err["code"] == "engine_failed"
    finally:
        api.stop()


def _exhaust(lib, engine):
    now = [0.0]
    plan = _plan(lib, [("admit", i, "nan", {"slots": (0,)})
                       for i in range(3)], now)
    engine.fault_plan = plan
    if lib.jax:
        engine.rebuild_slots()
    victim, survivor = _trace(lib, "contiguous", n=2, seed0=7500)
    sched, got, _ = _serve(lib, engine, [victim, survivor], now,
                           rcfg=dict(max_retries=2, backoff_base_s=0.0))
    engine.fault_plan = None
    finals = [(e.request_id, e.finish_reason, bool(e.error))
              for e in list(sched.events) if e.error is not None]
    return sched, got, finals


def test_retry_exhaustion_ends_in_error_completions(model, jax_engines):
    sched, got, finals = _exhaust(
        PORT, _port_engine(model, "contiguous", slots=1))
    jeng = JEngine(*model[:3], JEngineConfig(
        **{**GEOM["contiguous"], "slots": 1}))
    jsched, jgot, jfinals = _exhaust(JAX, jeng)
    assert finals == jfinals
    assert sched.completions["c0"].finish_reason == "error"
    # the survivor (sampled) streams what it streams alone, JAX's length
    _, alone, _ = _serve(PORT, _port_engine(model, "contiguous", slots=1),
                         _trace(PORT, "contiguous", n=2, seed0=7500)[1:],
                         [0.0])
    assert got["c0"] == [] and got["c1"] == alone["c1"]
    assert len(got["c1"]) == len(jgot["c1"])
    assert _counts(sched) == _counts(jsched)
    assert sched.summary()["retries"] == 2.0


def _flood(lib, engine):
    now = [0.0]
    engine.fault_plan = _plan(lib, [("submit", 2, "flood")], now)
    reg = lib.Registry()
    sched = lib.Scheduler(engine, max_queue=1, registry=reg,
                          clock=lambda: now[0])
    sched._chunk_ewma = 0.25
    sched.submit(lib.Request("a", [1, 2], max_tokens=2))
    out = []
    qf = QueueFull if not lib.jax else JQueueFull
    for rid in ("b", "c"):
        if rid == "c":
            sched.queue.clear()
        with pytest.raises(qf) as e:
            sched.submit(lib.Request(rid, [1, 2], max_tokens=2))
        out.append((str(e.value), e.value.queue_depth,
                    e.value.retry_after_s))
    engine.fault_plan = None
    shed = parse_prometheus_text(reg.to_prometheus_text())[
        "serving_requests_shed_total"]
    return out, sched.health.state, shed


def test_queue_full_hint_under_a_flood(model, jax_engines):
    got = _flood(PORT, _port_engine(model, "contiguous"))
    assert got == _flood(JAX, jax_engines["contiguous"])
    assert "injected flood" in got[0][1][0] and got[1] == "degraded"


def _shedding(lib, engine):
    now = [100.0]
    reg = lib.Registry()
    sched = lib.Scheduler(engine, clock=lambda: now[0], registry=reg,
                          sleep=lambda s: now.__setitem__(0, now[0] + s))
    sched._chunk_ewma = 1.0
    sched.submit(lib.Request("hog", [1, 2, 3], max_tokens=4))
    sched.submit(lib.Request("doomed", [1, 2], max_tokens=2,
                             deadline=now[0] + 0.5))
    sched.submit(lib.Request("fine", [1, 2], max_tokens=2,
                             deadline=now[0] + 300.0))
    sched.step()
    first = {k: (c.finish_reason, c.tokens)
             for k, c in sched.completions.items()}
    sched.run_until_idle()
    sched.submit(lib.Request("tight", [4, 5], max_tokens=2,
                             deadline=now[0] + 0.5))
    sched.run_until_idle()
    fams = parse_prometheus_text(reg.to_prometheus_text())
    return (first, {k: (c.finish_reason, c.tokens)
                    for k, c in sched.completions.items()},
            fams["serving_requests_shed_total"],
            fams["serving_queue_expired_total"])


def test_deadline_shedding_matches_jax(model):
    jeng = JEngine(*model[:3], JEngineConfig(
        **{**GEOM["contiguous"], "slots": 1}))
    got = _shedding(PORT, _port_engine(model, "contiguous", slots=1))
    assert got == _shedding(JAX, jeng)
    assert got[0] == {"doomed": ("timeout", [])}
    assert got[1]["fine"][0] == got[1]["tight"][0] == "length"


def test_tuner_freezes_and_flight_recorder_events(model, tmp_path):
    from apex_tpu_torch.serving.tuner import TunerConfig
    from apex_tpu_torch.telemetry import flightrec

    now = [0.0]
    plan = _plan(PORT, [("fetch", 1, "hang", {"hang_s": 35.0}),
                        ("dispatch", 3, "error")], now)
    eng = _port_engine(model, "contiguous", plan, decode_chunks=(1, 2))
    rec = FlightRecorder()
    sched, got, _ = _serve(
        PORT, eng, _trace(PORT, "contiguous"), now,
        rcfg=dict(backoff_base_s=0.005, watchdog_timeout_s=30.0),
        recorder=rec, bundle_dir=str(tmp_path),
        tuner=TunerConfig(decode_chunk=(1, 2)))
    events = [e[2] for e in rec.events()]
    for kind in ("inject", "watchdog", "fault", "rebuild", "replay",
                 "retry", "health", "bundle"):
        assert kind in events, kind
    causes = {e[3][1] for e in rec.events()
              if e[2] == "tuner_freeze" and e[3][0] == "enter"}
    assert {"watchdog", "rebuild"} <= causes
    # the auto-dumped bundles carry the plan and the health
    bundle = flightrec.read_bundle(sched.bundles_written[0])
    assert bundle["fault_plan.json"]["injected"][0]["kind"] == "hang"
    assert bundle["config.json"]["scheduler"]["resilience"][
        "watchdog_timeout_s"] == 30.0
    assert bundle["manifest.json"]["health"]["state"] in ("degraded", "ok")


def _chaos(lib, engine, seed, n_reqs, n_faults):
    now = [0.0]
    plan = lib.res.FaultPlan.random(seed, n_faults, max_index=20, slots=3,
                                    hang_s=0.0,
                                    hang_fn=lambda s: now.__setitem__(
                                        0, now[0] + s))
    engine.fault_plan = plan
    sched = lib.Scheduler(
        engine, pipeline_depth=2, clock=lambda: now[0],
        sleep=lambda s: now.__setitem__(0, now[0] + s),
        resilience=lib.res.ResilienceConfig(backoff_base_s=0.002,
                                            max_retries=4))
    reqs = _trace(lib, "contiguous", n=n_reqs, seed0=8000 + seed,
                  max_tokens=6)
    pending = list(reqs)
    while pending or sched.queue or sched.active or sched._inflight:
        for r in pending[:2]:
            sched.submit(r)
        pending = pending[2:]
        sched.step()
        wait = sched._backoff_wait_s()
        if wait is not None:
            sched.sleep(wait)
    engine.fault_plan = None
    return plan, sched


def _chaos_check(model, jax_engines, seed, n_reqs, n_faults):
    geom = dict(GEOM["contiguous"], slots=3)
    clean = Engine(_TCFG, model[3], EngineConfig(**geom), device="cpu")
    _, base = _chaos(PORT, clean, seed, n_reqs, 0)
    plan, sched = _chaos(PORT, Engine(_TCFG, model[3], EngineConfig(**geom),
                                      device="cpu"), seed, n_reqs, n_faults)
    jeng = JEngine(*model[:3], JEngineConfig(**geom))
    jplan, jsched = _chaos(JAX, jeng, seed, n_reqs, n_faults)
    assert [s.describe() for s in plan.injected] == \
        [s.describe() for s in jplan.injected]
    errored = {k for k, c in sched.completions.items()
               if c.finish_reason == "error"}
    assert len(sched.completions) == n_reqs
    for k, c in sched.completions.items():
        if k not in errored:
            assert c.tokens == base.completions[k].tokens, k
    keys = ("rebuilds", "retries", "retry_exhausted", "requests_completed")
    assert {k: sched.summary()[k] for k in keys} == \
        {k: jsched.summary()[k] for k in keys}


def test_chaos_smoke(model, jax_engines):
    _chaos_check(model, jax_engines, seed=1, n_reqs=5, n_faults=3)


@pytest.mark.slow
def test_chaos_soak_randomized(model, jax_engines):
    for seed in (1, 2, 3):
        _chaos_check(model, jax_engines, seed=seed, n_reqs=10, n_faults=4)
