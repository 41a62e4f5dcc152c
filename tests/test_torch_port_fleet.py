"""apex_tpu_torch: the fleet router on the CPU, against the JAX package.

Replicas are 2-slot engines of one tiny GPT (2 layers, hidden 64, vocab
96, fp32; JAX's init crossed over through numpy) sharing the weights, on
one fake clock (backoffs advance it). Oracles:

- ``FleetConfig``'s and the router's validation in JAX's words;
- a clean 2-replica fleet streams what one replica streams;
- replica 1 killed mid-burst (``FleetFaultPlan.kill``): every stream
  equals the one-replica run (the greedy ones JAX's), each token streamed
  once, ``/healthz`` 200 throughout, the victim's bundle linked from the
  fleet incident manifest, and the router's counters equal JAX's router
  under the same plan and clock;
- a request whose retries run out fails over instead of erroring; the
  breaker trips on the watchdog, evicts, cools and readmits; a drain
  rebuilds and readmits with nothing shed; ``restart`` replaces a failed
  replica from the factory; the fleet's ``QueueFull`` and
  ``EngineFailed``;
- ``ApiServer(router)`` serves a fleet, and answers 503 once none is
  left; the chaos smoke (its randomized soak is slow, as in JAX).
"""

import collections
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import fleet as jfleet
from apex_tpu.serving import resilience as jres
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.request import SamplingParams as JSamplingParams
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu.telemetry import FlightRecorder as JFlightRecorder
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    fleet,
    resilience,
)
from apex_tpu_torch.serving.scheduler import QueueFull
from apex_tpu_torch.telemetry import FlightRecorder, Registry

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
GEOM = dict(slots=2, max_prompt_len=8, max_seq_len=24, decode_chunk=2)
_TCFG = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)


class _Lib:
    def __init__(self, jax_side):
        self.jax = jax_side
        self.Request = JRequest if jax_side else Request
        self.SamplingParams = JSamplingParams if jax_side else SamplingParams
        self.Scheduler = JScheduler if jax_side else Scheduler
        self.res = jres if jax_side else resilience
        self.fleet = jfleet if jax_side else fleet


PORT, JAX = _Lib(False), _Lib(True)


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jcfg, params, mesh, tparams


class _Clock:
    """One fake clock the replicas share: sleeping advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _mk_sched(lib, model, plan=None, *, clock, slots=2, retries=8,
              engine=None, **kw):
    jcfg, params, mesh, tparams = model
    geom = dict(GEOM, slots=slots)
    if engine is None:
        engine = (JEngine(jcfg, params, mesh, JEngineConfig(**geom),
                          fault_plan=plan) if lib.jax else
                  Engine(_TCFG, tparams, EngineConfig(**geom),
                         device="cpu", fault_plan=plan))
    kw.setdefault("resilience", lib.res.ResilienceConfig(
        max_retries=retries, backoff_base_s=0.001,
        watchdog_timeout_s=600.0))
    return lib.Scheduler(engine, clock=clock, sleep=clock.sleep, **kw)


def _reqs(lib, n, *, seed0=7000, max_tokens=6):
    """JAX's fleet trace shape with numpy prompts: greedy and seeded
    sampled requests alternating."""
    out = []
    for i in range(n):
        prompt = np.random.default_rng(seed0 + i).integers(
            0, VOCAB, 2 + (3 * i) % 6).tolist()
        sp = (lib.SamplingParams(temperature=0.9, top_k=7, seed=seed0 + i)
              if i % 2 else lib.SamplingParams())
        out.append(lib.Request(f"f{seed0}_{i}", prompt,
                               max_tokens=max_tokens, sampling=sp))
    return out


@pytest.fixture(scope="module")
def ref_sched(model):
    """One clean replica every oracle's reference run goes through (the
    traces' ids differ, so they stack on it)."""
    return _mk_sched(PORT, model, clock=_Clock())


def _reference(ref, reqs):
    for r in reqs:
        ref.submit(r)
    ref.run_until_idle()
    return {r.request_id: ref.completions[r.request_id].tokens
            for r in reqs}


def _drive(router):
    """Run the fleet to idle, collecting each request's streamed tokens
    and the fleet's /healthz status every tick."""
    streamed = collections.defaultdict(list)
    statuses = []
    while not router.idle():
        router.step()
        statuses.append(router.health.healthz()[0])
        for ev in router.pop_events():
            if ev.token is not None:
                streamed[ev.request_id].append(ev.token)
        router._maybe_sleep()
    return streamed, statuses


def _validation(lib):
    out = []
    for kw in (dict(breaker_guard_alarms=0), dict(max_failovers=0),
               dict(breaker_cooldown_steps=0),
               dict(breaker_watchdog_trips=0)):
        with pytest.raises(ValueError) as e:
            lib.fleet.FleetConfig(**kw)
        out.append(str(e.value))
    return out


def test_fleet_config_and_router_validation(model):
    assert _validation(PORT) == _validation(JAX)
    clock = _Clock()
    s0 = _mk_sched(PORT, model, clock=clock)
    s1 = _mk_sched(PORT, model, clock=clock)
    with pytest.raises(ValueError, match="at least one replica"):
        fleet.Router([])
    with pytest.raises(ValueError, match="distinct"):
        fleet.Router([s0, s0])
    other = _mk_sched(PORT, model, clock=clock, engine=Engine(
        _TCFG, model[3], EngineConfig(**dict(GEOM, decode_chunk=1)),
        device="cpu"))
    with pytest.raises(ValueError, match="configs differ"):
        fleet.Router([s0, other])
    router = fleet.Router([s0, s1])
    with pytest.raises(ValueError, match="exactly one router"):
        fleet.Router([s0, s1])
    with fleet.Router([_mk_sched(PORT, model, clock=clock)]) as r2:
        assert r2.engine is r2.replicas[0].sched.engine
    router.close()
    assert s0.on_evict is None and s1.on_evict is None
    # the port has no recompile guard: the guard_alarm breaker reads 0
    assert s0._guard_alarm_count() == 0.0


def test_router_routes_and_streams_match_single_replica(model, ref_sched):
    reqs = _reqs(PORT, 8, seed0=7100)
    want = _reference(ref_sched, reqs)
    clock = _Clock()
    registry, rec = Registry(), FlightRecorder()
    with fleet.Router([_mk_sched(PORT, model, clock=clock),
                       _mk_sched(PORT, model, clock=clock)],
                      registry=registry, recorder=rec,
                      clock=clock) as router:
        for r in reqs:
            router.submit(r)
        streamed, statuses = _drive(router)
        for r in reqs:
            comp = router.completions[r.request_id]
            assert comp.tokens == want[r.request_id]
            assert streamed[r.request_id] == comp.tokens
        assert set(statuses) == {200}
        s = router.summary()
        assert s["routed"] == len(reqs) and s["failover_waves"] == 0
        assert all(rep.routed > 0 for rep in router.replicas)
        routed = registry.counter("serving_fleet_routed_total",
                                  labels=("replica",))
        assert sum(c.value for c in routed.children()) == len(reqs)
        assert any(e[2] == "route" for e in rec.events())
        with pytest.raises(ValueError, match="duplicate"):
            router.submit(reqs[0])


#: the router counters a JAX fleet must share
ROUTER_KEYS = ("replicas", "replicas_routable", "requests_completed",
               "routed", "steps", "failover_waves", "failed_over_requests",
               "aborted_requests", "pending_failovers", "drains",
               "restarts", "queue_full", "incidents", "health_state",
               "tokens_emitted", "replica0_health", "replica0_routed",
               "replica1_health", "replica1_routed")


def _kill_run(lib, model, tmp_path, reqs):
    clock = _Clock()
    plans = lib.res.FleetFaultPlan.kill(1, 2, at=2)
    bundle_dir = str(tmp_path / ("jax" if lib.jax else "port"))
    rec = JFlightRecorder() if lib.jax else FlightRecorder()
    scheds = [_mk_sched(lib, model, plans[i], clock=clock,
                        bundle_dir=bundle_dir, recorder=rec)
              for i in range(2)]
    router = lib.fleet.Router(scheds, recorder=rec, bundle_dir=bundle_dir,
                              clock=clock)
    for r in reqs:
        router.submit(r)
    streamed, statuses = _drive(router)
    router.close()
    return router, scheds, streamed, statuses, rec, plans


def test_kill_one_replica_mid_burst_streams_bit_identical(model, ref_sched,
                                                          tmp_path):
    reqs = _reqs(PORT, 8, seed0=7200)
    want = _reference(ref_sched, reqs)
    router, scheds, streamed, statuses, rec, plans = _kill_run(
        PORT, model, tmp_path, reqs)
    assert len(plans.injected) == 4
    assert scheds[1].health.state == "failed"
    assert router.replicas[1].state == fleet.REPLICA_FAILED
    assert set(statuses) == {200}
    for r in reqs:
        comp = router.completions[r.request_id]
        assert comp.finish_reason != "error"
        assert comp.tokens == want[r.request_id]
        assert streamed[r.request_id] == comp.tokens
    # the victim's bundle, linked from the fleet's incident manifest
    assert scheds[1].bundles_written
    assert len(router.incidents_written) == 1
    with open(os.path.join(router.incidents_written[0],
                           "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["replica"] == 1
    assert manifest["replica_bundles"] == scheds[1].bundles_written
    names = [e[2] for e in rec.events()]
    assert "failover" in names and "route" in names
    # JAX's router under the same plan and clock: the same counters, the
    # same greedy streams
    jrouter, jscheds, _, jstatuses, _, jplans = _kill_run(
        JAX, model, tmp_path, _reqs(JAX, 8, seed0=7200))
    s, js = router.summary(), jrouter.summary()
    assert {k: s[k] for k in ROUTER_KEYS} == {k: js[k] for k in ROUTER_KEYS}
    assert statuses == jstatuses
    assert [x.describe() for x in plans.injected] == \
        [x.describe() for x in jplans.injected]
    for r in reqs:
        if r.sampling.temperature == 0:
            assert router.completions[r.request_id].tokens == \
                jrouter.completions[r.request_id].tokens
    for sc, jsc in zip(scheds, jscheds):
        keys = ("rebuilds", "retries", "evicted_requests", "health_state")
        assert {k: sc.summary()[k] for k in keys} == \
            {k: jsc.summary()[k] for k in keys}


def test_retry_exhaustion_fails_over_instead_of_erroring(model, ref_sched):
    reqs = _reqs(PORT, 4, seed0=7300)
    want = _reference(ref_sched, reqs)
    clock = _Clock()
    plan = resilience.FaultPlan([resilience.FaultSpec("dispatch", i,
                                                      "error")
                                 for i in (1, 2, 3)])
    scheds = [_mk_sched(PORT, model, plan if i == 1 else None,
                        clock=clock, retries=2) for i in range(2)]
    with fleet.Router(scheds, clock=clock) as router:
        for r in reqs:
            router.submit(r)
        router.run_until_idle()
        assert scheds[1].health.state != "failed"
        for r in reqs:
            comp = router.completions[r.request_id]
            assert comp.finish_reason != "error"
            assert comp.tokens == want[r.request_id]
        assert router.summary()["failed_over_requests"] >= 1
        assert scheds[1].summary()["retry_exhausted"] >= 1


def test_breaker_trips_on_watchdog_evicts_and_cools(model, ref_sched):
    reqs = _reqs(PORT, 6, seed0=7400)
    want = _reference(ref_sched, reqs)
    now = [0.0]

    def clock():
        # every reading a millisecond on: each chunk's wall is positive
        now[0] += 0.001
        return now[0]

    clock.sleep = lambda s: now.__setitem__(0, now[0] + s)
    scheds = [
        _mk_sched(PORT, model, clock=clock),
        _mk_sched(PORT, model, clock=clock,
                  resilience=resilience.ResilienceConfig(
                      max_retries=8, backoff_base_s=0.001,
                      watchdog_timeout_s=0.0)),
    ]
    cfg = fleet.FleetConfig(breaker_watchdog_trips=2,
                            breaker_cooldown_steps=5)
    with fleet.Router(scheds, config=cfg, clock=clock) as router:
        for r in reqs:
            router.submit(r)
        saw_cooling = False
        while not router.idle():
            router.step()
            saw_cooling |= router.replicas[1].state == fleet.REPLICA_COOLING
            router._maybe_sleep()
        assert saw_cooling, "the breaker never opened"
        while router.replicas[1].state == fleet.REPLICA_COOLING:
            assert not router.idle()
            router.step()
        assert router.replicas[1].state == fleet.REPLICA_LIVE
        for r in reqs:
            assert router.completions[r.request_id].tokens == \
                want[r.request_id]
        assert router.summary()["failover_waves"] >= 1


def test_drain_rebuild_readmit_zero_shed(model, ref_sched):
    reqs = _reqs(PORT, 10, seed0=7500)
    want = _reference(ref_sched, reqs)
    clock = _Clock()
    rec = FlightRecorder()
    scheds = [_mk_sched(PORT, model, clock=clock) for _ in range(2)]
    with fleet.Router(scheds, recorder=rec, clock=clock) as router:
        for r in reqs:
            router.submit(r)
        for _ in range(2):
            router.step()
        assert scheds[1].active
        router.drain(1)
        assert router.replicas[1].state == fleet.REPLICA_LIVE
        router.run_until_idle()
        for r in reqs:
            comp = router.completions[r.request_id]
            assert comp.finish_reason != "error"
            assert comp.tokens == want[r.request_id]
        assert router.summary()["drains"] == 1
        assert sum(sc.summary()["shed"] for sc in scheds) == 0
        phases = [e[3][1] for e in rec.events() if e[2] == "drain"]
        assert phases == ["begin", "idle", "rebuilt", "readmit"]
        router.submit(Request("after_drain", [3, 5], max_tokens=3))
        router.run_until_idle()
        assert "after_drain" in router.completions


def test_restart_replaces_failed_replica_from_factory(model):
    clock = _Clock()
    plans = resilience.FleetFaultPlan.kill(1, 2, at=1)
    built = []

    def factory(i):
        built.append(i)
        return _mk_sched(PORT, model, clock=clock)

    scheds = [_mk_sched(PORT, model, plans[i], clock=clock)
              for i in range(2)]
    with fleet.Router(scheds, factory=factory, clock=clock) as router:
        for r in _reqs(PORT, 6, seed0=7600):
            router.submit(r)
        router.run_until_idle()
        assert router.replicas[1].state == fleet.REPLICA_FAILED
        with pytest.raises(ValueError, match="terminally failed"):
            router.drain(1)
        router.restart(1)
        assert built == [1] and router.replicas[1].routable()
        router.submit(Request("post_restart", [2, 4, 6], max_tokens=3))
        router.run_until_idle()
        assert "post_restart" in router.completions
        assert router.summary()["restarts"] == 1


def test_fleet_queue_full_and_engine_failed(model):
    clock = _Clock()
    s0 = _mk_sched(PORT, model, clock=clock, max_queue=2)
    s1 = _mk_sched(PORT, model, clock=clock, max_queue=2)
    with fleet.Router([s0, s1], clock=clock) as router:
        assert router.can_accept(4) and not router.can_accept(5)
        for r in _reqs(PORT, 4, seed0=7700):
            router.submit(r)
        with pytest.raises(QueueFull) as e:
            router.submit(Request("overflow", [1, 2], max_tokens=2))
        assert e.value.retry_after_s >= 0.0
        assert router.summary()["queue_full"] == 1.0
        router.run_until_idle()
        for rep in router.replicas:
            rep.sched.health.fail("test")
        router.step()
        assert router.health.healthz()[0] == 503
        assert not router.can_accept(1)
        with pytest.raises(resilience.EngineFailed):
            router.submit(Request("dead", [1], max_tokens=1))


def test_api_server_serves_a_fleet_and_503s_when_none_stands():
    from apex_tpu_torch.serving.api import start_api_server

    # the byte-level codec needs a vocab of 256
    cfg = tgpt.GPTConfig(**{**SMALL, "vocab_size": 256, "seq_len": 128},
                         compute_dtype=torch.float32)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    scheds = [Scheduler(Engine(cfg, params, EngineConfig(
        slots=2, max_prompt_len=64, max_seq_len=96), device="cpu"))
        for _ in range(2)]
    router = fleet.Router(scheds)
    api = start_api_server(router, port=0)

    def post():
        req = urllib.request.Request(
            api.url + "/v1/chat/completions", method="POST",
            data=json.dumps({"messages": [{"role": "user",
                                           "content": "hi"}],
                             "max_tokens": 3}).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def healthz():
        try:
            with urllib.request.urlopen(api.url + "/healthz",
                                        timeout=30) as resp:
                return resp.status, resp.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode("utf-8")

    try:
        status, body = post()
        assert status == 200
        assert body["usage"]["completion_tokens"] == 3
        assert healthz() == (200, "ok (r0=ok r1=ok)\n")
        for s in scheds:
            s.health.fail("test")
        assert healthz()[0] == 503
        status, body = post()
        assert status == 503 and body["error"]["code"] == "engine_failed"
    finally:
        api.stop()
        router.close()


def _chaos_fleet(model, ref, seed, n_reqs, kill_at):
    reqs = _reqs(PORT, n_reqs, seed0=9000 + seed)
    want = _reference(ref, reqs)
    clock = _Clock()
    kill = resilience.FleetFaultPlan.kill(1, 2, at=kill_at)
    noise = resilience.FleetFaultPlan.random(seed, 2, n_faults=2,
                                             points=("fetch",),
                                             max_index=30)
    plans = [noise[0], kill[1]]
    scheds = [_mk_sched(PORT, model, plans[i], clock=clock)
              for i in range(2)]
    with fleet.Router(scheds, clock=clock) as router:
        for r in reqs:
            router.submit(r)
        streamed, statuses = _drive(router)
        drift = [r.request_id for r in reqs
                 if router.completions[r.request_id].tokens
                 != want[r.request_id]
                 or streamed[r.request_id]
                 != router.completions[r.request_id].tokens]
        errored = [k for k, c in router.completions.items()
                   if c.finish_reason == "error"]
        assert not drift and not errored, (seed, drift, errored)
        assert 200 in statuses
        return router.summary()


def test_fleet_chaos_smoke(model, ref_sched):
    s = _chaos_fleet(model, ref_sched, seed=3, n_reqs=6, kill_at=3)
    assert s["failover_waves"] >= 1


@pytest.mark.slow
def test_fleet_chaos_soak_randomized(model, ref_sched):
    for seed in (1, 2, 5):
        _chaos_fleet(model, ref_sched, seed=seed, n_reqs=10, kill_at=2)
