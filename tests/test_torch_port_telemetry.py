"""apex_tpu_torch.telemetry (registry, spans, ring, the metrics server),
apex_tpu_torch.profiler and the scheduler's telemetry, against the JAX
package on the CPU.

Oracles:

- ``Registry``: one seeded sequence of operations (counters, gauges,
  histograms with default and custom buckets, labels holding quotes,
  backslashes and newlines, integral, fractional, tiny, huge and
  infinite values) gives Prometheus text byte-equal to JAX's and an equal
  ``to_dict()``; ``parse_prometheus_text`` and ``sanitize_metric_name``
  agree; the same misuse raises the same error;
- ``SpanRecorder`` on a fake clock (marks with notes, sections, a ring
  that drops) exports Chrome-trace JSON equal to JAX's, and the same
  ``summary()``; ``Ring`` keeps the same window;
- ``MetricsLogger`` writes JAX's JSONL lines and mirrors every scalar
  into registry gauges; ``LatencyStats`` summarises seeded samples to
  JAX's numbers (exact);
- ``MetricsServer`` on port 0 serves ``/metrics`` (the registry's text),
  ``/healthz``, ``/vars`` (``"recompile": null``), ``/debug/events``,
  ``/debug/bundle`` and ``/slo`` when wired, 404 when not;
- the scheduler oracle: JAX's and the port's schedulers run the same
  greedy trace (two tenants, an eos-terminal prompt, a budget of 1,
  chunk 2, depth 2) on one tiny GPT (JAX's weights crossed over) with a
  registry, spans and a flight recorder. Their parsed scrapes carry the
  same series and labels, with equal values for every counter and gauge
  that counts requests, tokens, admissions, ticks or chunks
  (``_COUNTED``); their flight-recorder events are equal, name and every
  field, except ``t`` (the clock) and ``wall_s`` (a measured time);
- the telemetry layer and the tuner import with torch, numpy, JAX and
  ``apex_tpu`` blocked, and render a report from a bundle.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu import profiler as jprofiler
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu.telemetry import flightrec as jflightrec
from apex_tpu.telemetry import registry as jregistry
from apex_tpu.telemetry import ring as jring
from apex_tpu.telemetry import spans as jspans
from apex_tpu_torch import profiler
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import Engine, EngineConfig, Request, Scheduler
from apex_tpu_torch.telemetry import (
    MetricsServer,
    flightrec,
    registry,
    ring,
    spans,
)
from apex_tpu_torch.telemetry.slo import SLOConfig, parse_objective

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the registry -----------------------------------------------------------

_LABEL_VALUES = ("a", 'quo"te', "back\\slash", "new\nline", "",
                 "ünï", "sp ace")
_VALUES = (0.0, 1.0, 3.0, 0.1, 1e-7, 2.5e15, 123456789.0, 1 / 3,
           float("inf"), 7e-300)


def _registry_ops(mod, seed):
    """One seeded sequence of operations on a registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("req_total", "requests, by route", labels=("route",))
    g = reg.gauge("depth", "queue depth")
    lg = reg.gauge("slot_state", "per slot", labels=("slot", "kind"))
    h = reg.histogram("lat_seconds", "latency")
    hl = reg.histogram("size_bytes", "sizes", labels=("op",),
                       buckets=(1.0, 10.0, 100.0))
    for _ in range(300):
        op = int(rng.integers(6))
        v = _VALUES[int(rng.integers(len(_VALUES)))]
        lab = _LABEL_VALUES[int(rng.integers(len(_LABEL_VALUES)))]
        if op == 0:
            c.labels(route=lab).inc(v)
        elif op == 1:
            g.set(v if rng.random() < 0.5 else -v)
        elif op == 2:
            lg.labels(slot=str(int(rng.integers(3))), kind=lab).inc(
                float(rng.normal()))
        elif op == 3:
            h.observe(float(rng.lognormal(-4.0, 2.0)))
        elif op == 4:
            hl.labels(op=lab).observe(float(rng.uniform(0.0, 200.0)))
        else:
            g.dec(float(rng.integers(3)))
    # re-declaring a family returns it (same help and labels)
    reg.counter("req_total", "requests, by route", labels=("route",))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_byte_equal_jax(seed):
    ours, theirs = _registry_ops(registry, seed), _registry_ops(jregistry,
                                                                seed)
    text = ours.to_prometheus_text()
    assert text == theirs.to_prometheus_text()
    assert ours.to_dict() == theirs.to_dict()
    assert registry.parse_prometheus_text(text) == \
        jregistry.parse_prometheus_text(text)
    assert registry.DEFAULT_BUCKETS == jregistry.DEFAULT_BUCKETS


def test_registry_names_and_misuse_match_jax():
    for name in ("grad_norm/global", "9lives", "ok_name", "", "a-b.c",
                 "__x__", "é"):
        assert registry.sanitize_metric_name(name) == \
            jregistry.sanitize_metric_name(name)

    def errors(mod):
        out = []
        reg = mod.Registry()
        c = reg.counter("x_total", "x", labels=("k",))
        for bad in (lambda: reg.gauge("x_total", "x"),
                    lambda: reg.counter("x_total", "other help"),
                    lambda: reg.counter("x_total", "x", labels=("j",)),
                    lambda: c.labels(j="1"),
                    lambda: c.labels(k="1").inc(-1.0),
                    lambda: c.inc(),
                    lambda: reg.counter("bad name", "x"),
                    lambda: mod.parse_prometheus_text("no value here x")):
            try:
                bad()
                out.append(None)
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        return out

    assert errors(registry) == errors(jregistry)


# -- spans, the ring, the profiler ------------------------------------------


class _Clock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        self.t += 0.00125
        return self.t


def _span_ops(mod, capacity):
    rng = np.random.default_rng(3)
    rec = mod.SpanRecorder(capacity=capacity, clock=_Clock())
    phases = (mod.PHASE_QUEUED, mod.PHASE_PREFILL, mod.PHASE_FIRST_TOKEN,
              mod.PHASE_DECODE, mod.PHASE_RETIRED)
    for i in range(120):
        rid = f"r{int(rng.integers(6))}"
        if rng.random() < 0.25:
            with rec.section(("engine.dispatch", "engine.fetch")[i % 2]):
                pass
        elif rng.random() < 0.2:
            t0 = rec.clock()
            rec.section_at("engine.admit", t0, t0 + 0.003)
        else:
            rec.mark(rid, phases[int(rng.integers(len(phases)))],
                     note=(f"slot {i % 3}" if rng.random() < 0.3 else None))
    return rec


@pytest.mark.parametrize("capacity", [4096, 64])
def test_spans_chrome_trace_equal_jax(capacity):
    ours, theirs = _span_ops(spans, capacity), _span_ops(jspans, capacity)
    assert json.dumps(ours.to_chrome_trace(), sort_keys=True) == \
        json.dumps(theirs.to_chrome_trace(), sort_keys=True)
    assert ours.summary() == theirs.summary()
    assert ours.events() == theirs.events()
    assert spans.SpanRecorder().to_chrome_trace() == \
        jspans.SpanRecorder().to_chrome_trace()


def test_ring_and_latency_stats_match_jax(tmp_path):
    for cap in (1, 5, 64):
        a, b = ring.Ring(cap), jring.Ring(cap)
        for i in range(37):
            a.append(i)
            b.append(i)
            assert (a.values(), a.total, a.dropped) == (
                b.values(), b.total, b.dropped)
    rng = np.random.default_rng(11)
    xs = rng.lognormal(-4.0, 1.0, 3000).tolist()
    ours, theirs = profiler.LatencyStats(512), jprofiler.LatencyStats(512)
    assert ours.summary() == theirs.summary() == {}
    for x in xs:
        ours.add(x)
        theirs.add(x)
    assert ours.summary() == theirs.summary()
    assert ours.total == 3000


def test_metrics_logger_matches_jax(tmp_path):
    rows = [(1, {"loss": 2.5, "grad_norm/global": 0.125,
                 "lr": torch.tensor(3e-4)}),
            (2, {"loss": 2.25, "grad_norm/global": 0.5, "lr": 3e-4})]
    treg, jreg = registry.Registry(), jregistry.Registry()
    with profiler.MetricsLogger(str(tmp_path / "t.jsonl"), history=1,
                                registry=treg,
                                registry_prefix="train_") as log:
        for step, m in rows:
            log.log(step, m)
        assert log.history == [{"loss": 2.25, "grad_norm/global": 0.5,
                                "lr": 3e-4, "step": 2}]
    jlog = jprofiler.MetricsLogger(str(tmp_path / "j.jsonl"), history=1,
                                   registry=jreg, registry_prefix="train_")
    for step, m in rows:
        jlog.log(step, {k: (float(v) if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
    jlog.close()
    assert open(tmp_path / "t.jsonl").read() == \
        open(tmp_path / "j.jsonl").read()
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()


# -- the metrics server -----------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def test_metrics_server_routes(tmp_path):
    reg = registry.Registry()
    reg.counter("hits_total", "hits").inc(3)
    sp = spans.SpanRecorder(clock=_Clock())
    sp.mark("r0", spans.PHASE_QUEUED)
    rec = flightrec.FlightRecorder(clock=_Clock())
    rec.record("submit", "r0", 3, 8, 1)
    rec.record("finish", "r0", "length", 8)
    srv = MetricsServer(reg, spans=sp, recorder=rec,
                        bundle_trigger=lambda: str(tmp_path / "bundle-x"),
                        slo=lambda: {"state": "ok"},
                        extra_vars=lambda: {"extra": 1}).start()
    bare = MetricsServer(reg).start()
    try:
        status, body, hdrs = _get(srv.url + "/metrics")
        assert status == 200
        assert body.decode() == reg.to_prometheus_text()
        assert hdrs["Content-Type"].startswith("text/plain; version=0.0.4")
        assert _get(srv.url + "/healthz")[:2] == (200, b"ok\n")
        v = json.loads(_get(srv.url + "/vars")[1])
        assert v["recompile"] is None and v["extra"] == 1
        assert v["metrics"] == reg.to_dict()
        assert v["spans"]["events"] == 1 and v["flightrec"]["events"] == 2
        tail = json.loads(_get(srv.url + "/debug/events?n=1")[1])
        assert [e["event"] for e in tail] == ["finish"]
        assert _get(srv.url + "/debug/events?n=x")[0] == 400
        assert json.loads(_get(srv.url + "/debug/bundle")[1]) == {
            "bundle": str(tmp_path / "bundle-x")}
        assert json.loads(_get(srv.url + "/slo")[1]) == {"state": "ok"}
        for route in ("/debug/events", "/debug/bundle", "/slo", "/nope"):
            assert _get(bare.url + route)[0] == 404
        assert json.loads(_get(bare.url + "/vars")[1])["recompile"] is None
    finally:
        srv.stop()
        bare.stop()


# -- the scheduler against JAX's --------------------------------------------

VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2)
GEOM = dict(slots=2, max_prompt_len=8, max_seq_len=32, decode_chunk=2)

#: the series whose values the same trace determines: every counter and
#: gauge that counts requests, tokens, admissions, ticks or chunks, and
#: each latency histogram's count
_COUNTED = (
    "serving_queue_depth", "serving_active_slots", "serving_slots_total",
    "serving_inflight_chunks", "serving_requests_submitted_total",
    "serving_requests_admitted_total", "serving_admit_dispatches_total",
    "serving_admit_batch_requests_total",
    "serving_prefill_bucket_requests_total",
    "serving_requests_finished_total", "serving_queue_expired_total",
    "serving_tokens_emitted_total", "serving_scheduler_steps_total",
    "serving_ttft_seconds_count", "serving_token_latency_seconds_count",
    "serving_request_latency_seconds_count",
    "serving_requests_shed_total", "serving_replayed_tokens_total",
    "serving_prefix_hits_total", "serving_prefix_misses_total",
    "serving_chunked_prefill_chunks_total",
    "serving_chunked_admissions_total", "serving_preemptions_total",
    "serving_spec_drafted_total", "serving_spec_accepted_total",
    "serving_tenant_tokens_total", "serving_tenant_admissions_total",
    "serving_tenant_sheds_total", "serving_tenant_queue_depth",
    "serving_pages_in_use", "serving_pages_free",
    "serving_journal_appends_total", "serving_faults_detected_total",
    "serving_retries_total", "serving_rebuilds_total")

#: recorder fields a run's clock decides, not its decisions
_TIME_FIELDS = ("t", "wall_s")


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    jeng = JEngine(jcfg, params, mesh, JEngineConfig(**GEOM))
    return jeng, tcfg, tparams


def _trace(req_cls):
    rng = np.random.default_rng(21)
    out = []
    for i in range(6):
        prompt = rng.integers(1, VOCAB, 2 + (5 * i) % 7).tolist()
        kw = {}
        if i == 3:
            prompt[-1] = 7                  # eos-terminal at submit
            kw["eos_token_id"] = 7
        out.append(req_cls(f"q{i}", prompt, max_tokens=1 if i == 4 else 9,
                           tenant=("a", "b")[i % 2], **kw))
    return out


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return sched


def _counted(text):
    parsed = registry.parse_prometheus_text(text)
    return {k: v for k, v in parsed.items() if k in _COUNTED}


def _events(rec):
    return [{k: v for k, v in e.items() if k not in _TIME_FIELDS}
            for e in rec.to_dicts(rec.events())]


def test_scheduler_telemetry_matches_jax(model):
    jeng, tcfg, tparams = model
    jreg, jrec = jregistry.Registry(), jflightrec.FlightRecorder()
    jsched = _serve(JScheduler(jeng, registry=jreg, recorder=jrec,
                               spans=jspans.SpanRecorder(),
                               pipeline_depth=2), _trace(JRequest))
    treg, trec = registry.Registry(), flightrec.FlightRecorder()
    tsched = _serve(Scheduler(Engine(tcfg, tparams, EngineConfig(**GEOM),
                                     device="cpu"),
                              registry=treg, recorder=trec,
                              spans=spans.SpanRecorder(),
                              pipeline_depth=2), _trace(Request))
    assert {r: c.tokens for r, c in tsched.completions.items()} == \
        {r: c.tokens for r, c in jsched.completions.items()}
    ttext, jtext = treg.to_prometheus_text(), jreg.to_prometheus_text()
    tparsed = registry.parse_prometheus_text(ttext)
    jparsed = registry.parse_prometheus_text(jtext)
    # the same series, with the same label sets
    assert {k: set(v) for k, v in tparsed.items()} == \
        {k: set(v) for k, v in jparsed.items()}
    assert set(_counted(jtext)) == set(_COUNTED)
    assert _counted(ttext) == _counted(jtext)
    assert tparsed["serving_tokens_emitted_total"][()] == \
        tsched.summary()["tokens_emitted"]
    # the flight recorder: the same decisions, field for field
    assert _events(trec) == _events(jrec)
    names = {e["event"] for e in _events(trec)}
    assert {"submit", "submit_terminal", "admit", "dispatch", "fetch",
            "finish"} <= names
    # the span timelines: the same phases a request, the same sections
    tsp, jsp = tsched.spans.events(), jsched.spans.events()
    assert [(e[0], e[2], e[3] if e[0] == 0 else None) for e in tsp] == \
        [(e[0], e[2], e[3] if e[0] == 0 else None) for e in jsp]


def test_scheduler_bundle_and_metrics_logger(model, tmp_path):
    """The port's bundle holds JAX's files for the same sinks, and a
    ``MetricsLogger`` gets one record a tick and one a completion."""
    _, tcfg, tparams = model
    reg = registry.Registry()
    log = profiler.MetricsLogger(registry=reg, registry_prefix="sched_",
                                 history=1000)
    sched = _serve(Scheduler(
        Engine(tcfg, tparams, EngineConfig(**GEOM), device="cpu"),
        registry=reg, recorder=flightrec.FlightRecorder(),
        spans=spans.SpanRecorder(), metrics=log, bundle_dir=str(tmp_path),
        slo=SLOConfig(objectives=(parse_objective("p99:ttft:1"),))),
        _trace(Request))
    done = [h for h in log.history if "completed" in h]
    assert len(done) == 6
    assert sum(1 for h in log.history if "queue_depth" in h) == \
        sched.summary()["steps"]
    assert "sched_tokens_emitted" in reg.to_prometheus_text()
    path = sched.dump_bundle("manual check")
    assert os.path.basename(path) == "bundle-0000-manual-check"
    bundle = flightrec.read_bundle(path)
    assert sorted(bundle) == ["config.json", "events.jsonl",
                              "manifest.json", "registry.json",
                              "requests.jsonl", "spans_raw.jsonl",
                              "spans_trace.json"]
    assert bundle["registry.json"] == json.loads(json.dumps(
        reg.to_dict(), default=str))
    man = bundle["manifest.json"]
    assert man["summary"]["requests_completed"] == 6.0
    assert "torch" in man["versions"] and "cuda" in man["versions"]
    assert [r["status"] for r in bundle["requests.jsonl"]] == \
        ["completed"] * 6
    assert sched.summary()["bundles_written"] == 1.0
    with pytest.raises(FileExistsError, match="immutable"):
        flightrec.write_bundle(path, {"manifest.json": {}})


# -- standard library only --------------------------------------------------

_STDLIB_ONLY = r"""
import sys

import apex_tpu_torch.serving  # the parents (torch) load normally

BLOCKED = ("jax", "jaxlib", "apex_tpu", "numpy", "scipy", "torch")


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked by test: {name}")
        return None


for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, _Blocker())

import apex_tpu_torch._atomic
import apex_tpu_torch.serving.tuner as tuner
import apex_tpu_torch.telemetry as tel
from apex_tpu_torch.telemetry import (flightrec, http, registry, replay,
                                      ring, slo, spans)

for name in tel.__all__:
    getattr(tel, name)
reg = tel.Registry()
reg.counter("x_total", "x").inc()
assert tel.parse_prometheus_text(reg.to_prometheus_text()) == {
    "x_total": {(): 1.0}}
bundle = flightrec.read_bundle(sys.argv[1])
text = replay.render_report(bundle)
assert text.startswith("post-mortem bundle: cause=fixture")
assert replay.replay_tuner(bundle)["mismatches"] == []
assert replay.replay_slo(bundle)["mismatches"] == []
print(text.splitlines()[0])
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("TELEMETRY_STDLIB_ONLY_OK")
"""


def test_telemetry_and_tuner_import_stdlib_only(model, tmp_path):
    """Every telemetry module and the tuner import with torch, numpy, JAX
    and ``apex_tpu`` blocked, and the report, the tuner replay and the
    SLO replay run on a bundle of a tuned, SLO-monitored run."""
    from apex_tpu_torch.serving.tuner import TunerConfig

    _, tcfg, tparams = model
    sched = _serve(Scheduler(
        Engine(tcfg, tparams, EngineConfig(**GEOM, decode_chunks=(1, 2)),
               device="cpu"),
        recorder=flightrec.FlightRecorder(), spans=spans.SpanRecorder(),
        tuner=TunerConfig(decode_chunk=(1, 2), probe_every=1,
                          probe_chunks=1, min_measure_chunks=1),
        slo=SLOConfig(objectives=(parse_objective("p99:ttft:1"),)),
        bundle_dir=str(tmp_path)), _trace(Request))
    path = sched.dump_bundle("fixture")
    res = subprocess.run([sys.executable, "-c", _STDLIB_ONLY, path],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "TELEMETRY_STDLIB_ONLY_OK" in res.stdout
    assert res.stdout.startswith("post-mortem bundle: cause=fixture")
