"""apex_tpu_torch.telemetry.slo against the JAX package's, on the CPU.

Oracles (all exact: the port's module performs the same float operations
in the same order, so quantiles and burn rates are bit-equal):

- ``QuantileSketch``: quantiles, means, bucket counts and dict forms on
  seeded samples (lognormal latencies, a heavy tail, values under the
  trackable floor, collapsing past ``max_buckets``), merges and
  ``from_dict`` round trips, equal to JAX's;
- ``parse_objective`` / ``SLOObjective.key`` / ``SLOConfig`` and their
  errors, and the config's dict round trip, equal to JAX's;
- ``BurnMachine`` and ``SLOMonitor`` driven on a fake clock by one seeded
  stream of latencies record the same ``slo_eval`` / ``slo_state`` /
  ``slo_alert`` / ``slo_sketch`` events, burn floats bit for bit, and
  report the same status, summary and percentiles;
- ``replay_alerts`` / ``compare_alerts`` regenerate the alert sequence
  from the recorded window counts in both packages;
- a scheduler with ``slo=`` feeds its monitor, refreshes the SLO gauges
  and reports the sketch percentiles in ``summary()``; its bundle replays
  the alerts (``replay_slo``) in both packages.
"""

import numpy as np
import pytest
import torch

from apex_tpu.telemetry import flightrec as jflightrec
from apex_tpu.telemetry import replay as jreplay
from apex_tpu.telemetry import slo as jslo
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import Engine, EngineConfig, Request, Scheduler
from apex_tpu_torch.telemetry import Registry, flightrec, replay, slo

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


def _samples(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(-3.0, 0.8, n).tolist()
    if kind == "heavy":
        return (rng.pareto(1.5, n) * 1e-3 + 1e-4).tolist()
    if kind == "tiny":
        # below the trackable floor, zeros and negatives included
        return np.concatenate([rng.uniform(-1e-6, 1e-8, n // 2),
                               rng.lognormal(-12.0, 2.0, n - n // 2)]
                              ).tolist()
    return rng.uniform(0.0, 5.0, n).tolist()


@pytest.mark.parametrize("kind,rel_err,max_buckets", [
    ("lognormal", 0.01, 2048), ("heavy", 0.02, 2048),
    ("tiny", 0.01, 2048), ("uniform", 0.005, 64),
    ("lognormal", 0.05, 16)])
def test_sketch_bit_equal_jax(kind, rel_err, max_buckets):
    xs = _samples(kind, 3000, seed=len(kind) * 7 + max_buckets)
    ours = slo.QuantileSketch(rel_err, max_buckets=max_buckets)
    theirs = jslo.QuantileSketch(rel_err, max_buckets=max_buckets)
    for i, x in enumerate(xs):
        n = 1 + i % 3
        ours.add(x, n)
        theirs.add(x, n)
    assert ours.count == theirs.count
    assert [ours.quantile(q) for q in QS] == [theirs.quantile(q)
                                             for q in QS]
    assert ours.mean == theirs.mean
    assert ours.buckets_in_use == theirs.buckets_in_use <= max_buckets + 1
    assert ours.to_dict() == theirs.to_dict()
    back = slo.QuantileSketch.from_dict(theirs.to_dict())
    assert [back.quantile(q) for q in QS] == [theirs.quantile(q)
                                             for q in QS]
    # merging two halves equals pooling, in both packages
    halves = []
    for mod in (slo, jslo):
        a = mod.QuantileSketch(rel_err, max_buckets=max_buckets)
        b = mod.QuantileSketch(rel_err, max_buckets=max_buckets)
        for i, x in enumerate(xs):
            (a if i % 2 else b).add(x)
        halves.append(a.copy().merge(b))
    assert halves[0].to_dict() == halves[1].to_dict()
    assert [halves[0].quantile(q) for q in QS] == [
        halves[1].quantile(q) for q in QS]


def test_empty_sketch_and_config_errors_match_jax():
    assert slo.QuantileSketch().quantile(0.5) is None
    assert jslo.QuantileSketch().quantile(0.5) is None
    for kw in (dict(rel_err=0.0), dict(rel_err=1.0)):
        with pytest.raises(ValueError) as a:
            slo.QuantileSketch(**kw)
        with pytest.raises(ValueError) as b:
            jslo.QuantileSketch(**kw)
        assert str(a.value) == str(b.value)
    for kw in (dict(rel_err=0.0), dict(fast_window_s=700.0),
               dict(warn_burn=7.0), dict(hysteresis=1.0),
               dict(eval_every_s=0.0)):
        with pytest.raises(ValueError) as a:
            slo.SLOConfig(**kw)
        with pytest.raises(ValueError) as b:
            jslo.SLOConfig(**kw)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("spec", [
    "p99:ttft:0.2", "p95:e2e:1.0", "p50:token_latency:0.05:tenant-a",
    "p99.9:queue_wait:2", "P90:ttft:0.3", "p99:latency:0.2", "ttft:0.2",
    "p100:ttft:0.2", "p99:ttft:0", "p99:ttft:x"])
def test_parse_objective_matches_jax(spec):
    try:
        theirs = jslo.parse_objective(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            slo.parse_objective(spec)
        assert str(ours.value) == str(e)
        return
    ours = slo.parse_objective(spec)
    assert ours.key() == theirs.key()
    assert slo.parse_objective(ours.key()).key() == ours.key()
    assert (ours.metric, ours.quantile, ours.threshold_s, ours.target,
            ours.tenant) == (theirs.metric, theirs.quantile,
                             theirs.threshold_s, theirs.target,
                             theirs.tenant)


def _cfg(mod, **kw):
    objs = tuple(mod.parse_objective(s) for s in (
        "p99:ttft:0.2", "p95:e2e:1.0", "p90:token_latency:0.05:b"))
    base = dict(fast_window_s=5.0, slow_window_s=30.0, eval_every_s=1.0,
                snapshot_every_s=7.0)
    base.update(kw)
    return mod.SLOConfig(objectives=objs, **base)


def test_config_dict_round_trip_matches_jax():
    ours, theirs = _cfg(slo), _cfg(jslo)
    assert ours.to_dict() == theirs.to_dict()
    back = slo.slo_config_from_dict(theirs.to_dict())
    assert back.to_dict() == theirs.to_dict()
    assert slo.METRICS == jslo.METRICS
    assert slo.STATE_CODE == jslo.STATE_CODE
    assert slo.ALERT_EVENTS == jslo.ALERT_EVENTS


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_monitor(mod, fr_mod, seed, **cfg_kw):
    """One seeded traffic stream through a monitor on a fake clock: a
    calm phase, a regression (slow TTFT and e2e), a recovery."""
    rng = np.random.default_rng(seed)
    clk = _Clock()
    rec = fr_mod.FlightRecorder(clock=clk)
    transitions = []
    mon = mod.SLOMonitor(_cfg(mod, **cfg_kw), clock=clk, recorder=rec,
                         on_state=lambda o, a, b: transitions.append(
                             (o.key(), a, b)))
    for step in range(240):
        clk.t += float(rng.uniform(0.05, 0.4))
        bad = 80 <= step < 150
        tenant = ("a", "b", None)[step % 3]
        scale = 4.0 if bad else 1.0
        mon.observe("ttft", float(rng.lognormal(-2.5, 0.6)) * scale,
                    tenant)
        mon.observe("token_latency", float(rng.lognormal(-4.0, 0.5))
                    * scale, tenant)
        if step % 2:
            mon.observe("queue_wait", float(rng.lognormal(-3.5, 0.5)),
                        tenant, now=clk.t)
            mon.observe("e2e", float(rng.lognormal(-0.5, 0.4)) * scale,
                        tenant, now=clk.t)
        mon.tick()
    return mon, rec.to_dicts(rec.events()), transitions


@pytest.mark.parametrize("seed,cfg_kw", [
    (0, {}), (1, dict(burn=3.0, warn_burn=0.5, hysteresis=0.5)),
    (2, dict(rel_err=0.02, eval_every_s=2.0))])
def test_monitor_alerts_bit_equal_jax(seed, cfg_kw):
    ours, our_events, our_tr = _drive_monitor(slo, flightrec, seed,
                                              **cfg_kw)
    theirs, their_events, their_tr = _drive_monitor(jslo, jflightrec,
                                                    seed, **cfg_kw)
    assert our_events == their_events
    names = {e["event"] for e in our_events}
    assert {"slo_eval", "slo_state", "slo_alert", "slo_sketch"} <= names
    assert our_tr == their_tr and our_tr
    assert ours.status() == theirs.status()
    assert ours.summary() == theirs.summary()
    assert ours.alerts_total == theirs.alerts_total
    for metric in slo.METRICS:
        for tenant in (None, "a", "b"):
            assert ours.percentiles(metric, tenant) == \
                theirs.percentiles(metric, tenant)
    for mod, cfg in ((slo, _cfg(slo, **cfg_kw)),
                     (jslo, _cfg(jslo, **cfg_kw))):
        out = mod.compare_alerts(cfg, our_events)
        assert out["mismatches"] == []
        assert out["transitions_recorded"] == sum(
            1 for e in our_events if e["event"] in slo.ALERT_EVENTS)
    assert (slo.replay_alerts(_cfg(slo, **cfg_kw), our_events)
            == jslo.replay_alerts(_cfg(jslo, **cfg_kw), our_events))


def test_burn_machine_bit_equal_jax():
    """One machine fed per-second bins straight: its burn floats and its
    state walk (ok, warning, burning and back) are JAX's."""
    rng = np.random.default_rng(5)
    ours = slo.BurnMachine(slo.parse_objective("p99:ttft:0.2"), _cfg(slo))
    theirs = jslo.BurnMachine(jslo.parse_objective("p99:ttft:0.2"),
                              _cfg(jslo))
    states = []
    for sec in range(120):
        frac_bad = 0.3 if 30 <= sec < 60 else 0.002
        for _ in range(int(rng.integers(5, 30))):
            v = 0.5 if rng.random() < frac_bad else 0.01
            ours.observe(sec + 0.5, v)
            theirs.observe(sec + 0.5, v)
        ours.evaluate(sec + 0.99)
        theirs.evaluate(sec + 0.99)
        assert ours.status() == theirs.status()
        states.append(ours.state)
    assert {"ok", "warning", "burning"} <= set(states)


def test_scheduler_feeds_the_monitor_and_bundle_replays_alerts(tmp_path):
    """``Scheduler(slo=...)`` on a fake clock: every request feeds the
    four sketches, the gauges refresh at each evaluation, ``summary()``
    carries the sketch percentiles and ``predicted_ttft_s``, and the
    bundle's alert sequence replays in both packages."""
    cfg = tgpt.GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                         num_heads=2, seq_len=64, remat=False,
                         compute_dtype=torch.float32)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, EngineConfig(slots=2, max_prompt_len=8,
                                           max_seq_len=32), device="cpu")
    clk = _Clock()
    orig = eng.step_async

    def step_async(**kw):
        clk.t += 0.3            # every chunk costs 0.3 s of fake time
        return orig(**kw)

    eng.step_async = step_async
    registry = Registry()
    rec = flightrec.FlightRecorder()
    slo_cfg = slo.SLOConfig(objectives=(
        slo.parse_objective("p99:ttft:0.5"),
        slo.parse_objective("p95:e2e:2.0")), fast_window_s=5.0,
        slow_window_s=30.0)
    sched = Scheduler(eng, clock=clk, registry=registry, recorder=rec,
                      slo=slo_cfg, bundle_dir=str(tmp_path))
    for i in range(6):
        sched.submit(Request(f"s{i}", [1 + i, 2, 3], max_tokens=8))
    sched.run_until_idle()
    s = sched.summary()
    assert sched.slo.sketch("ttft").count == 6
    assert sched.slo.sketch("e2e").count == 6
    assert sched.slo.sketch("token_latency").count == 42
    for m in ("ttft", "token_latency", "queue_wait", "e2e"):
        assert s[f"slo_{m}_p99_ms"] == sched.slo.quantile(m, 0.99) * 1e3
    assert s["slo_state"] == 2.0 and s["slo_alerts"] >= 1.0
    assert "predicted_ttft_s" in s
    text = registry.to_prometheus_text()
    assert 'serving_slo_state{objective="p95:e2e:2"} 2' in text
    assert 'serving_slo_alerts_total{objective="p95:e2e:2",' \
        'state="burning"} 1' in text
    bundle = flightrec.read_bundle(sched.dump_bundle("slo"))
    ours = replay.replay_slo(bundle)
    assert ours["mismatches"] == [] and ours["transitions_recorded"] >= 1
    assert ours == jreplay.replay_slo(bundle)
