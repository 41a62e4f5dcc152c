"""apex_tpu_torch.serving.tuner, the engine's ladders and the tuned
scheduler on the CPU, against the JAX package.

Oracles:

- ``Controller`` fed one seeded observation stream (points from
  ``want_dispatch``, random token counts, walls and depths, freezes and
  thaws between) in both packages records the same event list, EWMAs
  bit for bit (exact: the same float operations in the same order), and
  ``replay_decisions`` / ``compare_decisions`` regenerate it in both;
  ``point_key`` / ``parse_point`` and the config errors are JAX's;
- ``EngineConfig(decode_chunks=..., spec_ks=...)`` validates with the
  JAX engine's own messages (its static ladder resolvers, no JAX engine
  built), ``Engine.decode_chunks`` / ``spec_ks`` and ``describe()`` carry
  the ladders, and ``step_async(chunk=, spec_k=)`` refuses a value off
  them as JAX's does;
- ``Scheduler(tuner=...)`` validates its ladders against the engine's
  (JAX's messages), a tuner owning ``spec_k`` replaces the payoff gate
  and ``spec_gate`` with it raises;
- a tuned run's streams (greedy and sampled, ``decode_chunks=(1, 2, 4)``
  with ``pipeline_depth`` (1, 2), and ``spec_k`` rungs (0, 2)) equal the
  untuned run's token for token, with the controller forced to probe and
  switch by an injected latency model on a fake clock;
- a tuned run's bundle replays its decisions (``replay_tuner``, the
  port's and the JAX package's on the same bundle) with no mismatch, and
  ``drain()`` freezes the controller until the next tick.
"""

import dataclasses

import numpy as np
import pytest
import torch

from apex_tpu.serving import tuner as jtuner
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.telemetry import flightrec as jflightrec
from apex_tpu.telemetry import replay as jreplay
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    SpecGateConfig,
)
from apex_tpu_torch.serving import tuner
from apex_tpu_torch.telemetry import flightrec, replay

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2,
             compute_dtype=torch.float32)
_BASE = {"decode_chunk": 1, "pipeline_depth": 1, "max_admit_batch": 0,
         "spec_k": 0}


# -- the controller against JAX's ------------------------------------------


def _drive_pair(seed, cfg_kw, base, n=160):
    """One seeded observation stream through both packages' controllers:
    returns their recorders' event dicts."""
    rng = np.random.default_rng(seed)
    recs = (flightrec.FlightRecorder(clock=lambda: 0.0),
            jflightrec.FlightRecorder(clock=lambda: 0.0))
    ctls = (tuner.Controller(tuner.TunerConfig(**cfg_kw), base,
                             recorder=recs[0]),
            jtuner.Controller(jtuner.TunerConfig(**cfg_kw), base,
                              recorder=recs[1]))
    causes = ("constrained", "replay", "drain")
    for _ in range(n):
        u = rng.random()
        if u < 0.04:
            cause = causes[int(rng.integers(len(causes)))]
            for c in ctls:
                c.freeze(cause)
            continue
        if u < 0.10:
            for c in ctls:
                c.thaw()
            continue
        inflight = int(rng.integers(0, 2))
        points = [c.want_dispatch(inflight) for c in ctls]
        assert points[0] == points[1]
        if points[0] is None:
            points = [c.want_dispatch(0) for c in ctls]
        tokens = int(rng.integers(0, 9))
        wall = float(rng.lognormal(-4.0, 0.6))
        depth = int(rng.integers(1, 3))
        for c, p in zip(ctls, points):
            c.observe(dict(p), tokens, wall, depth)
        if rng.random() < 0.2:
            ttft = float(rng.lognormal(-3.0, 0.5))
            for c in ctls:
                c.observe_ttft(ttft)
    for a in ("incumbent", "probes_total", "switch_counts", "ewma",
              "incumbent_ewma", "ttft_ewma", "ttft_counts"):
        assert getattr(ctls[0], a) == getattr(ctls[1], a), a
    assert ctls[0].state() == ctls[1].state()
    return [r.to_dicts(r.events()) for r in recs]


@pytest.mark.parametrize("seed,cfg_kw", [
    (0, dict(decode_chunk=(1, 2, 4), pipeline_depth=(1, 2),
             probe_every=2, probe_chunks=2, min_measure_chunks=2)),
    (1, dict(decode_chunk=(1, 2, 4), pipeline_depth=(1, 2),
             max_admit_batch=(0, 2), spec_k=(0, 2, 3), probe_every=3,
             probe_chunks=1, min_measure_chunks=1, margin=1.02)),
    (2, dict(spec_k=(0, 2), ewma_alpha=0.5, probe_every=4,
             probe_chunks=3, min_measure_chunks=3)),
])
def test_controller_events_equal_jax(seed, cfg_kw):
    """The same observations give the same probes, switches, freezes and
    observations, field for field, EWMAs bit-equal (exact)."""
    ours, theirs = _drive_pair(seed, cfg_kw, _BASE)
    assert ours == theirs
    names = {e["event"] for e in ours}
    assert {"tuner_obs", "tuner_probe", "tuner_freeze"} <= names
    decisions = [e for e in ours if e["event"] in tuner.DECISION_EVENTS]
    cfgs = (tuner.TunerConfig(**cfg_kw), jtuner.TunerConfig(**cfg_kw))
    assert (tuner.replay_decisions(cfgs[0], _BASE, ours)
            == jtuner.replay_decisions(cfgs[1], _BASE, ours))
    for mod, cfg in zip((tuner, jtuner), cfgs):
        out = mod.compare_decisions(cfg, _BASE, ours)
        assert out["mismatches"] == []
        assert out["decisions_recorded"] == len(decisions)


def test_switches_equal_jax_on_a_dominant_point():
    """A latency model with one dominant point: both controllers walk to
    it through the same switch events (exact)."""
    cfg_kw = dict(decode_chunk=(1, 2, 4), pipeline_depth=(1, 2),
                  probe_every=2, probe_chunks=1, min_measure_chunks=2)
    recs = (flightrec.FlightRecorder(clock=lambda: 0.0),
            jflightrec.FlightRecorder(clock=lambda: 0.0))
    ctls = (tuner.Controller(tuner.TunerConfig(**cfg_kw), _BASE,
                             recorder=recs[0]),
            jtuner.Controller(jtuner.TunerConfig(**cfg_kw), _BASE,
                              recorder=recs[1]))
    for _ in range(120):
        for c in ctls:
            p = c.want_dispatch(0)
            q = ({1: 1.0, 2: 2.0, 4: 4.0}[p["decode_chunk"]]
                 * {1: 1.0, 2: 1.5}[p["pipeline_depth"]])
            c.observe(p, 1, 1.0 / q, 1)
    ours, theirs = (r.to_dicts(r.events()) for r in recs)
    assert ours == theirs
    assert ctls[0].incumbent == {"decode_chunk": 4, "pipeline_depth": 2}
    assert sum(1 for e in ours if e["event"] == "tuner_switch") >= 2


@pytest.mark.parametrize("kw", [
    dict(), dict(decode_chunk=(1, 2), margin=0.9),
    dict(decode_chunk=(2, 1)), dict(decode_chunk=(2, 4)),
    dict(decode_chunk=(1, 2), probe_every=0),
    dict(decode_chunk=(1,), pipeline_depth=(1,)),
    dict(decode_chunk=(1, 2), ewma_alpha=0.0),
    dict(pipeline_depth=(0, 1)),
])
def test_controller_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as ours:
        tuner.Controller(tuner.TunerConfig(**kw), _BASE)
    with pytest.raises(ValueError) as theirs:
        jtuner.Controller(jtuner.TunerConfig(**kw), _BASE)
    assert str(ours.value) == str(theirs.value)


def test_point_key_and_module_constants_match_jax():
    for p in ({"decode_chunk": 8, "pipeline_depth": 2, "spec_k": 0},
              {"spec_k": 3, "max_admit_batch": 0}, {}):
        assert tuner.point_key(p) == jtuner.point_key(p)
        assert tuner.parse_point(tuner.point_key(p)) == p
    assert tuner.KNOBS == jtuner.KNOBS
    assert set(tuner.VARIANT_KNOBS) == set(jtuner.VARIANT_KNOBS)
    assert tuner.DECISION_EVENTS == jtuner.DECISION_EVENTS
    assert (tuner.TUNER_FROZEN, tuner.TUNER_MEASURING, tuner.TUNER_STEADY,
            tuner.TUNER_PROBING) == (jtuner.TUNER_FROZEN,
                                     jtuner.TUNER_MEASURING,
                                     jtuner.TUNER_STEADY,
                                     jtuner.TUNER_PROBING)
    for a, b in ((0.0, 2.0), (1.5, 3.25), (7.0, 0.1)):
        assert tuner.ewma(a, b, 0.3) == jtuner.ewma(a, b, 0.3)


# -- the engine's ladders ---------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = tgpt.GPTConfig(**SMALL)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


_GEOM = dict(slots=2, max_prompt_len=8, max_seq_len=40)


@pytest.mark.parametrize("kw", [
    dict(decode_chunk=4, decode_chunks=(1, 2)),
    dict(decode_chunks=(2, 2)), dict(decode_chunks=(2, 1)),
    dict(decode_chunks=(0, 1)), dict(decode_chunks=()),
    dict(spec_k=3, spec_ks=(2,)), dict(spec_ks=(0, 2)),
    dict(spec_ks=(3, 2)), dict(spec_ks=()),
])
def test_engine_ladders_validate_as_jax(model, kw):
    """A bad ladder raises the JAX engine's message (its resolvers run on
    the same fields; no JAX engine is built)."""
    cfg, params = model
    jcfg = JEngineConfig(**_GEOM, **kw)
    with pytest.raises(ValueError) as theirs:
        JEngine._resolve_chunk_ladder(jcfg)
        JEngine._resolve_spec_ladder(jcfg)
    with pytest.raises(ValueError) as ours:
        Engine(cfg, params, EngineConfig(**_GEOM, **kw), device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw,chunks,ks", [
    (dict(), (1,), ()), (dict(decode_chunk=2), (2,), ()),
    (dict(decode_chunks=(1, 2, 4)), (1, 2, 4), ()),
    (dict(spec_k=2), (1,), (2,)),
    (dict(spec_ks=(2, 3)), (1,), (2, 3)),
    (dict(spec_k=3, spec_ks=(2, 3), decode_chunk=2, decode_chunks=(2, 4)),
     (2, 4), (2, 3)),
])
def test_engine_resolves_ladders_as_jax(model, kw, chunks, ks):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(**_GEOM, **kw), device="cpu")
    jcfg = JEngineConfig(**_GEOM, **kw)
    assert eng.decode_chunks == JEngine._resolve_chunk_ladder(jcfg) == chunks
    assert eng.spec_ks == JEngine._resolve_spec_ladder(jcfg) == ks
    d = eng.describe()
    assert d["decode_chunks"] == list(chunks) and d["spec_ks"] == list(ks)
    # spec_ks with spec_k == 0 carries the drafter's ring all the same
    assert ("hist" in eng.state) == bool(ks)


def test_step_async_refuses_off_the_ladder(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(
        **_GEOM, decode_chunks=(1, 2), spec_ks=(2,)), device="cpu")
    with pytest.raises(ValueError, match="not a pre-warmed step variant"):
        eng.step_async(chunk=4)
    with pytest.raises(ValueError, match="not a pre-warmed spec variant"):
        eng.step_async(spec=True, spec_k=3)
    with pytest.raises(ValueError, match="not a pre-warmed spec variant"):
        eng.step_async(spec=True)       # spec_k 0: the plain rung
    with pytest.raises(ValueError, match="without spec=True"):
        eng.step_async(spec_k=2)
    plain = Engine(cfg, params, EngineConfig(**_GEOM), device="cpu")
    with pytest.raises(ValueError, match="needs a compiled spec variant"):
        plain.step_async(spec=True)
    # on the ladder: a chunk of 2 has two columns, a 2-draft wave three
    eng.admit(0, [1, 2, 3], 20)
    assert eng.step_async(chunk=2).fetch()[0].shape == (2, 2)
    h = eng.step_async(spec=True, spec_k=2, chunk=1)
    assert (h.spec_k, h.ncols) == (2, 3)
    assert h.fetch()[0].shape == (2, 3)


def test_scheduler_tuner_validation_matches_jax(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(**_GEOM, decode_chunks=(1, 2)),
                 device="cpu")
    with pytest.raises(ValueError, match=r"decode_chunk candidates \[4\] "
                       r"are not pre-warmed step variants \(1, 2\)"):
        Scheduler(eng, tuner=tuner.TunerConfig(decode_chunk=(1, 2, 4)))
    with pytest.raises(ValueError, match=r"spec_k candidates \[2\] are not "
                       r"pre-warmed spec variants \(\)"):
        Scheduler(eng, tuner=tuner.TunerConfig(spec_k=(0, 2)))
    with pytest.raises(ValueError, match="base pipeline_depth=3"):
        Scheduler(eng, pipeline_depth=3,
                  tuner=tuner.TunerConfig(pipeline_depth=(1, 2)))
    spec = Engine(cfg, params, EngineConfig(**_GEOM, spec_k=2, spec_hist=8),
                  device="cpu")
    with pytest.raises(ValueError, match="spec_gate given but unusable"):
        Scheduler(spec, tuner=tuner.TunerConfig(spec_k=(0, 2)),
                  spec_gate=SpecGateConfig())
    assert Scheduler(spec, tuner=tuner.TunerConfig(spec_k=(0, 2)))._gate \
        is None
    assert Scheduler(spec)._gate is not None
    # the tuner owning another knob leaves the gate in place
    assert Scheduler(spec, tuner=tuner.TunerConfig(
        pipeline_depth=(1, 2)))._gate is not None


# -- tuned streams ----------------------------------------------------------


class _FakeClock:
    """A tiny step a read (strictly monotonic) plus the latency model's
    advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t

    def advance(self, dt):
        self.t += dt


class _TimedHandle:
    """A StepHandle whose fetch advances the fake clock by the latency
    model's cost of the dispatched variant."""

    def __init__(self, handle, clk, dt):
        self._handle, self._clk, self._dt = handle, clk, dt

    def fetch(self):
        self._clk.advance(self._dt)
        return self._handle.fetch()

    def __getattr__(self, name):
        return getattr(self._handle, name)


def _inject_latency(eng, clk, cost):
    orig = eng.step_async

    def step_async(*, spec=False, chunk=None, spec_k=None):
        h = orig(spec=spec, chunk=chunk, spec_k=spec_k)
        c = chunk if chunk is not None else eng.engine_cfg.decode_chunk
        return _TimedHandle(h, clk, cost(c, spec_k if spec else 0))

    eng.step_async = step_async


def _reqs(n, max_tokens=14):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        prompt = rng.integers(0, VOCAB, 2 + (3 * i) % 6).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=7, seed=100 + i)
              if i % 2 else SamplingParams())
        out.append(Request(f"t{i}", prompt, max_tokens=max_tokens,
                           sampling=sp))
    return out


def _run(model, ecfg, tuner_cfg=None, cost=None, recorder=None,
         bundle_dir=None, pipeline_depth=1):
    cfg, params = model
    eng = Engine(cfg, params, ecfg, device="cpu")
    clk = _FakeClock()
    if cost is not None:
        _inject_latency(eng, clk, cost)
    sched = Scheduler(eng, clock=clk, pipeline_depth=pipeline_depth,
                      tuner=tuner_cfg, recorder=recorder,
                      bundle_dir=bundle_dir,
                      bundle_meta={"params": {"init_seed": 0}})
    for r in _reqs(6):
        sched.submit(r)
    sched.run_until_idle()
    return {rid: c.tokens for rid, c in sched.completions.items()}, sched


def test_tuned_chunk_and_depth_streams_equal_untuned(model):
    """decode_chunks (1, 2, 4) x pipeline_depth (1, 2) under forced
    probing: the controller switches to the cheapest point and every
    stream (greedy and sampled) is the untuned run's."""
    ecfg = EngineConfig(slots=3, max_prompt_len=8, max_seq_len=40,
                        decode_chunk=1, decode_chunks=(1, 2, 4))
    fixed, _ = _run(model, ecfg)
    rec = flightrec.FlightRecorder()
    tuned, sched = _run(
        model, ecfg, tuner.TunerConfig(
            decode_chunk=(1, 2, 4), pipeline_depth=(1, 2), probe_every=2,
            probe_chunks=1, min_measure_chunks=1),
        cost=lambda c, k: {1: 0.010, 2: 0.011, 4: 0.012}[c], recorder=rec)
    assert tuned == fixed
    s = sched.summary()
    assert s["tuner_probes"] >= 2 and s["tuner_switches"] >= 1
    assert s["tuner_decode_chunk"] > 1
    ncols = {e[3][1] for e in rec.events() if e[2] == "dispatch"}
    assert {1, 2} <= ncols and ncols <= {1, 2, 4}


def test_tuned_spec_streams_equal_untuned(model):
    """spec_k rungs (0, 2) on an engine whose base spec_k is 0: the
    tuner owns speculation (no gate), dispatches verify waves of 2
    drafts once they win, and the streams are the plain run's."""
    ecfg = EngineConfig(slots=3, max_prompt_len=8, max_seq_len=40,
                        spec_ks=(2,), spec_hist=8)
    fixed, _ = _run(model, ecfg)
    tuned, sched = _run(
        model, ecfg, tuner.TunerConfig(
            spec_k=(0, 2), probe_every=2, probe_chunks=1,
            min_measure_chunks=1),
        cost=lambda c, k: 0.001 if k else 0.010)
    assert tuned == fixed
    s = sched.summary()
    assert sched._gate is None and s["tuner_spec_k"] == 2.0
    assert s["spec_chunks"] > 0 and s["spec_drafted"] > 0
    assert "spec_gate_state" not in s


def test_bundle_replays_decisions_in_both_packages(model, tmp_path):
    """A tuned run's bundle: the port's ``replay_tuner`` and the JAX
    package's reproduce every decision with bit-equal EWMAs, and the
    bundle carries the ladders and the base point."""
    ecfg = EngineConfig(slots=3, max_prompt_len=8, max_seq_len=40,
                        decode_chunk=1, decode_chunks=(1, 2))
    rec = flightrec.FlightRecorder()
    _, sched = _run(
        model, ecfg, tuner.TunerConfig(
            decode_chunk=(1, 2), pipeline_depth=(1, 2), probe_every=2,
            probe_chunks=1, min_measure_chunks=1),
        cost=lambda c, k: {1: 0.010, 2: 0.011}[c], recorder=rec,
        bundle_dir=str(tmp_path))
    bundle = flightrec.read_bundle(sched.dump_bundle("tuned"))
    sched_cfg = bundle["config.json"]["scheduler"]
    assert sched_cfg["tuner"]["decode_chunk"] == [1, 2]
    assert sched_cfg["tuner_base"] == {"decode_chunk": 1,
                                       "pipeline_depth": 1}
    assert bundle["config.json"]["engine"]["decode_chunks"] == [1, 2]
    ours = replay.replay_tuner(bundle)
    assert ours["mismatches"] == [] and ours["decisions_recorded"] > 0
    assert ours == jreplay.replay_tuner(bundle)


def test_drain_freezes_until_the_next_tick(model):
    cfg, params = model
    rec = flightrec.FlightRecorder()
    sched = Scheduler(
        Engine(cfg, params, EngineConfig(**_GEOM, decode_chunks=(1, 2)),
               device="cpu"),
        pipeline_depth=2, recorder=rec,
        tuner=tuner.TunerConfig(decode_chunk=(1, 2)))
    sched.submit(Request("a", [1, 2, 3], max_tokens=6))
    sched.step()
    sched.drain()
    assert sched._tuner.frozen == "drain"
    sched.step()
    assert sched._tuner.frozen is None
    freezes = [e[3] for e in rec.events() if e[2] == "tuner_freeze"]
    assert freezes == [("enter", "drain"), ("exit", "drain")]
    assert dataclasses.asdict(sched._tuner.cfg)["decode_chunk"] == (1, 2)
