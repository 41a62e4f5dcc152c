"""apex_tpu_torch.telemetry.flightrec and .replay, and _atomic, against
the JAX package on the CPU.

Oracles:

- ``EVENT_FIELDS`` is JAX's vocabulary entry for entry; one sequence of
  ``record`` calls on a fake clock gives the same ``to_dicts`` / ``tail``
  / ``summary`` in both packages, drops included (exact);
- ``write_bundle`` / ``read_bundle``: a bundle either package writes
  reads back equal in both, an existing path is refused, and a failing
  write leaves nothing behind (``_atomic.atomic_dir``);
- a JAX-written bundle (JAX's scheduler over a tiny GPT with a flight
  recorder, spans and a registry, ``dump_bundle``) reads equal through
  the port's ``read_bundle`` and renders JAX's report text byte for byte
  (``render_report``); the port's bundles render the same text in both
  packages;
- a tiny GPT serves on the CPU (greedy and sampled requests, stop
  sequences, two tenants, seeded adapters, a pooled prefix), dumps a
  bundle, and ``replay_bundle`` rebuilds the engine from it (weights from
  ``gpt.init`` at the manifest's seed, adapters from their seeds) and
  replays every stream equal, as does ``python -m
  apex_tpu_torch.telemetry.replay``; a paused run's bundle replays the
  parked and queued streams as extensions of their recorded prefixes;
- ``replay_preemptions`` re-derives every victim of a starved host-swap
  pool's preemptions (JAX's function gives the same verdict);
- a bundle with a fault plan is refused without ``--no-faults`` naming
  the resilience slice, and a bundle recorded on another device type is
  refused; ``versions()`` names torch and CUDA.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving import SamplingParams as JSamplingParams
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu.telemetry import flightrec as jflightrec
from apex_tpu.telemetry import registry as jregistry
from apex_tpu.telemetry import replay as jreplay
from apex_tpu.telemetry import spans as jspans
from apex_tpu_torch import _atomic
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    TenancyConfig,
)
from apex_tpu_torch.telemetry import flightrec, registry, replay, spans

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2)


# -- the recorder and the bundle mechanics ------------------------------------


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _record(mod, capacity):
    rec = mod.FlightRecorder(capacity=capacity, clock=_Clock())
    rec.record("submit", "r0", 3, 8, 1)
    rec.record("admit", "r0", 0, 8, 1, 0, 0)
    for i in range(6):
        rec.record("dispatch", False, 2, 1 + i % 2, 1)
        rec.record("fetch", False, 2, 0.0125 * (i + 1), 1)
    rec.record("tuner_obs", "decode_chunk=2", 2, 0.025, 1)
    rec.record("preempt", "r0", 0, "a", 2, 3.5, {"a": 3.5, "b": 1.0})
    rec.record("not_in_vocabulary", 1, "x")
    rec.record("finish", "r0", "length", 8)
    return rec


def test_event_vocabulary_and_recorder_match_jax():
    assert flightrec.EVENT_FIELDS == jflightrec.EVENT_FIELDS
    for cap in (1000, 5):
        ours, theirs = _record(flightrec, cap), _record(jflightrec, cap)
        assert ours.events() == theirs.events()
        assert ours.to_dicts(ours.events()) == \
            theirs.to_dicts(theirs.events())
        for n in (0, 3, 100):
            assert ours.tail(n) == theirs.tail(n)
        assert ours.summary() == theirs.summary()
        assert ours.seq == theirs.seq == 18
        ours.clear()
        assert ours.summary()["events"] == 0 and ours.seq == 0


def test_bundle_round_trip_between_packages(tmp_path):
    files = {"manifest.json": {"cause": "x", "n": [1, 2.5, None]},
             "events.jsonl": [{"seq": 1, "event": "submit"},
                              {"seq": 2, "event": "finish"}],
             "config.json": {"engine": {"decode_chunks": [1, 2]}}}
    a = flightrec.write_bundle(str(tmp_path / "a"), files)
    b = jflightrec.write_bundle(str(tmp_path / "b"), files)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert open(os.path.join(a, name)).read() == \
            open(os.path.join(b, name)).read()
    assert flightrec.read_bundle(b) == jflightrec.read_bundle(a) == files
    with pytest.raises(FileExistsError, match="immutable"):
        flightrec.write_bundle(a, files)
    with pytest.raises(ValueError, match="not a post-mortem bundle"):
        flightrec.read_bundle(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        flightrec.read_bundle(str(tmp_path / "missing"))
    # a write that fails midway leaves no bundle and no temp directory
    with pytest.raises(FileNotFoundError):
        flightrec.write_bundle(str(tmp_path / "c"), {
            "manifest.json": {}, "no/such/dir.json": {}})
    assert sorted(os.listdir(tmp_path)) == ["a", "b"]


def test_atomic_helpers(tmp_path):
    target = str(tmp_path / "f.bin")
    _atomic.atomic_write(target, lambda f: f.write(b"one"))
    _atomic.atomic_write(target, lambda f: f.write("two"), text=True)
    assert open(target).read() == "two"
    with pytest.raises(RuntimeError):
        _atomic.atomic_write(target, lambda f: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert open(target).read() == "two"
    with _atomic.atomic_path(str(tmp_path / "g")) as tmp:
        open(tmp, "w").write("g")
    with pytest.raises(FileNotFoundError, match="produced no file"):
        with _atomic.atomic_path(str(tmp_path / "h")):
            pass
    assert sorted(os.listdir(tmp_path)) == ["f.bin", "g"]


def test_versions_name_torch_and_cuda():
    v = flightrec.versions()
    assert v["torch"] == torch.__version__
    assert v["cuda"] == torch.version.cuda
    assert v["apex_tpu_torch"] is not None
    assert "jax" not in v and "jaxlib" not in v


# -- a JAX-written bundle through the port's report ---------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    jeng = JEngine(jcfg, params, mesh, JEngineConfig(
        slots=2, max_prompt_len=8, max_seq_len=24, decode_chunk=2))
    return jeng


def test_jax_bundle_reads_and_renders_the_same(model, tmp_path):
    rec = jflightrec.FlightRecorder()
    sched = JScheduler(model, registry=jregistry.Registry(), recorder=rec,
                       spans=jspans.SpanRecorder(), pipeline_depth=2,
                       bundle_meta={"params": {"init_seed": 0}})
    for i in range(4):
        sched.submit(JRequest(
            f"j{i}", [1 + i, 5, 9][: 1 + i % 3], max_tokens=5,
            sampling=(JSamplingParams(temperature=0.8, top_k=5, seed=i)
                      if i % 2 else JSamplingParams())))
    sched.run_until_idle()
    path = sched.dump_bundle("jax-side", bundle_dir=str(tmp_path))
    ours, theirs = flightrec.read_bundle(path), jflightrec.read_bundle(path)
    assert ours == theirs
    text = replay.render_report(ours)
    assert text == jreplay.render_report(theirs)
    assert text.startswith("post-mortem bundle: cause=jax-side")
    assert "requests (4):" in text and "[span] engine.dispatch" in text
    # the CLI's --report path prints the same text
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.telemetry.replay", path,
         "--report"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.rstrip("\n") == text


# -- the port's bundles replayed on the port's engine ------------------------


def _port_cfg(**over):
    return tgpt.GPTConfig(**{**SMALL, "compute_dtype": torch.float32,
                             **over})


def _port_params():
    # the weights replay_bundle rebuilds: gpt.init at seed 0 on the CPU
    return tgpt.init(_port_cfg(), torch.Generator(
        device="cpu").manual_seed(0), device="cpu")


def _port_trace(n=6, prefix=None):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        tail = rng.integers(0, VOCAB, 1 + (3 * i) % 6).tolist()
        prompt = (list(prefix) + tail) if prefix and i % 3 == 0 else tail
        sp = (SamplingParams(temperature=0.9, top_k=12, seed=40 + i)
              if i % 2 else SamplingParams())
        out.append(Request(
            f"p{i}", prompt, max_tokens=10, sampling=sp,
            stop=[[(5 * i) % VOCAB, (5 * i + 1) % VOCAB]] if i == 2
            else None, tenant=("a", "b")[i % 2], adapter=i % 3))
    return out


def test_port_bundle_replays_equal_streams(tmp_path):
    prefix = [11, 12, 13, 14, 15, 16, 17, 18]
    eng = Engine(_port_cfg(), _port_params(), EngineConfig(
        slots=3, max_prompt_len=16, max_seq_len=32, decode_chunk=2,
        prefix_pool_slots=1, adapter_slots=3, adapter_rank=4),
        device="cpu")
    rec = flightrec.FlightRecorder()
    sched = Scheduler(eng, recorder=rec, pipeline_depth=2,
                      registry=registry.Registry(),
                      spans=spans.SpanRecorder(),
                      tenancy=TenancyConfig(weights={"a": 2.0}),
                      bundle_dir=str(tmp_path),
                      bundle_meta={"params": {"init_seed": 0}})
    sched.register_prefix(prefix)
    for s in (100, 101):
        sched.register_adapter(seed=s)
    for r in _port_trace(prefix=prefix):
        sched.submit(r)
    sched.run_until_idle()
    recorded = {rid: c.tokens for rid, c in sched.completions.items()}
    assert len(recorded) == 6
    assert sched.summary()["prefix_hits"] >= 1.0
    assert [e[3][2] for e in rec.events()
            if e[2] == "adapter_register"] == [100, 101]
    path = sched.dump_bundle("replay me")
    bundle = flightrec.read_bundle(path)
    assert bundle["config.json"]["engine"]["adapters"][0]["seed"] == 100
    # the report renders the same text in both packages
    assert replay.render_report(bundle) == jreplay.render_report(bundle)
    out = replay.replay_bundle(path, device="cpu", verbose=False)
    assert out["mismatches"] == [] and out["skipped"] == []
    assert out["matched"] == out["replayed"] == 6
    assert out["streams"] == recorded
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.telemetry.replay", path,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout)["matched"] == 6
    # a fault plan (the JAX package's resilience layer) is refused unless
    # replayed clean; a recording from another device type is refused
    faulty = str(tmp_path / "faulty")
    shutil.copytree(path, faulty)
    with open(os.path.join(faulty, "fault_plan.json"), "w") as f:
        json.dump({"specs": [], "injected": [], "counts": {}}, f)
    with pytest.raises(SystemExit, match="resilience slice"):
        replay.replay_bundle(faulty, device="cpu", verbose=False)
    assert replay.replay_bundle(faulty, device="cpu", no_faults=True,
                                verbose=False)["mismatches"] == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            replay.replay_bundle(path, verbose=False)


def test_paused_run_bundle_replays_as_extensions(tmp_path):
    """A bundle dumped mid-run (conversations parked and queued): each
    replayed stream extends what the client had been streamed."""
    eng = Engine(_port_cfg(), _port_params(), EngineConfig(
        slots=2, max_prompt_len=16, max_seq_len=32, decode_chunk=2,
        page_size=8, host_swap=True), device="cpu")
    sched = Scheduler(eng, recorder=flightrec.FlightRecorder(),
                      bundle_meta={"params": {"init_seed": 0}})
    for r in _port_trace(n=5):
        r.adapter = 0
        sched.submit(r)
    for _ in range(3):
        sched.step()
    parked = sorted(a.request.request_id for a in sched.active.values())
    for rid in parked:
        assert sched.pause(rid)
    bundle_path = sched.dump_bundle("mid-run", bundle_dir=str(tmp_path))
    rows = {r["request_id"]: r for r in flightrec.read_bundle(
        bundle_path)["requests.jsonl"]}
    assert {rows[rid]["status"] for rid in parked} == {"parked"}
    assert any(r["status"] == "queued" for r in rows.values())
    assert all(len(rows[rid]["emitted"]) >= 1 for rid in parked)
    events = [e for e in flightrec.read_bundle(bundle_path)["events.jsonl"]
              if e["event"] == "page_swap_out"]
    assert sorted(e["request_id"] for e in events) == parked
    out = replay.replay_bundle(bundle_path, device="cpu", verbose=False)
    assert out["mismatches"] == [] and out["matched"] == 5


def test_replay_preemptions_on_a_starved_host_tier(tmp_path):
    """Five pages for three tenants: admission pressure preempts; every
    preempt event's victim re-derives from its recorded candidates and
    re-admits before finishing (the port's and JAX's verdicts agree)."""
    eng = Engine(_port_cfg(), _port_params(), EngineConfig(
        slots=3, max_prompt_len=16, max_seq_len=32, decode_chunk=2,
        prompt_buckets=(8, 16), admit_batch_sizes=(1, 2), page_size=8,
        host_swap=True, num_pages=5), device="cpu")
    sched = Scheduler(eng, clock=lambda: 0.0, preempt=True,
                      recorder=flightrec.FlightRecorder(),
                      bundle_meta={"params": {"init_seed": 0}})
    for i in range(5):
        prompt = np.random.default_rng(50 + i).integers(
            0, VOCAB, 1 + (7 * i + 3) % 14).tolist()
        sched.submit(Request(f"r{i}", prompt, max_tokens=12,
                             tenant=("t0", "t1", "t2")[i % 3]))
    sched.run_until_idle()
    assert sched.summary()["preemptions"] >= 1.0
    bundle = flightrec.read_bundle(sched.dump_bundle(
        "starved", bundle_dir=str(tmp_path)))
    ours = replay.replay_preemptions(bundle)
    assert ours == jreplay.replay_preemptions(bundle)
    assert ours["mismatches"] == []
    assert ours["preemptions"] == sched.summary()["preemptions"]
    assert ours["readmitted"] == ours["preemptions"]
    swaps = [e for e in bundle["events.jsonl"]
             if e["event"] == "preempt"]
    assert all(e["candidates"] and e["pages"] >= 1 for e in swaps)
