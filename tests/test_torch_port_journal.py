"""apex_tpu_torch: the write-ahead journal and crash recovery, on the CPU,
against the JAX package.

- Bytes: for one record sequence (nested engine specs, floats, None,
  unicode, rotation at 4 KiB) the port's ``Journal`` writes JAX's segment
  bytes and manifest, and each package's ``scan_journal`` /
  ``replay_state`` reads the other's directory to the same state.
- The framing cases of JAX's ``tests/test_journal.py`` (round trip and
  stats, validation, a torn tail, a tear dropping later segments,
  rotation and the manifest, compaction, auto-compaction and its failure
  under ENOSPC, adapter-id remapping and name mapping across recoveries,
  gap anomalies) run on both packages, each with JAX's assertions, and
  give the same observations.
- The scheduler's hooks: one trace served journaled by both schedulers
  (and, paged with the host tier, paused and resumed) appends the same
  record sequence — kinds, ids, offsets, greedy tokens.
- In-process crash recovery: a journaled run cut after four ticks and
  recovered with ``recover_scheduler`` onto a fresh engine finishes every
  stream as the uninterrupted run did (the greedy ones JAX's too). The
  LoRA, paged-int8 and SIGKILL cases are slow, as in JAX.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import _atomic as jatomic
from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import journal as jjournal
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.request import SamplingParams as JSamplingParams
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu_torch import _atomic
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    journal,
)

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 96
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
GEOM = dict(slots=2, max_prompt_len=8, max_seq_len=24, decode_chunk=2)
SWAP = dict(slots=2, max_prompt_len=8, max_seq_len=24, decode_chunk=2,
            page_size=8, host_swap=True)
PACKAGES = {"port": (journal, _atomic), "jax": (jjournal, jatomic)}


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jcfg, params, mesh, tparams


_TCFG = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)


def _reqs(req_cls, sp_cls, n, *, seed0=7400, max_tokens=6, greedy=False):
    """JAX's journal trace shape with numpy prompts: greedy and seeded
    sampled requests alternating (all greedy with ``greedy``)."""
    out = []
    for i in range(n):
        prompt = np.random.default_rng(seed0 + i).integers(
            0, VOCAB, 2 + (3 * i) % 6).tolist()
        sp = (sp_cls(temperature=0.9, top_k=7, seed=seed0 + i)
              if i % 2 and not greedy else sp_cls())
        out.append(req_cls(f"j{i}", prompt, max_tokens=max_tokens,
                           sampling=sp))
    return out


# -- bytes ---------------------------------------------------------------------


def _write(mod, path):
    with mod.Journal(path, fsync="none", segment_bytes=4096) as j:
        j.append("meta", format=1, engine_spec={
            "model": {"vocab_size": 96, "dtype": "float32"},
            "engine": {"slots": 2, "buckets": [8, 16], "x": None}})
        j.append("adapter", name="lora-ü", seed=7, rank=4, adapter_id=1)
        j.append("prefix", tokens=[1, 2, 3, 4])
        for i in range(40):
            j.append("submit", request_id=f"r{i}", order=i,
                     prompt=list(range(i % 9 + 1)), max_tokens=6,
                     temperature=0.9 if i % 2 else 0.0, top_k=7,
                     top_p=1.0, seed=None if i % 3 else i,
                     deadline_remaining=None if i % 4 else 1.25,
                     stop=[[3, 4]] if i % 5 == 0 else None)
            j.append("extend", request_id=f"r{i}", start=0,
                     tokens=[i, i + 1, 7],
                     logprobs=[-0.5, -1.0 / 3.0, -2.25e-7])
            if i % 3 == 0:
                j.append("finish", request_id=f"r{i}", reason="length")
        return j.segments(), j.rotations


def _dir_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_journal_bytes_equal_jax(tmp_path):
    segs, rots = _write(journal, str(tmp_path / "port"))
    jsegs, jrots = _write(jjournal, str(tmp_path / "jax"))
    assert (segs, rots) == (jsegs, jrots) and rots >= 2
    assert _dir_bytes(str(tmp_path / "port")) == \
        _dir_bytes(str(tmp_path / "jax"))


def test_each_package_reads_the_others_journal(tmp_path):
    for writer, reader in ((journal, jjournal), (jjournal, journal)):
        path = str(tmp_path / writer.__name__.split(".")[0])
        _write(writer, path)
        a, ta = writer.scan_journal(path)
        b, tb = reader.scan_journal(path)
        assert a == b and ta == tb == 0
        sa, sb = writer.replay_state(a), reader.replay_state(b)
        assert (sa.meta, sa.adapters, sa.prefixes, sa.requests,
                sa.anomalies) == (sb.meta, sb.adapters, sb.prefixes,
                                  sb.requests, sb.anomalies)
        assert [r["request_id"] for r in sb.unfinished()] == \
            [r["request_id"] for r in sa.unfinished()]
        # and appends continue on the other package's tail
        with reader.Journal(path) as j:
            assert j.seq == len(a)
            j.append("finish", request_id="r1", reason="stop")
        assert writer.replay_state(writer.scan_journal(path)[0]) \
            .requests["r1"]["finish_reason"] == "stop"


# -- JAX's framing cases, on both packages ---------------------------------------


def _roundtrip(mod, atomic, jd, monkeypatch):
    with mod.Journal(jd, fsync="always") as j:
        assert j.append("submit", request_id="r0", prompt=[1, 2]) == 1
        assert j.append("extend", request_id="r0", start=0,
                        tokens=[5, 6], logprobs=[0.0, -1.5]) == 2
        assert j.append("finish", request_id="r0", reason="length") == 3
        assert j.seq == 3 and j.appends == 3 and j.fsyncs >= 3
        st = {k: v for k, v in j.stats().items() if k != "fsync_s"}
    records, truncated = mod.scan_journal(jd)
    assert truncated == 0
    with mod.Journal(jd) as j2:
        assert j2.seq == 3 and j2.append("submit", request_id="r1") == 4
    return st, records


def _validation(mod, atomic, jd, monkeypatch):
    out = []
    for call, exc in ((lambda: mod.Journal(jd + "a", fsync="sometimes"),
                       ValueError),
                      (lambda: mod.Journal(jd + "b", segment_bytes=16),
                       ValueError),
                      (lambda: mod.scan_journal(jd + "missing"),
                       mod.JournalError)):
        with pytest.raises(exc) as e:
            call()
        out.append(str(e.value).replace(jd, "<dir>"))
    return out


def _torn_tail(mod, atomic, jd, monkeypatch):
    with mod.Journal(jd, fsync="always") as j:
        for i in range(4):
            j.append("submit", request_id=f"r{i}")
        seg = os.path.join(jd, j.segments()[-1])
    good_size = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(b"\x07\x00")
    records, truncated = mod.scan_journal(jd)
    out = [(len(records), truncated)]
    assert len(records) == 4 and truncated == 2
    with open(seg, "r+b") as f:
        f.seek(good_size // 2)
        byte = f.read(1)
        f.seek(good_size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    records, truncated = mod.scan_journal(jd)
    assert len(records) < 4 and truncated > 2
    out.append((len(records), truncated))
    n_before = len(records)
    mod.scan_journal(jd, repair=True)
    assert os.path.getsize(seg) < good_size
    with mod.Journal(jd, fsync="always") as j2:
        j2.append("submit", request_id="post_repair")
    records, truncated = mod.scan_journal(jd)
    assert truncated == 0
    assert [r["request_id"] for r in records] == \
        [f"r{i}" for i in range(n_before)] + ["post_repair"]
    return out, records


def _tear_later(mod, atomic, jd, monkeypatch):
    with mod.Journal(jd, fsync="always", segment_bytes=4096) as j:
        blob = list(range(200))
        while j.rotations < 2:
            j.append("extend", request_id="r0", start=0, tokens=blob,
                     logprobs=[])
        segs = [os.path.join(jd, s) for s in j.segments()]
        total = j.appends
    assert len(segs) >= 3
    with open(segs[0], "r+b") as f:
        f.truncate(os.path.getsize(segs[0]) - 3)
    records, truncated = mod.scan_journal(jd)
    assert len(records) < total
    assert truncated >= sum(os.path.getsize(s) for s in segs[1:])
    out = (len(records), truncated)
    mod.scan_journal(jd, repair=True)
    assert [os.path.exists(s) for s in segs] == [True, False, False]
    with mod.Journal(jd) as j2:
        j2.append("submit", request_id="r1")
    assert mod.scan_journal(jd)[1] == 0
    return out


def _rotation(mod, atomic, jd, monkeypatch):
    with mod.Journal(jd, segment_bytes=4096) as j:
        payload = list(range(300))
        while j.rotations < 2:
            j.append("extend", request_id="r0", start=0,
                     tokens=payload, logprobs=[])
        assert len(j.segments()) == j.rotations + 1
        name, n_records, n_bytes = j.last_sealed
        assert n_records > 0
        sealed = j.last_sealed
    with open(os.path.join(jd, "journal.json")) as f:
        manifest = json.load(f)
    records, truncated = mod.scan_journal(jd)
    assert truncated == 0
    assert [r["seq"] for r in records] == list(range(1, len(records) + 1))
    return sealed, manifest, len(records)


def _compaction(mod, atomic, jd, monkeypatch):
    j = mod.Journal(jd, segment_bytes=4096)
    j.append("meta", format=1, engine_spec={"model": {"x": 1}})
    j.append("adapter", name="lora_a", seed=7, rank=4, adapter_id=1)
    j.append("prefix", tokens=[1, 2, 3, 4])
    for i in range(3):
        j.append("submit", request_id=f"r{i}", order=i, prompt=[i],
                 max_tokens=6, temperature=0.0)
    j.append("extend", request_id="r0", start=0, tokens=[10, 11],
             logprobs=[0.0, 0.0])
    j.append("extend", request_id="r1", start=0, tokens=[20],
             logprobs=[0.0])
    j.append("extend", request_id="r1", start=1, tokens=[21],
             logprobs=[0.0])
    j.append("finish", request_id="r0", reason="length")
    j.append("park", request_id="r2")
    res = j.compact()
    assert res["dropped_finished"] == 1 and len(j.segments()) == 1
    records, truncated = mod.scan_journal(jd)
    st = mod.replay_state(records)
    assert set(st.requests) == {"r1", "r2"}
    assert st.requests["r1"]["emitted"] == [20, 21]
    assert st.requests["r2"]["parked"] is True
    dup = mod.replay_state(records + records)
    assert dup.requests["r1"]["emitted"] == [20, 21] and dup.anomalies == 0
    j.append("extend", request_id="r1", start=2, tokens=[22],
             logprobs=[0.0])
    j.close()
    st2 = mod.replay_state(mod.scan_journal(jd)[0])
    assert st2.requests["r1"]["emitted"] == [20, 21, 22]
    return res, records, _dir_bytes(jd)


def _auto_compaction(mod, atomic, jd, monkeypatch):
    with mod.Journal(jd, compact_min_finished=2) as j:
        for i in range(2):
            j.append("submit", request_id=f"r{i}", order=i, prompt=[i],
                     max_tokens=4)
            j.append("finish", request_id=f"r{i}", reason="length")
        assert j.maybe_compact() is True and j.compactions == 1
        assert j.maybe_compact() is False
    assert mod.replay_state(mod.scan_journal(jd)[0]).requests == {}
    return _dir_bytes(jd)


def _compaction_failure(mod, atomic, jd, monkeypatch):
    j = mod.Journal(jd, compact_min_finished=1)
    j.append("submit", request_id="r0", order=0, prompt=[1], max_tokens=4)
    j.append("finish", request_id="r0", reason="length")
    j.append("submit", request_id="r1", order=1, prompt=[2], max_tokens=4)

    def no_space(path, write_fn, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(atomic, "atomic_write", no_space)
    assert j.maybe_compact() is False and j.compaction_errors == 1
    j.append("finish", request_id="r0", reason="length")
    with pytest.raises(OSError, match="No space"):
        j.compact()
    j.append("extend", request_id="r1", start=0, tokens=[7],
             logprobs=[0.0])
    monkeypatch.undo()
    res = j.compact()
    assert res["dropped_finished"] == 1 and j.compactions == 1
    j.append("finish", request_id="r1", reason="length")
    j.close()
    records, truncated = mod.scan_journal(jd)
    st = mod.replay_state(records)
    assert set(st.requests) == {"r1"}
    assert st.requests["r1"]["emitted"] == [7]
    assert st.requests["r1"]["finished"] is True
    return res, records


class _StubScheduler:
    """``replay_into``'s surface without an engine: sequential adapter
    ids (the engine's policy) and a record of every resubmission."""

    recorder = None
    telemetry = None

    def __init__(self):
        self._journal_recovered = 0
        self._next_adapter = 1
        self.registered = []
        self.submitted = []

    def clock(self):
        return 100.0

    def register_adapter(self, weights=None, *, name=None, seed=None):
        aid = self._next_adapter
        self._next_adapter += 1
        self.registered.append((name, seed, aid))
        return aid

    def register_prefix(self, tokens):
        return 1

    def submit(self, req, *, replay_prefix=None, replay_logprobs=None):
        self.submitted.append((req.request_id, req.adapter,
                               list(replay_prefix or [])))


def _remap(mod, atomic, jd, monkeypatch):
    records = [
        {"kind": "adapter", "name": "explicit", "seed": None,
         "rank": 4, "adapter_id": 1},
        {"kind": "adapter", "name": "seeded", "seed": 5,
         "rank": 4, "adapter_id": 2},
        {"kind": "submit", "request_id": "base", "order": 0,
         "prompt": [1], "max_tokens": 4, "adapter": 0},
        {"kind": "submit", "request_id": "shifted", "order": 1,
         "prompt": [2], "max_tokens": 4, "adapter": 2},
        {"kind": "submit", "request_id": "dead", "order": 2,
         "prompt": [3], "max_tokens": 4, "adapter": 1},
        {"kind": "submit", "request_id": "lost", "order": 3,
         "prompt": [4], "max_tokens": 4, "adapter": 9},
    ]
    sched = _StubScheduler()
    report = mod.replay_into(sched, records)
    assert [(n, s) for n, s, _ in sched.registered] == [("seeded", 5)]
    assert {r: a for r, a, _ in sched.submitted} == \
        {"base": 0, "shifted": 1}
    assert (report.requests, report.adapters, report.skipped_adapters,
            report.skipped_adapter_requests) == (2, 1, 1, 2)
    return report.as_dict(), sched.submitted


def _by_name(mod, atomic, jd, monkeypatch):
    records = [
        {"kind": "adapter", "name": "explicit", "seed": None,
         "rank": 4, "adapter_id": 1},
        {"kind": "adapter", "name": "adapter-seed-9", "seed": 9,
         "rank": 4, "adapter_id": 2},
        {"kind": "submit", "request_id": "pinned", "order": 0,
         "prompt": [1], "max_tokens": 4, "adapter": 1,
         "adapter_name": "explicit"},
        {"kind": "submit", "request_id": "live", "order": 1,
         "prompt": [2], "max_tokens": 4, "adapter": 2,
         "adapter_name": "adapter-seed-9"},
        {"kind": "adapter", "name": "adapter-seed-9", "seed": 9,
         "rank": 4, "adapter_id": 1},
        {"kind": "submit", "request_id": "live", "order": 1,
         "prompt": [2], "max_tokens": 4, "adapter": 1,
         "adapter_name": "adapter-seed-9"},
        {"kind": "extend", "request_id": "live", "start": 0,
         "tokens": [4, 5], "logprobs": [0.0, -1.0]},
    ]
    sched = _StubScheduler()
    report = mod.replay_into(sched, records)
    assert [(n, s) for n, s, _ in sched.registered] == \
        [("adapter-seed-9", 9)]
    assert sched.submitted == [("live", 1, [4, 5])]
    assert (report.skipped_adapters, report.skipped_adapter_requests,
            report.requests) == (1, 1, 1)
    return report.as_dict()


def _gaps(mod, atomic, jd, monkeypatch):
    st = mod.replay_state([
        {"kind": "submit", "request_id": "r0", "order": 0,
         "prompt": [1], "max_tokens": 4},
        {"kind": "extend", "request_id": "r0", "start": 3,
         "tokens": [9], "logprobs": [0.0]},
        {"kind": "extend", "request_id": "ghost", "start": 0,
         "tokens": [1], "logprobs": [0.0]},
    ])
    assert st.anomalies == 2 and st.requests["r0"]["emitted"] == []
    return st.anomalies, st.requests


CASES = {"roundtrip": _roundtrip, "validation": _validation,
         "torn_tail": _torn_tail, "tear_drops_later": _tear_later,
         "rotation": _rotation, "compaction": _compaction,
         "auto_compaction": _auto_compaction,
         "compaction_failure": _compaction_failure,
         "adapter_remap": _remap, "adapter_by_name": _by_name,
         "gap_anomalies": _gaps}


@pytest.mark.parametrize("case", list(CASES))
def test_framing_cases_match_jax(case, tmp_path, monkeypatch):
    got = {}
    for name, (mod, atomic) in PACKAGES.items():
        got[name] = CASES[case](mod, atomic, str(tmp_path / name / "wal"),
                                monkeypatch)
    assert got["port"] == got["jax"]


# -- the scheduler's hooks and crash recovery ------------------------------------


def _journaled_run(sched_cls, eng, reqs, jd, jmod, pause=False):
    j = jmod.Journal(jd, fsync="batch")
    sched = sched_cls(eng, journal=j, clock=lambda: 0.0)
    for r in reqs:
        sched.submit(r)
    if pause:
        for _ in range(2):
            sched.step()
        paused = [rid for rid in sorted(a.request.request_id
                                        for a in sched.active.values())
                  if sched.pause(rid)]
        assert paused
        sched.step()
        for rid in paused:
            sched.resume(rid)
    sched.run_until_idle()
    j.close()
    return [{k: v for k, v in r.items() if k not in ("logprobs",
                                                     "engine_spec")}
            for r in jmod.scan_journal(jd)[0]]


@pytest.mark.parametrize("geom", ["contiguous", "host_swap"])
def test_scheduler_journals_jax_records(model, tmp_path, geom):
    ecfg = GEOM if geom == "contiguous" else SWAP
    jcfg, params, mesh, tparams = model
    port = _journaled_run(
        Scheduler, Engine(_TCFG, tparams, EngineConfig(**ecfg),
                          device="cpu"),
        _reqs(Request, SamplingParams, 4, greedy=True),
        str(tmp_path / "port"), journal, pause=geom == "host_swap")
    jax_side = _journaled_run(
        JScheduler, JEngine(jcfg, params, mesh, JEngineConfig(**ecfg)),
        _reqs(JRequest, JSamplingParams, 4, greedy=True),
        str(tmp_path / "jax"), jjournal, pause=geom == "host_swap")
    assert port == jax_side
    kinds = {r["kind"] for r in port}
    assert {"meta", "submit", "extend", "finish"} <= kinds
    if geom == "host_swap":
        assert {"park", "resume"} <= kinds


def _serve_crash(eng_factory, reqs, jd, steps=4):
    ref_sched = Scheduler(eng_factory())
    for r in reqs:
        ref_sched.submit(r)
    ref_sched.run_until_idle()
    ref = {k: c.tokens for k, c in ref_sched.completions.items()}
    j = journal.Journal(jd, fsync="batch")
    victim = Scheduler(eng_factory(), journal=j)
    for r in reqs:
        victim.submit(r)
    for _ in range(steps):
        victim.step()
    prior = {k: c.tokens for k, c in victim.completions.items()}
    assert 0 < len(prior) < len(reqs), "crash point degenerate"
    # the crash: the journal sealed at its fsync boundary, the engine and
    # the scheduler dropped
    j.close()
    del victim
    sched2, report = journal.recover_scheduler(jd, eng_factory)
    assert report.requests == len(reqs) - len(prior)
    assert report.truncated_bytes == 0
    sched2.run_until_idle()
    sched2.journal.close()
    merged = dict(prior)
    merged.update({k: c.tokens for k, c in sched2.completions.items()})
    assert merged == ref
    s = sched2.summary()
    assert s["journal_recovered_requests"] == float(report.requests)
    for key in ("journal_appends", "journal_bytes", "journal_fsyncs",
                "journal_segments"):
        assert key in s
    return merged, report


def test_crash_recovery_streams_bit_identical(model, tmp_path):
    jcfg, params, mesh, tparams = model
    reqs = _reqs(Request, SamplingParams, 4)
    merged, report = _serve_crash(
        lambda: Engine(_TCFG, tparams, EngineConfig(**GEOM), device="cpu"),
        reqs, str(tmp_path / "wal"))
    # the greedy streams are JAX's uninterrupted run's
    jsched = JScheduler(JEngine(jcfg, params, mesh, JEngineConfig(**GEOM)))
    for r in _reqs(JRequest, JSamplingParams, 4):
        jsched.submit(r)
    jsched.run_until_idle()
    for r in reqs:
        if r.sampling.temperature == 0:
            assert merged[r.request_id] == \
                jsched.completions[r.request_id].tokens
    # a second crash recovers from the same directory, nothing left
    sched3, report3 = journal.recover_scheduler(
        str(tmp_path / "wal"),
        lambda: Engine(_TCFG, tparams, EngineConfig(**GEOM), device="cpu"))
    assert report3.requests == 0 and sched3.idle()
    sched3.journal.close()


def test_recovery_refuses_an_incompatible_engine(model, tmp_path):
    tparams = model[3]
    jd = str(tmp_path / "wal")
    j = journal.Journal(jd)
    sched = Scheduler(Engine(_TCFG, tparams, EngineConfig(**GEOM),
                             device="cpu"), journal=j)
    sched.submit(_reqs(Request, SamplingParams, 1)[0])
    j.close()
    other = dict(GEOM, decode_chunk=1)
    with pytest.raises(journal.JournalError, match="incompatible"):
        journal.recover_scheduler(jd, lambda: Engine(
            _TCFG, tparams, EngineConfig(**other), device="cpu"))


@pytest.mark.slow
def test_recovery_replays_lora_adapters_onto_fresh_engine(model, tmp_path):
    tparams = model[3]
    ecfg = EngineConfig(**GEOM, adapter_slots=3, adapter_rank=4)
    explicit = tgpt.init_lora_weights(_TCFG, 4, 777)

    def build():
        return Engine(_TCFG, tparams, ecfg, device="cpu")

    reqs = _reqs(Request, SamplingParams, 4, seed0=8100)
    for i, r in enumerate(reqs):
        r.adapter = 2 * (i % 2)
    ref_sched = Scheduler(build())
    assert ref_sched.register_adapter(explicit, name="explicit") == 1
    assert ref_sched.register_adapter(seed=123) == 2
    for r in reqs:
        ref_sched.submit(r)
    ref_sched.run_until_idle()
    ref = {k: c.tokens for k, c in ref_sched.completions.items()}
    jd = str(tmp_path / "wal")
    j = journal.Journal(jd)
    victim = Scheduler(build(), journal=j)
    victim.register_adapter(explicit, name="explicit")
    victim.register_adapter(seed=123)
    for r in _reqs(Request, SamplingParams, 4, seed0=8100):
        r.adapter = 2 * (int(r.request_id[1:]) % 2)
        victim.submit(r)
    for _ in range(3):
        victim.step()
    prior = {k: c.tokens for k, c in victim.completions.items()}
    j.close()
    sched2, report = journal.recover_scheduler(jd, build)
    assert (report.adapters, report.skipped_adapters,
            report.skipped_adapter_requests) == (1, 1, 0)
    assert sched2.engine.adapters_registered == 1
    sched2.run_until_idle()
    sched2.journal.close()
    merged = dict(prior)
    merged.update({k: c.tokens for k, c in sched2.completions.items()})
    assert merged == ref


@pytest.mark.slow
def test_recovery_paged_int8_composition(model, tmp_path):
    tparams = model[3]
    cfg8 = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32,
                          kv_cache_dtype="int8")
    ecfg = EngineConfig(**GEOM, page_size=8)
    _serve_crash(lambda: Engine(cfg8, tparams, ecfg, device="cpu"),
                 _reqs(Request, SamplingParams, 4, seed0=8200),
                 str(tmp_path / "wal"), steps=3)


@pytest.mark.slow
def test_sigkill_drill_recovers_bit_identical(tmp_path):
    from apex_tpu_torch.serving import resilience

    res = resilience.sigkill_drill(str(tmp_path), requests=3,
                                   max_tokens=10, kill_after_tokens=6,
                                   timeout_s=300.0, device="cpu")
    assert res["parity"], (res["reference"], res["recovered"])
    assert res["killed_at_tokens"] >= 6
    assert res["recovered_requests"] >= 1
    assert res["recovery_ms"] > 0.0
    assert set(res["child_s"]) == {"reference", "victim", "recover"}
