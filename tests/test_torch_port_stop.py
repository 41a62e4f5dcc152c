"""apex_tpu_torch: stop sequences on the CPU, against the JAX package.

Oracles:

- ``StopMatcher`` gives JAX's flushes, match flags and held tails, push
  by push, on seeded streams over a 3-token alphabet (dense partial
  matches, overlapping stops);
- the port's ``Scheduler`` and JAX's, on one set of weights (a 2-layer
  GPT, JAX's init crossed over through numpy), at ``decode_chunk`` 4 and
  ``pipeline_depth`` 1 and 2, emit the same greedy event stream (token,
  finished, finish reason; logprobs within 1e-4, fp32 on both sides) and
  the same completions for stop sequences that match across a chunk
  boundary, on the first token, behind a held prefix the device's eos
  flushes, and never; sampled requests ride along (their streams are the
  port's own, held to depth 1 == depth 2);
- the trimmed completion is the reference trim of the unstopped stream;
  a deadline that passes while a stop prefix is held streams the held
  token before the timeout, as JAX's scheduler does under the same fake
  clock; the submit rules (an empty stop sequence) use JAX's wording.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.request import SamplingParams as JSamplingParams
from apex_tpu.serving.request import StopMatcher as JStopMatcher
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    StopMatcher,
)

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 256
# init_std 0.2: at the default 0.02 a random model's greedy stream repeats
# its last prompt token, which would make token identity an empty check
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2)
#: decode_chunk 4: the first token comes from the admission, then
#: columns 1-4, 5-8, 9-12 — a stop over tokens 4 and 5 crosses a chunk
GEOM = dict(slots=3, max_prompt_len=16, max_seq_len=40, decode_chunk=4,
            prompt_buckets=(16,), admit_batch_sizes=(1, 2, 3))
N_NEW = 12
#: fp32 on both sides: logprobs agree to rounding
LP_TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """(JAX params, mesh, port params, JAX engine, port engine)."""
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    jeng = JEngine(jcfg, params, mesh, JEngineConfig(**GEOM))
    teng = Engine(tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32),
                  tparams, EngineConfig(**GEOM), device="cpu")
    return params, mesh, tparams, jeng, teng


def _prompts():
    return [np.random.default_rng(700 + i).integers(0, VOCAB, n).tolist()
            for i, n in enumerate([5, 3, 9, 1, 7, 4])]


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return sched


@pytest.fixture(scope="module")
def streams(model):
    """The unstopped greedy streams (JAX's scheduler; a slot's stream is
    its solo ``generate``'s)."""
    _, _, _, jeng, _ = model
    sched = _serve(JScheduler(jeng), [
        JRequest(f"u{i}", p, max_tokens=N_NEW)
        for i, p in enumerate(_prompts())])
    return [sched.completions[f"u{i}"].tokens for i in range(6)]


def _reference_trim(stream, stops):
    """Cut the stream where a stop first completes, the stop excluded."""
    for i in range(len(stream)):
        for stop in stops:
            if i + 1 >= len(stop) and \
                    stream[i + 1 - len(stop):i + 1] == list(stop):
                return stream[:i + 1 - len(stop)], True
    return list(stream), False


def _trace(streams):
    """(request id, prompt, stops, eos, sampled) rows: a stop across the
    chunk boundary (tokens 4, 5), one on the first token, one whose
    prefix is held until the device's eos flushes it, one that never
    matches, two stops (the later-completing one longer), and a sampled
    request with a stop."""
    s = streams
    other = lambda t: (t + 1) % VOCAB          # a token that breaks a match
    return [
        ("cross", 0, [s[0][4:6]], None, False),
        ("first", 1, [s[1][:1]], None, False),
        ("held_eos", 2, [[s[2][5], other(s[2][6])]], s[2][6], False),
        ("never", 3, [[s[3][2], other(s[3][3]), 7]], None, False),
        ("two", 4, [s[4][7:10], s[4][8:9] + [other(s[4][9])]], None, False),
        ("sampled", 5, [[3, 4]], None, True),
    ]


def _requests(streams, cls, sp_cls):
    prompts = _prompts()
    out = []
    for rid, i, stops, eos, sampled in _trace(streams):
        sp = (sp_cls(temperature=0.9, top_k=20, seed=i) if sampled
              else sp_cls())
        out.append(cls(rid, prompts[i], max_tokens=N_NEW, sampling=sp,
                       eos_token_id=eos, stop=[list(x) for x in stops]))
    return out


def _events(sched, rids):
    return [(e.request_id, e.token, e.finished, e.finish_reason,
             e.logprob) for e in sched.pop_events() if e.request_id in rids]


@pytest.mark.parametrize("depth", [1, 2])
def test_scheduler_stop_events_match_jax(model, streams, depth):
    _, _, _, jeng, teng = model
    greedy = {rid for rid, _, _, _, sampled in _trace(streams)
              if not sampled}
    js = _serve(JScheduler(jeng, pipeline_depth=depth),
                _requests(streams, JRequest, JSamplingParams))
    ts = _serve(Scheduler(teng, pipeline_depth=depth),
                _requests(streams, Request, SamplingParams))
    jev, tev = _events(js, greedy), _events(ts, greedy)
    assert [e[:4] for e in tev] == [e[:4] for e in jev]
    for a, b in zip(tev, jev):
        assert (a[4] is None) == (b[4] is None)
        if a[4] is not None:
            assert abs(a[4] - b[4]) <= LP_TOL
    for rid in greedy:
        jc, tc = js.completions[rid], ts.completions[rid]
        assert (tc.tokens, tc.finish_reason) == (jc.tokens,
                                                 jc.finish_reason)
        assert len(tc.logprobs) == len(tc.tokens)
    assert ts.summary()["stop_finishes"] == sum(
        c.finish_reason == "stop" for c in ts.completions.values()) >= 3


def test_stopped_streams_are_the_reference_trims(model, streams):
    """Each completion is the unstopped stream cut where a stop first
    completes; the stream's events carry exactly the completion's tokens
    and end with one finished event."""
    _, _, _, _, teng = model
    sched = _serve(Scheduler(teng, pipeline_depth=2),
                   _requests(streams, Request, SamplingParams))
    events = sched.pop_events()
    for rid, i, stops, eos, sampled in _trace(streams):
        if sampled:
            continue
        full = streams[i]
        if eos is not None:
            full = full[:full.index(eos) + 1]
        want, matched = _reference_trim(full, stops)
        c = sched.completions[rid]
        assert c.tokens == want, rid
        assert c.finish_reason == ("stop" if matched else
                                   "eos" if eos is not None else "length")
        mine = [e for e in events if e.request_id == rid]
        assert [e.token for e in mine if e.token is not None] == want
        assert [e.finished for e in mine] == [False] * (len(mine) - 1) \
            + [True]
    assert sched.completions["first"].tokens == []
    assert sched.completions["cross"].tokens == streams[0][:4]


def test_sampled_streams_equal_across_depths(model, streams):
    _, _, _, _, teng = model
    got = []
    for depth in (1, 2):
        sched = _serve(Scheduler(teng, pipeline_depth=depth),
                       _requests(streams, Request, SamplingParams))
        got.append(sched.completions["sampled"].tokens)
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(4))
def test_stop_matcher_matches_jax(seed):
    rng = np.random.default_rng(seed)
    stops = [rng.integers(0, 3, int(rng.integers(1, 4))).tolist()
             for _ in range(int(rng.integers(1, 4)))]
    stops.append([])                       # empty stops are dropped
    tm, jm = StopMatcher(stops), JStopMatcher(stops)
    assert tm.stops == jm.stops
    for t in rng.integers(0, 3, 40).tolist():
        lp = float(rng.standard_normal())
        assert tm.push(t, lp) == jm.push(t, lp)
        assert tm.pending == jm.pending and tm.matched == jm.matched
        if tm.matched:
            break
    assert tm.flush() == jm.flush()


def test_empty_stop_sequence_is_refused_as_jax(model):
    _, _, _, jeng, teng = model
    errs = []
    for sched, cls in ((JScheduler(jeng), JRequest),
                       (Scheduler(teng), Request)):
        with pytest.raises(ValueError) as e:
            sched.submit(cls("x", [1, 2], max_tokens=2, stop=[[1], []]))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_deadline_flushes_the_held_tail_as_jax(model, streams):
    """Tick 1 admits and decodes tokens 0-4, token 4 held as a stop's
    first token; the deadline passes before tick 2, which streams it and
    times the request out."""
    _, _, _, jeng, teng = model
    s = streams[0]
    stop = [[s[4], (s[5] + 1) % VOCAB]]
    got = []
    for sched_cls, eng, req_cls in ((JScheduler, jeng, JRequest),
                                    (Scheduler, teng, Request)):
        clock = _Clock()
        sched = sched_cls(eng, clock=clock)
        sched.submit(req_cls("d", _prompts()[0], max_tokens=N_NEW,
                             stop=stop, deadline=1.0))
        sched.step()
        held = [e.token for e in sched.events]
        clock.t = 2.0
        sched.step()
        sched.run_until_idle()
        c = sched.completions["d"]
        got.append((held, [(e.token, e.finished, e.finish_reason)
                           for e in sched.pop_events()],
                    c.tokens, c.finish_reason))
    assert got[1] == got[0]
    held, events, tokens, reason = got[1]
    assert held == s[:4] and tokens == s[:5] and reason == "timeout"
    assert events[-2:] == [(s[4], False, None), (None, True, "timeout")]
