"""Request scheduler — the host loop over an :class:`Engine`.

Port of the FIFO core of ``apex_tpu/serving/scheduler.py``: a bounded
FIFO queue, batched admission of queued requests into free slots
(``Engine.admit_many``), one decode chunk per tick, deadline expiry,
the per-request response stream (:class:`StreamEvent`), completions and
the serving summary. Resilience, tenancy, the journal, speculation,
the tuner, pipelining, SLOs, the flight recorder and telemetry are later
slices of the port; requests carrying ``stop`` sequences, a schema
``constraint``, a tenant other than ``"default"`` or an adapter other
than 0 are rejected at submit.

>>> sched = Scheduler(engine)
>>> sched.submit(Request("r0", prompt, max_tokens=16))
>>> sched.run_until_idle()
>>> sched.completions["r0"].tokens
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from apex_tpu_torch.serving.engine import Admission, Engine
from apex_tpu_torch.serving.request import (
    DEFAULT_TENANT,
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_TIMEOUT,
    Completion,
    Request,
    StreamEvent,
)


class QueueFull(RuntimeError):
    """Raised by :meth:`Scheduler.submit` when the queue is at capacity."""


class LatencyStats:
    """Latency accumulator over the most recent ``capacity`` samples
    (seconds), summarised to mean and percentiles in milliseconds."""

    def __init__(self, capacity: int = 8192):
        self._ring: Deque[float] = collections.deque(maxlen=capacity)
        self.total = 0

    def add(self, seconds: float) -> None:
        self._ring.append(seconds)
        self.total += 1

    def summary(self) -> Dict[str, float]:
        """``{count, mean_ms, p50_ms, p90_ms, p99_ms, max_ms}`` (empty
        before the first sample)."""
        if not self._ring:
            return {}
        v = np.asarray(self._ring, np.float64) * 1e3
        return {
            "count": float(self.total),
            "mean_ms": float(v.mean()),
            "p50_ms": float(np.percentile(v, 50)),
            "p90_ms": float(np.percentile(v, 90)),
            "p99_ms": float(np.percentile(v, 99)),
            "max_ms": float(v.max()),
        }


class _Active:
    """Host view of one occupied slot."""

    __slots__ = ("request", "tokens", "logprobs", "first_token_time")

    def __init__(self, request: Request):
        self.request = request
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.first_token_time: Optional[float] = None


class Scheduler:
    """Drive an :class:`Engine` over a stream of requests.

    ``clock`` is injectable (tests drive deadlines with a fake clock) and
    must be monotonic. Each tick hands every queued request that fits the
    free slots to ``Engine.admit_many``."""

    def __init__(self, engine: Engine, *, max_queue: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.max_queue = max_queue
        self.clock = clock
        self.queue: Deque[Request] = collections.deque()
        self.active: Dict[int, _Active] = {}
        self._free: List[int] = list(range(engine.slots))[::-1]
        self.events: List[StreamEvent] = []
        self.completions: Dict[str, Completion] = {}
        self.ttft_stats = LatencyStats()
        self.token_latency_stats = LatencyStats()
        self._started: Optional[float] = None
        self._steps = 0
        self._tokens_emitted = 0
        self._decode_tokens = 0
        self._decode_time = 0.0
        self._admitted_requests = 0
        self._admit_dispatches = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue ``request``; raises :class:`QueueFull` at capacity and
        ``ValueError`` on an invalid request. A prompt that already ends
        in the request's eos token completes here with no tokens."""
        rid = request.request_id
        if rid in self.completions or any(
                a.request.request_id == rid for a in self.active.values()) \
                or any(r.request_id == rid for r in self.queue):
            raise ValueError(f"duplicate request_id {rid!r}")
        if request.stop:
            raise ValueError("stop sequences are not supported by "
                             "apex_tpu_torch yet (a later slice)")
        if request.constraint is not None:
            raise ValueError("schema constraints are not supported by "
                             "apex_tpu_torch yet (a later slice)")
        if request.tenant not in (DEFAULT_TENANT, ""):
            raise ValueError("tenants are not supported by apex_tpu_torch "
                             "yet (a later slice)")
        if request.adapter:
            raise ValueError("LoRA adapters are not supported by "
                             "apex_tpu_torch yet (a later slice)")
        request.sampling.validate()
        prompt = list(request.prompt)
        ecfg = self.engine.engine_cfg
        limit = min(ecfg.max_prompt_len, ecfg.max_seq_len - 1)
        if not 1 <= len(prompt) <= limit:
            raise ValueError(
                f"prompt length {len(prompt)} outside [1, {limit}]")
        room = ecfg.max_seq_len - len(prompt)
        if not 1 <= request.max_tokens <= room:
            raise ValueError(
                f"max_tokens {request.max_tokens} outside [1, {room}] for "
                f"a {len(prompt)}-token prompt at max_seq_len "
                f"{ecfg.max_seq_len}")
        eos = request.eos_token_id
        if eos is not None and not 0 <= eos < self.engine.cfg.vocab_size:
            raise ValueError(
                f"eos_token_id {eos} outside vocab "
                f"[0, {self.engine.cfg.vocab_size})")
        now = self.clock()
        request.arrival_time = now
        if eos is not None and prompt[-1] == eos:
            self._complete(request, [], [], FINISH_EOS, ttft=None, now=now)
            self.events.append(StreamEvent(rid, None, True, FINISH_EOS))
            return
        if len(self.queue) >= self.max_queue:
            raise QueueFull(f"queue at capacity ({len(self.queue)})")
        self.queue.append(request)

    # -- the loop ----------------------------------------------------------

    def step(self) -> None:
        """One tick: expire deadlines, admit queued requests into free
        slots, then decode one chunk if any slot is live and unpack it."""
        now = self.clock()
        if self._started is None:
            self._started = now
        self._expire(now)
        self._admit(now)
        if self.active:
            self._decode()
        self._steps += 1

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until the queue and the slots are empty."""
        steps = 0
        while self.queue or self.active:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"not idle after {max_steps} steps — live slots "
                    f"{sorted(self.active)}, queue {len(self.queue)}")

    def pop_events(self) -> List[StreamEvent]:
        """Drain the response stream."""
        out, self.events = self.events, []
        return out

    def idle(self) -> bool:
        return not (self.queue or self.active)

    # -- internals ---------------------------------------------------------

    def _expire(self, now: float) -> None:
        kept: Deque[Request] = collections.deque()
        for r in self.queue:
            if r.deadline is not None and now >= r.deadline:
                self.events.append(StreamEvent(r.request_id, None, True,
                                               FINISH_TIMEOUT))
                self._complete(r, [], [], FINISH_TIMEOUT, ttft=None, now=now)
            else:
                kept.append(r)
        self.queue = kept
        for slot in list(self.active):
            act = self.active[slot]
            dl = act.request.deadline
            if dl is not None and now >= dl:
                self.engine.retire(slot)
                self.events.append(StreamEvent(
                    act.request.request_id, None, True, FINISH_TIMEOUT))
                self._release(slot, FINISH_TIMEOUT, now)

    def _admit(self, now: float) -> None:
        if not self.queue or not self._free:
            return
        n = min(len(self._free), len(self.queue))
        reqs = [self.queue.popleft() for _ in range(n)]
        slots = [self._free.pop() for _ in range(n)]
        results = self.engine.admit_many([
            Admission(slot=slot, prompt=r.prompt, max_tokens=r.max_tokens,
                      temperature=r.sampling.temperature,
                      top_k=r.sampling.top_k, top_p=r.sampling.top_p,
                      seed=r.sampling.seed, eos_token_id=r.eos_token_id)
            for r, slot in zip(reqs, slots)])
        t_first = self.clock()
        self._admitted_requests += n
        self._admit_dispatches += results[-1].group + 1
        for r, slot, res in zip(reqs, slots, results):
            act = _Active(r)
            act.first_token_time = t_first
            self.active[slot] = act
            self.ttft_stats.add(t_first - r.arrival_time)
            reason = None
            if res.finished:
                reason = FINISH_EOS if res.hit_eos else FINISH_LENGTH
            self._emit(slot, act, res.first_token, res.logprob,
                       finished=res.finished, reason=reason, now=t_first)

    def _decode(self) -> None:
        t0 = self.clock()
        snapshot = dict(self.active)
        tokens, logprobs, finished = self.engine.step()
        now = self.clock()
        self._decode_time += now - t0
        n_cols = tokens.shape[1]
        per_tok = (now - t0) / n_cols
        for j in range(n_cols):
            for slot, act in snapshot.items():
                # a slot released at an earlier column emits pad after it
                if self.active.get(slot) is not act:
                    continue
                tok = int(tokens[slot, j])
                done = bool(finished[slot, j])
                reason = None
                if done:
                    eos = act.request.eos_token_id
                    reason = (FINISH_EOS if eos is not None and tok == eos
                              else FINISH_LENGTH)
                self._decode_tokens += 1
                self.token_latency_stats.add(per_tok)
                self._emit(slot, act, tok, float(logprobs[slot, j]),
                           finished=done, reason=reason, now=now)

    def _emit(self, slot: int, act: _Active, tok: int, lp: float, *,
              finished: bool, reason: Optional[str], now: float) -> None:
        act.tokens.append(tok)
        act.logprobs.append(lp)
        self._tokens_emitted += 1
        self.events.append(StreamEvent(act.request.request_id, tok,
                                       finished, reason, logprob=lp))
        if finished:
            self._release(slot, reason, now)

    def _release(self, slot: int, reason: str, now: float) -> None:
        act = self.active.pop(slot)
        self._free.append(slot)
        ttft = (None if act.first_token_time is None
                else act.first_token_time - act.request.arrival_time)
        self._complete(act.request, act.tokens, act.logprobs, reason,
                       ttft=ttft, now=now)

    def _complete(self, request: Request, tokens: List[int],
                  logprobs: List[float], reason: str, *,
                  ttft: Optional[float], now: float) -> None:
        arrival = (request.arrival_time if request.arrival_time is not None
                   else now)
        self.completions[request.request_id] = Completion(
            request.request_id, list(tokens), reason, ttft=ttft,
            latency=now - arrival, logprobs=list(logprobs))

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Aggregate serving metrics: request and token counts,
        ``tokens_per_sec`` (all emitted tokens over the wall time since
        the first tick), ``decode_tokens_per_sec`` (decode-chunk tokens
        over the time spent in decode chunks — admission, the TTFT side,
        excluded), and ``ttft_*`` / ``token_latency_*`` in ms."""
        out = {
            "requests_completed": float(len(self.completions)),
            "tokens_emitted": float(self._tokens_emitted),
            "steps": float(self._steps),
            "admitted_requests": float(self._admitted_requests),
            "admit_dispatches": float(self._admit_dispatches),
            "decode_steps": float(self.engine.decode_steps_taken),
            "cache_bytes": float(self.engine.cache_bytes()),
        }
        if self._started is not None:
            elapsed = max(self.clock() - self._started, 1e-9)
            out["tokens_per_sec"] = self._tokens_emitted / elapsed
        if self._decode_time > 0:
            out["decode_tokens_per_sec"] = (
                self._decode_tokens / self._decode_time)
            out["decode_tokens"] = float(self._decode_tokens)
            out["decode_time_s"] = self._decode_time
        for name, stats in (("ttft", self.ttft_stats),
                            ("token_latency", self.token_latency_stats)):
            for k, v in stats.summary().items():
                out[f"{name}_{k}"] = v
        return out
