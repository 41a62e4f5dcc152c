"""Request scheduler — the host loop over an :class:`Engine`.

Port of the FIFO core of ``apex_tpu/serving/scheduler.py``: a bounded
FIFO queue, batched admission of queued requests into free slots
(``Engine.admit_many``, at most ``max_admit_batch`` a call), a pipelined
decode loop (``pipeline_depth``), deadline expiry, the per-request
response stream (:class:`StreamEvent`), completions and the serving
summary; with a paged engine the page backpressure (a request that can
never fit the pool is rejected at submit, and while the pool is dry the
queue head waits); with a speculative engine the payoff gate
(:class:`SpecGateConfig`) that picks a plain or a speculative chunk per
tick, and emission of only the real (``valid``) columns; with a prefix
pool the submit-time prefix match (a hit admits through the pool,
copy-on-write when paged); with chunked prefill one long prompt admitted
a chunk a tick between the decode dispatches.

The serving front end's three request features: ``stop`` sequences,
matched on the host token by token (:class:`StopMatcher`: trimmed
emission, held-back prefixes, a trimmed stop closing with a token-less
finished event and retiring the slot); a schema ``constraint``, whose
automaton advances for each emitted token and uploads the slot's next
vocab mask row (``Engine.set_slot_mask``; constrained requests need
``decode_chunk == 1``, and while one is active the pipeline is serial and
every chunk plain); and ``tenant``: the pop order is weighted-fair
queueing over the backlogged tenants (:mod:`.tenancy`; one backlogged
tenant pops strict FIFO), a token-budget rate limit raises
:class:`TenantThrottled` at submit, and :class:`QueueFull` carries the
queue depth and a retry-after hint from the measured chunk latency. A
request's ``adapter`` (a row of the engine's multi-LoRA pool,
:meth:`Scheduler.register_adapter`) is validated at submit and rides its
admission; adapter requests never match the prefix pool, whose K/V is
the base model's.

With a host-swap engine (``EngineConfig.host_swap``) a conversation can
leave its slot mid-stream and come back: :meth:`Scheduler.pause` parks
it (``Engine.park_slot``: its private pages and state row move to host
RAM, the slot and pages free) and :meth:`Scheduler.resume` brings it
back, before any new admission, by the engine's ``resume_policy``:
``swap`` scatters the payload into fresh pages and the same stream
object continues; ``recompute`` drops the payload and re-admits the
request at the queue's front, re-deriving the tokens already streamed
without streaming or charging them again (the emitted-prefix snapshot
taken at the park); ``auto`` takes the cheaper of the measured swap-in
cost and the snapshot's length times the chunk latency. With
``preempt`` (default on with a host tier), a queue head starved of
pages frees the pages of the tenant furthest ahead of its fair share;
the victim re-queues at the back and replays the same way. A cold
LoRA adapter pages into the pool only when the rows the live slots hold
leave room for it; otherwise the request waits at the queue head.

The decode loop is pipelined: each tick dispatches the next chunk
(``Engine.step_async``) before fetching the oldest in-flight one, so at
depth d up to d - 1 chunks stay in flight between ticks and the host's
fetch, unpacking and admissions overlap the device's decode. Each
in-flight chunk carries a snapshot of the slots live at its dispatch; a
slot released while the chunk was in flight has its columns dropped (the
device emits pad for done slots, and a retired slot's tokens belong to a
request already completed). Streams are the same at every depth.

Resilience (fault recovery, the journal), the tuner, SLOs, the flight
recorder and telemetry are later slices of the port: a park or resume
that fails raises to the caller.

>>> sched = Scheduler(engine, pipeline_depth=2)
>>> sched.submit(Request("r0", prompt, max_tokens=16))
>>> sched.run_until_idle()
>>> sched.completions["r0"].tokens
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.serving.engine import (
    Admission,
    ChunkedAdmission,
    Engine,
    StepHandle,
)
from apex_tpu_torch.serving.pages import PagesExhausted
from apex_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_STOP,
    FINISH_TIMEOUT,
    Completion,
    Request,
    StopMatcher,
    StreamEvent,
)
from apex_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    TenancyConfig,
    TenantBook,
    TenantThrottled,
)


class QueueFull(RuntimeError):
    """Raised by :meth:`Scheduler.submit` when the queue is at capacity.
    ``queue_depth`` is the depth at rejection and ``retry_after_s`` the
    time the queue should take to drain (depth x the measured chunk
    latency; 0.0 before any chunk was measured)."""

    def __init__(self, message: str, *, queue_depth: int = 0,
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class SpecGateConfig:
    """Knobs of the speculative-decoding payoff gate (an engine with
    ``EngineConfig.spec_k > 0``). A speculative chunk only pays when its
    drafts land, so the gate measures both chunk kinds' wall times and
    an EWMA of the tokens each wave emits, and dispatches speculative
    chunks only while ``EWMA(tokens per wave) > wall_spec / wall_plain``
    (the break-even: a wave costs ``wall_spec / decode_chunk`` and
    emits ``tokens per wave``; a plain step costs ``wall_plain /
    decode_chunk`` per token)."""

    #: weight of the newest acceptance sample in the EWMA
    ewma_alpha: float = 0.3
    #: a CLOSED gate reopens only when the EWMA clears break-even by
    #: this factor (an open gate closes at 1.0x)
    margin: float = 1.05
    #: a closed gate sends one speculative chunk per this many plain
    #: chunks, and an open gate one plain chunk per this many
    #: speculative ones, so both wall times stay current
    probe_every: int = 40
    #: speculative chunks to measure before the gate decides at all
    min_probe_chunks: int = 2


#: ``spec_gate_state`` values
GATE_CLOSED, GATE_MEASURING, GATE_OPEN = 0.0, 1.0, 2.0


def _ewma(prev: float, sample: float, alpha: float) -> float:
    """The zero-bootstrap EWMA (the first sample seeds it)."""
    return sample if prev == 0.0 else (1 - alpha) * prev + alpha * sample


class _SpecGate:
    """The payoff gate's state machine behind :class:`SpecGateConfig`:
    wall-time EWMAs of both chunk kinds, the tokens-per-wave EWMA and the
    open / closed / probe decision. Host arithmetic only; it picks the
    kind of the next chunk."""

    __slots__ = ("cfg", "spec_k", "accept_ewma", "wall_spec",
                 "wall_plain", "spec_chunks", "plain_since_probe",
                 "spec_since_plain", "_open")

    def __init__(self, cfg: SpecGateConfig, spec_k: int):
        self.cfg = cfg
        self.spec_k = spec_k
        self.accept_ewma = 0.0      # tokens per wave (1 .. spec_k + 1)
        self.wall_spec = 0.0
        self.wall_plain = 0.0
        self.spec_chunks = 0
        self.plain_since_probe = 0
        self.spec_since_plain = 0
        self._open = True           # optimistic until measured

    def break_even(self) -> float:
        """Tokens per wave a speculative chunk must emit to match the
        plain chunk's cost, ``wall_spec / wall_plain`` (0.0 until both
        are measured)."""
        if self.wall_spec <= 0.0 or self.wall_plain <= 0.0:
            return 0.0
        return self.wall_spec / self.wall_plain

    def want_spec(self, spec_inflight: int = 0) -> bool:
        """Whether the NEXT chunk should be speculative. Until the gate
        has measured its way open, at most one speculative chunk is in
        flight (``spec_inflight`` counts those dispatched but not
        fetched)."""
        if self.wall_plain == 0.0:
            return False            # measure the plain baseline first
        measuring = self.spec_chunks < self.cfg.min_probe_chunks
        if (measuring or not self._open) and spec_inflight > 0:
            return False            # one probe at a time
        if measuring:
            return True             # measuring the speculative side
        if self._open:
            # once per probe_every speculative chunks, re-measure plain
            return self.spec_since_plain < self.cfg.probe_every
        return self.plain_since_probe >= self.cfg.probe_every

    def observe_plain(self, wall: float) -> None:
        self.wall_plain = _ewma(self.wall_plain, wall, self.cfg.ewma_alpha)
        self.plain_since_probe += 1
        self.spec_since_plain = 0

    def observe_spec(self, wall: float,
                     tokens_per_wave: Optional[float]) -> None:
        self.wall_spec = _ewma(self.wall_spec, wall, self.cfg.ewma_alpha)
        self.spec_chunks += 1
        self.plain_since_probe = 0
        self.spec_since_plain += 1
        if tokens_per_wave is not None:
            self.accept_ewma = _ewma(self.accept_ewma, tokens_per_wave,
                                     self.cfg.ewma_alpha)
        if self.accept_ewma == 0.0:
            # no acceptance sample yet (a live wave always emits >= 1
            # token, so 0.0 means never measured): keep measuring
            return
        be = self.break_even()
        if be <= 0.0 or self.spec_chunks < self.cfg.min_probe_chunks:
            return
        if self._open:
            self._open = self.accept_ewma > be
        else:
            # hysteresis: reopening needs the margin
            self._open = self.accept_ewma > be * self.cfg.margin

    def state(self) -> float:
        """2 open, 1 measuring, 0 closed."""
        if (self.wall_plain == 0.0
                or self.spec_chunks < self.cfg.min_probe_chunks
                or self.accept_ewma == 0.0):
            return GATE_MEASURING
        return GATE_OPEN if self._open else GATE_CLOSED


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
    """Host view of one occupied slot. ``tokens`` / ``logprobs`` hold the
    client-visible stream: tokens the stop matcher holds back (a possible
    stop prefix) live in ``matcher`` until flushed or trimmed.
    ``suppress`` is the replay offset: the first ``suppress`` tokens were
    streamed before a recompute resume or a preemption, and are
    re-derived without a second event."""

    __slots__ = ("request", "tokens", "logprobs", "first_token_time",
                 "suppress", "matcher")

    def __init__(self, request: Request):
        self.request = request
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.first_token_time: Optional[float] = None
        self.suppress = 0
        self.matcher = (StopMatcher(request.stop) if request.stop
                        else None)


class _ReplayState:
    """The emitted-prefix snapshot of one request that left its slot
    mid-stream (parked or preempted): the tokens and logprobs the client
    was streamed, which a replay re-derives. JAX's also carries the
    fault machinery's retry attempts and backoff, which wait for the
    resilience slice."""

    __slots__ = ("tokens", "logprobs")

    def __init__(self):
        self.tokens: List[int] = []
        self.logprobs: List[float] = []


class _Parked:
    """One paused conversation in the host tier: the live
    :class:`_Active` a swap resume continues (stream, stop matcher, held
    tokens intact) and the park's time. ``swap`` turns False when the
    tier evicts the payload; the conversation then resumes by recompute
    from the snapshot taken at the park."""

    __slots__ = ("act", "swap", "parked_at")

    def __init__(self, act: _Active, swap: bool, parked_at: float):
        self.act = act
        self.swap = swap
        self.parked_at = parked_at


class Scheduler:
    """Drive an :class:`Engine` over a stream of requests.

    ``clock`` is injectable (tests drive deadlines with a fake clock) and
    must be monotonic. Each tick: expire deadlines; hand the queued
    requests that fit the free slots (and, paged, the free pages:
    FIFO-strict, the first that does not fit waits with everything
    behind it) to ``Engine.admit_many``, at most ``max_admit_batch`` a
    call (None = all that fit; 1 = serial single admissions), a prompt
    longer than ``prefill_chunk`` to the chunked path instead; run one
    chunk of the chunked admission in progress; dispatch a decode chunk
    if any slot is live; then fetch the oldest in-flight chunks until at
    most ``pipeline_depth - 1`` remain (all of them when nothing was
    dispatched). ``spec_gate`` tunes the payoff gate of a speculative
    engine (``EngineConfig.spec_k > 0``); ``tenancy`` sets the tenants'
    weights and rate limits (the book exists without it: every tenant
    weighs 1, none is limited). ``preempt`` (None = on exactly when the
    engine has a host tier; True needs one) lets a queue head starved of
    pages preempt the tenant furthest ahead of its fair share."""

    def __init__(self, engine: Engine, *, max_queue: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 pipeline_depth: int = 1,
                 max_admit_batch: Optional[int] = None,
                 spec_gate: Optional[SpecGateConfig] = None,
                 tenancy: Optional[TenancyConfig] = None,
                 preempt: Optional[bool] = None):
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth {pipeline_depth} must be >= 1 (1 = the "
                f"serial loop)")
        if max_admit_batch is not None and max_admit_batch < 1:
            raise ValueError(
                f"max_admit_batch {max_admit_batch} must be >= 1 or None")
        self.engine = engine
        self.max_queue = max_queue
        self.clock = clock
        self.pipeline_depth = pipeline_depth
        self.max_admit_batch = max_admit_batch
        self.queue: Deque[Request] = collections.deque()
        self.active: Dict[int, _Active] = {}
        self._free: List[int] = list(range(engine.slots))[::-1]
        self.events: List[StreamEvent] = []
        self.completions: Dict[str, Completion] = {}
        self.ttft_stats = LatencyStats()
        self.token_latency_stats = LatencyStats()
        #: chunks dispatched but not yet fetched, oldest first: (handle,
        #: slot -> _Active snapshot at dispatch, dispatch time)
        self._inflight: Deque[
            Tuple[StepHandle, Dict[int, _Active], float]] = \
            collections.deque()
        self._started: Optional[float] = None
        self._steps = 0
        self._tokens_emitted = 0
        self._decode_tokens = 0
        self._decode_time = 0.0
        #: the end of the last fetched chunk's wall window: pipelined
        #: chunks overlap, and decode time counts each second once
        self._decode_mark = float("-inf")
        self._admitted_requests = 0
        self._admit_dispatches = 0
        self._pages_exhausted_waits = 0
        self._page_deferrals = 0
        #: prefix-pool hits by request id, matched once at submit
        self._prefix_hits: Dict[str, Tuple[int, int]] = {}
        self._prefix_hit_count = 0
        self._prefix_miss_count = 0
        self._page_share_hits = 0
        #: the chunked admission in progress, (progress, request); each
        #: tick runs one of its forwards before the decode dispatch.
        #: ``_chunked_fresh`` marks the tick that ran chunk 0
        self._chunked: Optional[Tuple[ChunkedAdmission, Request]] = None
        self._chunked_fresh = False
        self._chunked_admissions = 0
        self._chunked_chunks = 0
        #: the payoff gate (None unless the engine speculates)
        self._gate: Optional[_SpecGate] = None
        if engine.engine_cfg.spec_k > 0:
            self._gate = _SpecGate(spec_gate or SpecGateConfig(),
                                   engine.engine_cfg.spec_k)
        elif spec_gate is not None:
            raise ValueError("spec_gate given but the engine does not "
                             "speculate (EngineConfig.spec_k == 0)")
        self._gate_spec_decisions = 0
        self._gate_plain_decisions = 0
        self._spec_chunks = 0
        self._spec_waves = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        #: weighted-fair queueing, rate limits and per-tenant accounting
        self.tenants = TenantBook(tenancy, clock)
        self._throttled = 0
        #: EWMA of the decode chunks' wall shares: QueueFull's retry hint
        self._chunk_ewma = 0.0
        #: requests finished by a stop sequence / a completed constraint
        self._stop_finishes = 0
        #: host-swap oversubscription: the emitted-prefix snapshots of
        #: requests that left their slot mid-stream, the paused
        #: conversations by request id, and the FIFO of ids to resume
        #: (drained before admissions each tick)
        if preempt and not engine.host_swap_enabled:
            raise ValueError(
                "preempt=True needs EngineConfig.host_swap — without "
                "the emitted-prefix replay contract the host tier "
                "anchors, an evicted stream could not continue")
        self.preempt = (engine.host_swap_enabled if preempt is None
                        else bool(preempt))
        self._replay: Dict[str, _ReplayState] = {}
        self._parked: Dict[str, _Parked] = {}
        self._resume_q: Deque[str] = collections.deque()
        self._pauses = 0
        self._preemptions = 0
        self._swap_resumes = 0
        self._recompute_resumes = 0
        self._swap_capacity_drops = 0
        #: ticks a request waited because its adapter could not page in
        #: beside the rows the live slots hold
        self._adapter_waits = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue ``request``; raises :class:`QueueFull` at capacity,
        :class:`TenantThrottled` when the tenant's token budget cannot
        cover ``max_tokens``, and ``ValueError`` on an invalid request. A
        prompt that already ends in the request's eos token completes
        here with no tokens. A prompt that starts with a registered
        prefix is matched here and admits through the pool."""
        rid = request.request_id
        if rid in self.completions or any(
                a.request.request_id == rid for a in self.active.values()) \
                or any(r.request_id == rid for r in self.queue) \
                or (self._chunked is not None
                    and self._chunked[1].request_id == rid) \
                or rid in self._parked:
            raise ValueError(f"duplicate request_id {rid!r}")
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
        if request.stop:
            for s in request.stop:
                if not len(s):
                    raise ValueError(
                        "stop sequences must be non-empty token lists")
        if request.constraint is not None and ecfg.decode_chunk != 1:
            raise ValueError(
                f"schema-constrained requests need decode_chunk == 1 "
                f"(the vocab mask advances host-side between "
                f"dispatches; a {ecfg.decode_chunk}-token chunk would "
                f"apply a stale mask), got decode_chunk="
                f"{ecfg.decode_chunk}")
        if not request.tenant:
            request.tenant = DEFAULT_TENANT
        if request.adapter:
            # validated here, not at admission: a bad id must not surface
            # mid-serve
            if not self.engine.adapter_pool_enabled:
                raise ValueError(
                    f"request carries adapter {request.adapter} but "
                    f"the engine's adapter pool is disabled "
                    f"(EngineConfig.adapter_slots == 0)")
            n_reg = self.engine.adapters_registered
            if not 1 <= request.adapter <= n_reg:
                raise ValueError(
                    f"adapter {request.adapter} outside the "
                    f"registered ids [1, {n_reg}] (0 is the pinned "
                    f"base adapter; Engine.register_adapter issues "
                    f"the rest)")
        now = self.clock()
        request.arrival_time = now
        book = self.tenants
        # bounded tenant cardinality: past max_tenants distinct ids a new
        # one folds into the overflow tenant (the request is rewritten,
        # so every consumer sees one identity)
        tenant = request.tenant = book.admit_tenant(request.tenant)
        if eos is not None and prompt[-1] == eos:
            book.stats(tenant).submitted += 1
            self._complete(request, [], [], FINISH_EOS, ttft=None, now=now)
            self.events.append(StreamEvent(rid, None, True, FINISH_EOS))
            return
        if len(self.queue) >= self.max_queue:
            depth = len(self.queue)
            hint = self.overload_hint_s()
            book.stats(tenant).shed += 1
            raise QueueFull(
                f"queue at capacity ({depth}); retry in ~{hint:.3f}s",
                queue_depth=depth, retry_after_s=hint)
        # the token budget is charged after the capacity gate, so a
        # QueueFull rejection never debits the bucket
        wait = book.throttle(tenant, request.max_tokens, now)
        if wait is not None:
            self._throttled += 1
            book.stats(tenant).throttled += 1
            book.stats(tenant).shed += 1
            raise TenantThrottled(
                f"tenant {tenant!r} over its token budget; retry in "
                f"~{wait:.3f}s", tenant=tenant, retry_after_s=wait)
        # adapter requests never match the prefix pool: its prefixes hold
        # base-weight K/V, which a cold adapter prefill would not produce
        matchable = self.engine.prefix_pool_enabled and not request.adapter
        hit = self.engine.match_prefix(prompt) if matchable else None
        if self.engine.paged:
            # a request that could NEVER fit the pool would wait at the
            # queue head forever: reject it here. The need is the
            # PRIVATE one: a hit's shared prefix pages are pinned, not
            # allocated
            needed = self.engine.pages_needed(
                len(prompt), request.max_tokens, 0 if hit is None else hit[1])
            if needed > self.engine.page_allocator.capacity:
                raise ValueError(
                    f"request needs {needed} pages but the pool only has "
                    f"{self.engine.page_allocator.capacity}: raise "
                    f"EngineConfig.num_pages or shrink the request")
        if hit is not None:
            self._prefix_hits[rid] = hit
            self._prefix_hit_count += 1
        elif matchable:
            self._prefix_miss_count += 1
        # a tenant (re-)entering the backlog competes from now: its
        # deficit counter clamps up to the least among the tenants with
        # queued or active work (idle time is no banked credit)
        backlogged = {a.request.tenant for a in self.active.values()}
        backlogged.update(r.tenant for r in self.queue)
        if tenant not in backlogged:
            book.rejoin(tenant, min(
                (book.service_of(t) for t in backlogged),
                default=book.service_of(tenant)))
        self.queue.append(request)
        book.stats(tenant).submitted += 1
        book.note_backlogged(tenant)

    def overload_hint_s(self) -> float:
        """The queue-drain estimate behind :class:`QueueFull`'s
        ``retry_after_s`` (depth x the measured chunk latency), for an
        ingress that checks an all-or-nothing batch before submitting
        it."""
        return len(self.queue) * self._chunk_ewma

    def can_accept(self, n: int = 1) -> bool:
        """Whether ``n`` more submissions fit the queue now (capacity
        only): the HTTP front end's pre-flight before it fans out an
        ``n > 1`` request, which must not half-land."""
        return len(self.queue) + n <= self.max_queue

    @property
    def chunk_latency_ewma_s(self) -> float:
        """The EWMA of the decode chunks' wall shares (seconds; 0.0
        before the first chunk was fetched)."""
        return self._chunk_ewma

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting: weight, submitted / admitted / shed /
        throttled / tokens and the live deficit counter
        (:meth:`TenantBook.summary`)."""
        return self.tenants.summary()

    def register_prefix(self, tokens) -> int:
        """Register a shared prompt-prefix template into the engine's
        pool (:meth:`Engine.register_prefix`); requests submitted after
        it match it."""
        return self.engine.register_prefix(tokens)

    def register_adapter(self, weights=None, *, name: Optional[str] = None,
                         seed: Optional[int] = None) -> int:
        """Register a LoRA adapter into the engine's pool
        (:meth:`Engine.register_adapter`) and return its id. JAX's
        scheduler also records the registration in its flight recorder and
        journal, which the port has not yet (ROADMAP queue 1 item 3)."""
        return self.engine.register_adapter(weights, name=name, seed=seed)

    # -- host-swap oversubscription (EngineConfig.host_swap) ----------------

    def pause(self, request_id: str) -> bool:
        """Park an ACTIVE request's conversation in the host tier
        (``Engine.park_slot``): its private pages swap out, the slot
        frees, and after :meth:`resume` the stream continues bit for bit
        (held stop-matcher tokens, sampling key and all). Every chunk in
        flight is collected first, since a dispatched block table still
        maps the pages being freed. False when the request is not active
        by then (finished, still queued, or already parked)."""
        if not self.engine.host_swap_enabled:
            raise ValueError(
                "pause() needs EngineConfig.host_swap — the engine "
                "has no host tier to park into")
        while self._inflight:
            self._collect_oldest()
        for slot, act in sorted(self.active.items()):
            if act.request.request_id == request_id:
                self._park(slot, act, self.clock())
                return True
        return False

    def resume(self, request_id: str) -> bool:
        """Queue a parked conversation for resumption (drained before the
        admissions of every tick, and tried here at once). The engine's
        ``resume_policy`` picks the path: ``swap`` scatters the payload
        back, ``recompute`` drops it and re-derives the streamed prefix
        through a re-admission at the queue's front, ``auto`` compares the
        measured swap-in cost with the snapshot's length times the chunk
        latency EWMA. False for an id that is not parked."""
        if request_id not in self._parked:
            return False
        if request_id not in self._resume_q:
            self._resume_q.append(request_id)
        self._admit_parked(self.clock())
        return True

    @property
    def parked_requests(self) -> List[str]:
        """Ids of the paused conversations, oldest park first."""
        return sorted(self._parked,
                      key=lambda rid: self._parked[rid].parked_at)

    def _snapshot(self, act: _Active) -> None:
        """Grow ``act``'s emitted-prefix snapshot to its stream (the
        recompute resume's contract: what the client was streamed)."""
        st = self._replay.setdefault(act.request.request_id, _ReplayState())
        if len(act.tokens) > len(st.tokens):
            st.tokens = list(act.tokens)
            st.logprobs = list(act.logprobs)

    def _park(self, slot: int, act: _Active, now: float) -> None:
        """Move one active slot into the host tier: the snapshot first
        (the recompute fallback), then the swap-out and the slot's
        release. A failed park raises."""
        rid = act.request.request_id
        self._snapshot(act)
        evicted = self.engine.park_slot(slot, rid)
        self.active.pop(slot)
        self._free.append(slot)
        self._pauses += 1
        self._parked[rid] = _Parked(act, self.engine.host_parked(rid), now)
        for ek in evicted:
            # a capacity eviction drops the payload, never the
            # conversation: it resumes by recompute
            pk = self._parked.get(ek)
            if pk is not None and pk.swap:
                pk.swap = False
                self._swap_capacity_drops += 1

    def _admit_parked(self, now: float) -> None:
        """Drain the resume queue into free slots. A swap resume that
        finds no slot, pages or adapter row waits at the head (page
        pressure may preempt on its behalf); a recompute resume re-enters
        the request queue's FRONT and replays from its snapshot."""
        while self._resume_q:
            rid = self._resume_q[0]
            pk = self._parked.get(rid)
            if pk is None:          # expired while queued
                self._resume_q.popleft()
                continue
            act = pk.act
            n_pages = self.engine.parked_pages(rid)
            policy = self.engine.engine_cfg.resume_policy
            use_swap = (pk.swap and self.engine.host_parked(rid)
                        and policy != "recompute")
            if use_swap and policy == "auto":
                cost = self.engine.swap_in_cost_s(n_pages)
                if (cost is not None and self._chunk_ewma > 0.0
                        and cost > len(act.tokens) * self._chunk_ewma):
                    use_swap = False
            if not use_swap:
                self._resume_q.popleft()
                self._parked.pop(rid)
                self.engine.drop_parked(rid)
                self._recompute_resumes += 1
                self.queue.appendleft(act.request)
                continue
            if not self._free:
                return
            if not self.engine.page_allocator.can_alloc(n_pages):
                self._note_pages_exhausted(act.request, n_pages)
                return
            if not self.engine.adapters_fit([act.request.adapter]):
                self._adapter_waits += 1
                return
            slot = self._free.pop()
            try:
                self.engine.resume_slot(slot, rid)
            except Exception:
                self._free.append(slot)
                raise
            self._resume_q.popleft()
            self._parked.pop(rid)
            self.active[slot] = act
            self._swap_resumes += 1

    def _note_pages_exhausted(self, r: Request, needed: int) -> None:
        """Backpressure, not a fault: the head request waits until
        releases free its pages. With :attr:`preempt` the wait also runs
        the preemption pass."""
        self._pages_exhausted_waits += 1
        self._maybe_preempt(r, needed)

    def _maybe_preempt(self, r: Request, needed: int) -> None:
        """Page pressure under oversubscription: free the pages of the
        tenant furthest AHEAD of its fair share
        (``TenantBook.pick_victim``) so the starved request ``r`` admits
        next tick. Every chunk in flight is collected first; only tenants
        strictly ahead of ``r``'s are candidates (preemption flows one way
        down the fair-share order, so a victim never preempts its
        preemptor back), and of the victim tenant's slots the one with
        the least sunk work goes. The victim re-queues at the BACK and
        replays from its snapshot, bit for bit."""
        if not self.preempt or not self.active:
            return
        while self._inflight:
            self._collect_oldest()
        # collection may have released slots and pages
        if (not self.active
                or self.engine.page_allocator.can_alloc(needed)):
            return
        book = self.tenants
        floor = book.service_of(r.tenant)
        candidates = {
            a.request.tenant: book.service_of(a.request.tenant)
            for a in self.active.values()
            if book.service_of(a.request.tenant) > floor}
        if not candidates:
            return
        victim_tenant = book.pick_victim(candidates)
        victims = sorted(
            (len(a.tokens), slot) for slot, a in self.active.items()
            if a.request.tenant == victim_tenant
            and a.request.request_id != r.request_id)
        if not victims:
            return
        _, slot = victims[0]
        act = self.active[slot]
        self._snapshot(act)
        self.engine.retire(slot)
        self.engine.free_slot(slot)
        self.active.pop(slot)
        self._free.append(slot)
        self._preemptions += 1
        self.queue.append(act.request)

    # -- the loop ----------------------------------------------------------

    def step(self) -> None:
        """One tick: expire deadlines, admit queued requests into free
        slots, run one chunk of the chunked admission in progress,
        dispatch a decode chunk if any slot is live, then fetch and
        unpack chunks down to ``pipeline_depth - 1`` in flight (all of
        them when nothing was dispatched, so a tick always makes
        progress). Admissions come first so a short prompt never queues
        behind this tick's chunk forward."""
        now = self.clock()
        if self._started is None:
            self._started = now
        self._expire(now)
        # resumes first (their clients wait mid-stream), then the batched
        # admissions, the chunked start last: the wave of short prompts
        # must not queue behind chunk 0's forward
        if self._resume_q:
            self._admit_parked(now)
        self._admit_batches(now)
        self._start_chunked()
        self._advance_chunked()
        dispatched = bool(self.active) and self._dispatch_chunk()
        keep = self.pipeline_depth - 1 if dispatched else 0
        while len(self._inflight) > keep:
            self._collect_oldest()
        self._steps += 1

    def drain(self) -> None:
        """Fetch and unpack every in-flight chunk: afterwards ``events``
        and ``completions`` reflect all dispatched work."""
        while self._inflight:
            self._collect_oldest()

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until the queue, the slots, the pipeline, any chunked
        admission and the resume queue are empty."""
        steps = 0
        while not self.idle():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"not idle after {max_steps} steps — live slots "
                    f"{sorted(self.active)}, queue {len(self.queue)}, "
                    f"{len(self._inflight)} chunks in flight")

    def pop_events(self) -> List[StreamEvent]:
        """Drain the response stream."""
        out, self.events = self.events, []
        return out

    def idle(self) -> bool:
        """Nothing to do: queue, slots, pipeline, chunked admission and
        resume queue empty. Parked conversations do not count: they wait
        for an explicit :meth:`resume`."""
        return not (self.queue or self.active or self._inflight
                    or self._chunked is not None or self._resume_q)

    # -- internals ---------------------------------------------------------

    def _expire(self, now: float) -> None:
        kept: Deque[Request] = collections.deque()
        for r in self.queue:
            if r.deadline is not None and now >= r.deadline:
                self._abort(r, FINISH_TIMEOUT, now)
            else:
                kept.append(r)
        self.queue = kept
        for slot in list(self.active):
            act = self.active[slot]
            dl = act.request.deadline
            if dl is not None and now >= dl:
                # a timeout streams the matcher's held tail (nothing
                # matched, so nothing is trimmed)
                self._flush_held(act)
                self.engine.retire(slot)
                self.events.append(StreamEvent(
                    act.request.request_id, None, True, FINISH_TIMEOUT))
                self._release(slot, FINISH_TIMEOUT, now)
        for rid in list(self._parked):
            pk = self._parked[rid]
            dl = pk.act.request.deadline
            if dl is not None and now >= dl:
                # a parked conversation's deadline still bites: drop the
                # payload and time out with the stream so far
                del self._parked[rid]
                if rid in self._resume_q:
                    self._resume_q.remove(rid)
                self.engine.drop_parked(rid)
                self._abort(pk.act.request, FINISH_TIMEOUT, now, act=pk.act)

    def _abort(self, request: Request, reason: str, now: float, *,
               act: Optional[_Active] = None) -> None:
        """A finish outside a slot (a queued or parked request timing
        out): one finished event, and a completion carrying the longest
        stream the client saw, the parked stream's or the snapshot of one
        that left its slot."""
        if act is not None:
            self._flush_held(act)
        streamed = (act.tokens, act.logprobs) if act is not None else ([], [])
        tokens, lps = self._longest(request, *streamed)
        ttft = None
        if act is not None and act.first_token_time is not None:
            ttft = act.first_token_time - request.arrival_time
        self.events.append(StreamEvent(request.request_id, None, True,
                                       reason))
        self._complete(request, tokens, lps, reason, ttft=ttft, now=now)

    def _admission_of(self, r: Request, slot: int) -> Admission:
        """One :class:`Admission` row from a request (shared by the
        batched, prefix-hit and chunked paths)."""
        hit = self._prefix_hits.get(r.request_id)
        return Admission(
            slot=slot, prompt=r.prompt, max_tokens=r.max_tokens,
            temperature=r.sampling.temperature, top_k=r.sampling.top_k,
            top_p=r.sampling.top_p, seed=r.sampling.seed,
            eos_token_id=r.eos_token_id,
            allowed_tokens=(tuple(r.constraint.allowed_tokens())
                            if r.constraint is not None else None),
            prefix_page=None if hit is None else hit[0],
            prefix_len=0 if hit is None else hit[1], adapter=r.adapter)

    def _request_pages_needed(self, r: Request) -> int:
        """One queued request's PRIVATE page need (copy-on-write prefix
        pages pin, they do not allocate), as submit priced it."""
        hit = self._prefix_hits.get(r.request_id)
        return self.engine.pages_needed(
            len(r.prompt), r.max_tokens, 0 if hit is None else hit[1])

    def _chunked_only(self, r: Request) -> bool:
        """A prompt the chunked path admits (longer than one chunk, no
        prefix hit: a hit already skips the long forward)."""
        return (self.engine.chunked_for(len(r.prompt))
                and r.request_id not in self._prefix_hits)

    def _chunked_head_pending(self) -> bool:
        """A chunked-path request heads the queue with none in progress:
        the batched path keeps one slot free for it (short prompts admit
        first within a tick, but must not starve the long one)."""
        return (self._chunked is None and bool(self.queue)
                and self._chunked_only(self.queue[0]))

    def _pop_eligible(self, n: int, now: float) -> List[Request]:
        """Pop up to ``n`` queued requests the batched path admits,
        leaving the chunked-path ones in place. The order is
        weighted-fair queueing over tenants: each pick takes the oldest
        request of the backlogged tenant most behind its share (the
        least deficit counter, aged by its head's wait). Within a tenant
        the order is FIFO, and with one backlogged tenant every pick is
        the first eligible request: the strict FIFO pop. ``now`` is the
        tick's clock reading (the heads' waits)."""
        by_tenant: Dict[str, List[Tuple[int, Request]]] = {}
        for idx, r in enumerate(self.queue):
            if not self._chunked_only(r):
                by_tenant.setdefault(r.tenant, []).append((idx, r))
        heads = {t: 0 for t in by_tenant}
        picked: List[Request] = []
        picked_idx: List[int] = []
        while len(picked) < n:
            live = {t: lst[heads[t]] for t, lst in by_tenant.items()
                    if heads[t] < len(lst)}
            if not live:
                break
            if len(live) == 1:
                t = next(iter(live))
            else:
                # deficits do not move between picks (tokens charge at
                # emission), so one scan serves the wave
                t = self.tenants.pick({
                    tt: max(now - (rr.arrival_time
                                   if rr.arrival_time is not None
                                   else now), 0.0)
                    for tt, (_, rr) in live.items()})
            idx, r = live[t]
            heads[t] += 1
            picked_idx.append(idx)
            picked.append(r)
        if picked_idx:
            drop = set(picked_idx)
            self.queue = collections.deque(
                r for i, r in enumerate(self.queue) if i not in drop)
        return picked

    def _admit_batches(self, now: float) -> None:
        while self.queue:
            reserve = 1 if self._chunked_head_pending() else 0
            if len(self._free) <= reserve:
                return
            n = min(len(self._free) - reserve, len(self.queue))
            if self.max_admit_batch is not None:
                n = min(n, self.max_admit_batch)
            reqs = self._pop_eligible(n, now)
            if not reqs:
                return              # only chunked-path requests queued
            if self.engine.paged:
                # page backpressure, FIFO-strict: admit the prefix of the
                # wave the free pages cover; the first request that does
                # not fit waits at the head with everything behind it
                free_p = self.engine.page_allocator.free_pages
                needed, cut, cut_need = 0, len(reqs), 0
                for idx, r in enumerate(reqs):
                    need = self._request_pages_needed(r)
                    if needed + need > free_p:
                        cut, cut_need = idx, need
                        break
                    needed += need
                if cut < len(reqs):
                    self.queue.extendleft(reversed(reqs[cut:]))
                    self._page_deferrals += 1
                    if cut == 0:
                        self._note_pages_exhausted(reqs[0], cut_need)
                        return
                    reqs = reqs[:cut]
            # adapter paging: admit the prefix of the wave whose adapters
            # can be resident at once beside the live slots' rows
            cut = next((i for i in range(len(reqs))
                        if not self.engine.adapters_fit(
                            [r.adapter for r in reqs[:i + 1]])), len(reqs))
            if cut < len(reqs):
                self.queue.extendleft(reversed(reqs[cut:]))
                reqs = reqs[:cut]
                if not reqs:
                    self._adapter_waits += 1
                    return
            slots = [self._free.pop() for _ in range(len(reqs))]
            for r in reqs:
                # every admission restarts the schema automaton
                if r.constraint is not None:
                    r.constraint.reset()
            try:
                results = self.engine.admit_many([
                    self._admission_of(r, slot)
                    for r, slot in zip(reqs, slots)])
            except PagesExhausted:
                # the pool could not cover the wave after all: requeue
                self._free.extend(reversed(slots))
                self.queue.extendleft(reversed(reqs))
                self._note_pages_exhausted(
                    reqs[0], self._request_pages_needed(reqs[0]))
                return
            t_first = self.clock()
            self._admitted_requests += len(reqs)
            self._admit_dispatches += results[-1].group + 1
            for r, slot, res in zip(reqs, slots, results):
                if r.request_id in self._prefix_hits and self.engine.paged:
                    # the hit mapped the prefix's pages copy-on-write
                    self._page_share_hits += 1
                self._activate(slot, r, res, t_first)

    def _activate(self, slot: int, r: Request, res, t_first: float) -> None:
        """The request occupies ``slot`` from its first token on (TTFT is
        the first token computed, even when the stop matcher holds it
        back)."""
        act = _Active(r)
        st = self._replay.get(r.request_id)
        act.suppress = 0 if st is None else len(st.tokens)
        act.first_token_time = t_first
        self.active[slot] = act
        self.tenants.stats(r.tenant).admitted += 1
        if act.suppress < 1:
            # a replay's re-derived first token is not a first token
            self.ttft_stats.add(t_first - r.arrival_time)
        reason = None
        if res.finished:
            reason = FINISH_EOS if res.hit_eos else FINISH_LENGTH
        self._ingest(slot, act, res.first_token, res.logprob, t_first,
                     device_done=res.finished, device_reason=reason)

    def _start_chunked(self) -> None:
        """Begin a chunked admission for the queue head when it takes
        the chunked path, none is in progress, and a slot and the pages
        are free."""
        if (self._chunked is not None
                or not self.engine.chunked_prefill_enabled
                or not self._free or not self.queue):
            return
        r = self.queue[0]
        if not self._chunked_only(r):
            return
        if not self.engine.can_admit_pages(len(r.prompt), r.max_tokens):
            self._note_pages_exhausted(r, self._request_pages_needed(r))
            return
        if not self.engine.adapters_fit([r.adapter]):
            self._adapter_waits += 1
            return
        self.queue.popleft()
        slot = self._free.pop()
        if r.constraint is not None:
            r.constraint.reset()
        try:
            ca = self.engine.admit_chunked_start(self._admission_of(r, slot))
        except PagesExhausted:
            self._free.append(slot)
            self.queue.appendleft(r)
            self._note_pages_exhausted(r, self._request_pages_needed(r))
            return
        self._chunked = (ca, r)
        self._chunked_fresh = True
        self._chunked_chunks += 1

    def _advance_chunked(self) -> None:
        """One forward of the chunked admission in progress (the next
        extend, or the finish); not in the tick that ran chunk 0. The
        decode dispatch follows in the same tick, so chunks and decode
        chunks alternate."""
        if self._chunked is None:
            return
        if self._chunked_fresh:
            self._chunked_fresh = False
            return
        ca, r = self._chunked
        res = self.engine.admit_chunked_step(ca)
        if res is None:
            self._chunked_chunks += 1
            return
        self._chunked = None
        self._chunked_admissions += 1
        self._admitted_requests += 1
        self._admit_dispatches += 1
        self._activate(ca.slot, r, res, self.clock())

    def _constrained_active(self) -> bool:
        return any(a.request.constraint is not None
                   for a in self.active.values())

    def _plain_only(self) -> bool:
        """Whether the next chunk must be plain: a constrained request is
        active (its vocab mask advances a token at a time, and the verify
        wave draws without masks), or a slot is re-deriving a replayed
        prefix (streams are the same either way; the replay stays on the
        plain path, as in JAX)."""
        return any(a.request.constraint is not None
                   or len(a.tokens) < a.suppress
                   for a in self.active.values())

    def _use_spec(self) -> bool:
        """The kind of the next chunk: the payoff gate's choice (at most
        one speculative probe in flight while it measures); plain while a
        constrained request is active."""
        g = self._gate
        if g is None or self._plain_only():
            return False
        spec = g.want_spec(sum(1 for h, _, _ in self._inflight if h.spec))
        if spec:
            self._gate_spec_decisions += 1
        else:
            self._gate_plain_decisions += 1
        return spec

    def _dispatchable(self) -> bool:
        """Whether another chunk can emit a real token: some live slot
        has budget beyond the columns already in flight for it (each
        in-flight chunk priced at its ``ncols``). Without this a deep
        pipeline dispatches an all-pad chunk at every wave of finishes.
        While a constrained request is active the pipeline is serial: its
        mask row advances only once the previous chunk's token is
        fetched, and a chunk dispatched on top would draw against a stale
        row."""
        if self._inflight and self._constrained_active():
            return False
        if not self._inflight:
            return True
        cols: Dict[int, int] = {}
        for handle, snapshot, _ in self._inflight:
            for slot, act in snapshot.items():
                if self.active.get(slot) is act:
                    cols[slot] = cols.get(slot, 0) + handle.ncols
        return any(len(act.tokens) + cols.get(slot, 0)
                   < act.request.max_tokens
                   for slot, act in self.active.items())

    def _dispatch_chunk(self) -> bool:
        """Dispatch the next decode chunk if it can pay for itself; True
        when one went out. Nothing here waits for the device."""
        if not self._dispatchable():
            return False
        spec = self._use_spec()
        t0 = self.clock()
        handle = self.engine.step_async(spec=spec)
        self._inflight.append((handle, dict(self.active), t0))
        return True

    def _observe(self, handle, wall: float, live_rows: List[int]) -> None:
        """Per-chunk speculation accounting and the gate's samples:
        tokens per wave over the still-live rows (a live wave always
        emits its first column), and each kind's chunk wall time."""
        g = self._gate
        if not handle.spec:
            if g is not None:
                g.observe_plain(wall)
            return
        self._spec_chunks += 1
        tpw = None
        if live_rows:
            v = handle.valid[live_rows]
            live_waves = int(v[:, ::handle.spec_k + 1].sum())
            emitted = int(v.sum())
            if live_waves:
                tpw = emitted / live_waves
                self._spec_waves += live_waves
                self._spec_drafted += handle.spec_k * live_waves
                self._spec_accepted += emitted - live_waves
        if g is not None:
            g.observe_spec(wall, tpw)

    def _collect_oldest(self) -> None:
        """Fetch the oldest in-flight chunk and emit its columns for the
        slots still held by the requests they were dispatched for."""
        handle, snapshot, t_dispatch = self._inflight.popleft()
        tokens, logprobs, finished = handle.fetch()
        now = self.clock()
        # at depth d the dispatch-to-fetch wall waits behind the d - 1
        # chunks ahead: the gate's sample is the chunk's share
        wall = max(now - max(self._decode_mark, t_dispatch), 0.0)
        self._decode_time += wall
        self._decode_mark = now
        self._chunk_ewma = (wall if self._chunk_ewma == 0.0
                            else 0.7 * self._chunk_ewma + 0.3 * wall)
        live_rows = [s for s, a in snapshot.items()
                     if self.active.get(s) is a]
        self._observe(handle, wall, live_rows)
        valid = handle.valid
        n_cols = tokens.shape[1]
        if valid is None:
            per_tok = wall / n_cols
        else:
            # per REAL token: pad lanes are not tokens
            mean_emitted = (valid[live_rows].sum() / len(live_rows)
                            if live_rows else 0.0)
            per_tok = wall / max(float(mean_emitted), 1.0)
        for j in range(n_cols):
            for slot, act in snapshot.items():
                # a slot released since dispatch emits nothing more here
                if self.active.get(slot) is not act:
                    continue
                if valid is not None and not valid[slot, j]:
                    continue
                tok = int(tokens[slot, j])
                done = bool(finished[slot, j])
                reason = None
                if done:
                    eos = act.request.eos_token_id
                    reason = (FINISH_EOS if eos is not None and tok == eos
                              else FINISH_LENGTH)
                # the accepted tokens of a speculative wave too: the stop
                # matcher and the automaton see every real column
                self._ingest(slot, act, tok, float(logprobs[slot, j]), now,
                             device_done=done, device_reason=reason,
                             latency=per_tok)

    # -- token emission (stop sequences, constraints) -----------------------

    def _emit(self, act: _Active, tok: int, lp: float, *, finished: bool,
              reason: Optional[str],
              latency: Optional[float] = None) -> None:
        """Append one client-visible token to ``act``'s stream and its
        :class:`StreamEvent`; the tenant is charged the token. A token
        that re-derives a replayed prefix (``act.suppress``) has no event
        and no charge: the client was streamed it, and the tenant charged,
        before the stream left its slot."""
        act.tokens.append(tok)
        act.logprobs.append(lp)
        if len(act.tokens) <= act.suppress:
            return
        self._tokens_emitted += 1
        # the WFQ deficit counter charges tokens actually streamed
        self.tenants.on_tokens(act.request.tenant, 1)
        if latency is not None:
            self._decode_tokens += 1
            self.token_latency_stats.add(latency)
        self.events.append(StreamEvent(act.request.request_id, tok,
                                       finished, reason, logprob=lp))

    def _flush_held(self, act: _Active,
                    latency: Optional[float] = None) -> None:
        """Stream every token the stop matcher held back (a non-stop
        finish emits the held tail instead of trimming it)."""
        if act.matcher is None:
            return
        for t, l in act.matcher.flush():
            self._emit(act, t, l, finished=False, reason=None,
                       latency=latency)

    def _ingest(self, slot: int, act: _Active, tok: int, lp: float,
                now: float, *, device_done: bool,
                device_reason: Optional[str],
                latency: Optional[float] = None) -> None:
        """Fold ONE generated token into a live request: the stop matcher
        (trimmed emission), the constraint's advance and next mask row,
        the events, and the release when the token finishes the request
        (the device's eos or budget, a stop match, or a completed
        constraint). A host-side finish retires the slot on the engine;
        chunks in flight drop its columns by the snapshot rule."""
        matched = False
        if act.matcher is not None:
            flushed, matched = act.matcher.push(tok, lp)
        else:
            flushed = [(tok, lp)]
        cons = act.request.constraint
        cons_done = False
        if cons is not None and not matched:
            cons.advance(tok)
            cons_done = bool(cons.done)
            if not cons_done and not device_done:
                # the automaton advanced: the next dispatch draws this
                # slot against the new allowed set
                self.engine.set_slot_mask(slot, cons.allowed_tokens())
        if (device_done or cons_done) and act.matcher is not None \
                and not matched:
            # a finish that trims nothing streams the held tail
            flushed = flushed + act.matcher.flush()
        host_stop = matched or cons_done
        finishing = device_done or host_stop
        reason = ((FINISH_STOP if host_stop else device_reason)
                  if finishing else None)
        last = len(flushed) - 1
        for i, (t, l) in enumerate(flushed):
            fin = finishing and not matched and i == last
            self._emit(act, t, l, finished=fin,
                       reason=reason if fin else None, latency=latency)
        if matched:
            # a trimmed stop: no token carries the finish, so a token-less
            # finished event closes the stream
            self.events.append(StreamEvent(
                act.request.request_id, None, True, reason))
        if not finishing:
            return
        if host_stop:
            self._stop_finishes += 1
            if not device_done:
                # the device lane is still live: retire it so later
                # chunks stop spending its budget
                self.engine.retire(slot)
        self._release(slot, reason, now)

    def _release(self, slot: int, reason: str, now: float) -> None:
        act = self.active.pop(slot)
        self.engine.free_slot(slot)
        self._free.append(slot)
        ttft = (None if act.first_token_time is None
                else act.first_token_time - act.request.arrival_time)
        tokens, lps = self._longest(act.request, act.tokens, act.logprobs)
        self._complete(act.request, tokens, lps, reason, ttft=ttft, now=now)

    def _longest(self, request: Request, tokens: List[int],
                 logprobs: List[float]) -> Tuple[List[int], List[float]]:
        """The stream a finish reports: ``tokens``, or the request's
        emitted-prefix snapshot (dropped here) when that is longer — a
        stream that finished mid-replay (a host-side stop, a deadline)
        still carries everything the client was streamed."""
        st = self._replay.pop(request.request_id, None)
        if st is not None and len(st.tokens) > len(tokens):
            return st.tokens, st.logprobs
        return tokens, logprobs

    def _complete(self, request: Request, tokens: List[int],
                  logprobs: List[float], reason: str, *,
                  ttft: Optional[float], now: float) -> None:
        self._prefix_hits.pop(request.request_id, None)
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
        excluded; overlapping pipelined chunks counted once),
        ``ttft_*`` / ``token_latency_*`` in ms, ``pipeline_depth``, and
        ``prefix_hits`` / ``prefix_misses`` (submit-time pool matches),
        ``tenants_seen`` and ``tenant_throttled`` (per-tenant detail in
        :meth:`tenant_summary`), ``stop_finishes`` (requests a stop
        sequence or a completed constraint finished) and
        ``mask_uploads`` (the engine's vocab-mask copies). An engine with
        an adapter pool adds ``adapters_registered``; a
        paged engine adds the pool's occupancy, ``page_share_hits``
        (hits admitted copy-on-write), ``pages_exhausted_waits`` (ticks
        the queue head waited for pages) and ``page_deferrals`` (ticks in
        which requests stayed queued beside free slots for want of pages,
        those waits included), ``pages_swapped`` and ``swap_bytes`` (the
        host tier's pages and bytes now); a host-swap engine
        ``parked_conversations``, ``pauses``, ``preemptions``,
        ``swap_resumes``, ``recompute_resumes``, ``swap_capacity_drops``
        and, paging adapters, the ``adapter_*`` paging stats and
        ``adapter_waits`` (ticks a request waited for an adapter row); a
        chunked-prefill engine
        ``chunked_admissions`` and ``chunked_chunks`` (its prefill
        forwards, chunk 0 included); a speculative one the chunk and wave
        counts, ``spec_tokens_per_wave``, the acceptance rate, the gate's
        state and its decisions."""
        out = {
            "requests_completed": float(len(self.completions)),
            "tokens_emitted": float(self._tokens_emitted),
            "steps": float(self._steps),
            "admitted_requests": float(self._admitted_requests),
            "admit_dispatches": float(self._admit_dispatches),
            "pipeline_depth": float(self.pipeline_depth),
            "decode_steps": float(self.engine.decode_steps_taken),
            "cache_bytes": float(self.engine.cache_bytes()),
            "prefix_hits": float(self._prefix_hit_count),
            "prefix_misses": float(self._prefix_miss_count),
            "tenants_seen": float(len(self.tenants.tenants_seen)),
            "tenant_throttled": float(self._throttled),
            "stop_finishes": float(self._stop_finishes),
            "mask_uploads": float(self.engine.mask_uploads),
        }
        if self.engine.adapter_pool_enabled:
            out["adapters_registered"] = float(
                self.engine.adapters_registered)
        if self._started is not None:
            elapsed = max(self.clock() - self._started, 1e-9)
            out["tokens_per_sec"] = self._tokens_emitted / elapsed
        if self._decode_time > 0:
            out["decode_tokens_per_sec"] = (
                self._decode_tokens / self._decode_time)
            out["decode_tokens"] = float(self._decode_tokens)
            out["decode_time_s"] = self._decode_time
        if self.engine.paged:
            ps = self.engine.page_stats()
            out["pages_total"] = ps["pages_total"]
            out["pages_in_use"] = ps["pages_in_use"]
            out["pages_shared"] = ps["pages_shared"]
            out["page_fragmentation"] = ps["fragmentation"]
            out["page_share_hits"] = float(self._page_share_hits)
            out["pages_exhausted_waits"] = float(self._pages_exhausted_waits)
            out["page_deferrals"] = float(self._page_deferrals)
            out["pages_swapped"] = ps["pages_swapped"]
            out["swap_bytes"] = ps["swap_bytes"]
        if self.engine.host_swap_enabled:
            out["parked_conversations"] = float(len(self._parked))
            out["pauses"] = float(self._pauses)
            out["preemptions"] = float(self._preemptions)
            out["swap_resumes"] = float(self._swap_resumes)
            out["recompute_resumes"] = float(self._recompute_resumes)
            out["swap_capacity_drops"] = float(self._swap_capacity_drops)
            ap = self.engine.adapter_paging_stats()
            if ap is not None:
                for k, v in ap.items():
                    out[f"adapter_{k}"] = float(v)
                out["adapter_waits"] = float(self._adapter_waits)
        if self.engine.chunked_prefill_enabled:
            out["chunked_admissions"] = float(self._chunked_admissions)
            out["chunked_chunks"] = float(self._chunked_chunks)
        g = self._gate
        if g is not None:
            out["spec_chunks"] = float(self._spec_chunks)
            out["spec_waves"] = float(self._spec_waves)
            out["spec_drafted"] = float(self._spec_drafted)
            out["spec_accepted"] = float(self._spec_accepted)
            out["spec_accept_rate"] = (
                self._spec_accepted / self._spec_drafted
                if self._spec_drafted else 0.0)
            out["spec_tokens_per_wave"] = (
                (self._spec_waves + self._spec_accepted) / self._spec_waves
                if self._spec_waves else 0.0)
            out["spec_gate_state"] = g.state()
            out["spec_acceptance_ewma"] = g.accept_ewma
            out["spec_break_even"] = g.break_even()
            out["spec_gate_spec_decisions"] = float(
                self._gate_spec_decisions)
            out["spec_gate_plain_decisions"] = float(
                self._gate_plain_decisions)
        for name, stats in (("ttft", self.ttft_stats),
                            ("token_latency", self.token_latency_stats)):
            for k, v in stats.summary().items():
                out[f"{name}_{k}"] = v
        return out
