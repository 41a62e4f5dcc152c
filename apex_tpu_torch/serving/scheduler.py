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

Observability (:mod:`apex_tpu_torch.telemetry`), as in JAX: ``registry``
counts submissions, admissions (by prefill bucket and admission-batch
size), finishes by reason, tokens, page and tenant traffic, gauges the
pipeline and the pools, and observes TTFT and per-token latency into
SLO-bucketed histograms; ``spans`` records each request's phase timeline
and the ``engine.dispatch`` / ``engine.fetch`` / ``engine.admit`` /
``engine.verify`` host sections; ``recorder`` logs every load-bearing
host decision into the flight recorder, and :meth:`Scheduler.dump_bundle`
(automatically into ``bundle_dir`` on a queue-full rejection) writes a
post-mortem bundle that ``python -m apex_tpu_torch.telemetry.replay``
replays; ``slo`` feeds streaming quantile sketches and burn-rate
machines; ``metrics`` (a :class:`~apex_tpu_torch.profiler.MetricsLogger`)
gets one record a tick and one a completion. Every sink is host code: it
launches nothing on the device and waits for nothing.

Self-tuning (``tuner``, :mod:`.tuner`): a controller tunes the declared
ladders of ``decode_chunk`` / ``pipeline_depth`` / ``max_admit_batch`` /
``spec_k`` online from per-chunk tokens-per-second EWMAs, switching only
among the engine's declared rungs (``EngineConfig.decode_chunks`` /
``spec_ks``, validated here at construction). Streams are those of any
fixed-knob run.

Resilience (:mod:`.resilience`), as in JAX: a fault at any engine seam
(admission, dispatch, fetch, retire, a park or a resume) or an
out-of-vocab token in a fetched batch or a first token is quarantined —
the chunks in flight are dropped unfetched, ``Engine.rebuild_slots``
resets the cache and the state in place, and every interrupted request
replays from its prompt with the stream it had sent suppressed (the
emitted-prefix snapshot). Requests in the fault's blast radius are
charged a retry (``ResilienceConfig``: bounded, with exponential backoff
on the scheduler clock, an ``error`` event each); exhaustion completes
them with ``error`` or, with an ``on_evict`` hook (a fleet router), hands
them over as :class:`EvictedRequest`. Too many rebuilds in a row fail
the engine terminally (``submit`` raises ``EngineFailed``). A fetch
watchdog flags hung chunks, a queued request whose deadline the queue
already dooms is shed at once, and :attr:`Scheduler.health` (a
``HealthMonitor``) is the ``ok → degraded → draining → failed`` machine
behind ``/healthz``. ``journal`` (a :class:`~.journal.Journal`) appends
every submit, the streams' growth at each fetch, finishes, parks and
resumes and registrations, so ``journal.recover_scheduler`` continues
every unfinished stream after a process death.

>>> sched = Scheduler(engine, pipeline_depth=2)
>>> sched.submit(Request("r0", prompt, max_tokens=16))
>>> sched.run_until_idle()
>>> sched.completions["r0"].tokens
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.profiler import LatencyStats, MetricsLogger
from apex_tpu_torch.serving.engine import (
    Admission,
    ChunkedAdmission,
    Engine,
    StepHandle,
)
from apex_tpu_torch.serving import journal as journal_mod
from apex_tpu_torch.serving.pages import PagesExhausted
from apex_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_REASONS,
    FINISH_STOP,
    FINISH_TIMEOUT,
    Completion,
    Request,
    StopMatcher,
    StreamEvent,
)
from apex_tpu_torch.serving.resilience import (
    HEALTH_DRAINING,
    HEALTH_FAILED,
    KIND_FLOOD,
    EngineFailed,
    HealthMonitor,
    ResilienceConfig,
)
from apex_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    TenancyConfig,
    TenantBook,
    TenantThrottled,
)
from apex_tpu_torch.serving.tuner import Controller, TunerConfig, ewma
from apex_tpu_torch.telemetry import flightrec as flightrec_mod
from apex_tpu_torch.telemetry import spans as spans_mod
from apex_tpu_torch.telemetry.ring import Ring
from apex_tpu_torch.telemetry.slo import (
    METRICS as SLO_METRICS,
    STATE_CODE as SLO_STATE_CODE,
    SLOConfig,
    SLOMonitor,
    SLOObjective,
)

#: fault causes the scheduler detects (label values of
#: ``serving_faults_detected_total``, pre-created so scrapes show explicit
#: zeros)
FAULT_CAUSES = ("admit", "dispatch", "fetch", "retire", "invalid_token")

#: shed reasons (label values of ``serving_requests_shed_total``)
SHED_REASONS = ("queue_full", "deadline", "tenant_rate")

#: the causes that hard-freeze the tuner to its base operating point: a
#: constrained request, a slot re-deriving a replayed prefix, a drain, a
#: tripped fetch watchdog and a fault rebuild
TUNER_FREEZE_CAUSES = ("constrained", "replay", "drain", "watchdog",
                       "rebuild")


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
        self.wall_plain = ewma(self.wall_plain, wall, self.cfg.ewma_alpha)
        self.plain_since_probe += 1
        self.spec_since_plain = 0

    def observe_spec(self, wall: float,
                     tokens_per_wave: Optional[float]) -> None:
        self.wall_spec = ewma(self.wall_spec, wall, self.cfg.ewma_alpha)
        self.spec_chunks += 1
        self.plain_since_probe = 0
        self.spec_since_plain += 1
        if tokens_per_wave is not None:
            self.accept_ewma = ewma(self.accept_ewma, tokens_per_wave,
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


class _RegistryMetrics:
    """Pre-bound registry handles — children resolved once here so the
    scheduler's per-token path never does a name/label lookup."""

    def __init__(self, registry, engine: Engine):
        # the JAX scheduler's families, every one pre-created (explicit
        # zeros in scrapes) so the two packages' scrapes carry the same
        # names and labels
        self.queue_depth = registry.gauge(
            "serving_queue_depth", "requests waiting for a slot")
        self.active_slots = registry.gauge(
            "serving_active_slots", "decode slots currently occupied")
        registry.gauge(
            "serving_slots_total", "decode slots in the engine"
        ).set(engine.slots)
        self.inflight = registry.gauge(
            "serving_inflight_chunks",
            "decode chunks dispatched but not yet fetched (the pipeline "
            "depth actually in use)")
        self.submitted = registry.counter(
            "serving_requests_submitted_total", "requests accepted into "
            "the queue (or completed at submit)")
        self.admitted = registry.counter(
            "serving_requests_admitted_total",
            "requests prefilled into a slot")
        self.admit_dispatches = registry.counter(
            "serving_admit_dispatches_total",
            "batched admission dispatches (one compiled (bucket, k) "
            "program call each)")
        ab = registry.counter(
            "serving_admit_batch_requests_total",
            "requests admitted, by admission-batch size",
            labels=("size",))
        # pre-create every ladder rung so a scrape shows explicit zeros
        self.admit_batch = {k: ab.labels(size=str(k))
                            for k in engine.admit_batch_sizes}
        bk = registry.counter(
            "serving_prefill_bucket_requests_total",
            "requests admitted, by padded prefill bucket",
            labels=("bucket",))
        self.bucket = {b: bk.labels(bucket=str(b))
                       for b in engine.prompt_buckets}
        fin = registry.counter(
            "serving_requests_finished_total",
            "completed requests by finish reason", labels=("reason",))
        self.finished = {r: fin.labels(reason=r) for r in FINISH_REASONS}
        self.queue_expired = registry.counter(
            "serving_queue_expired_total",
            "requests that blew their deadline while still queued")
        self.tokens = registry.counter(
            "serving_tokens_emitted_total", "generated tokens streamed")
        self.steps = registry.counter(
            "serving_scheduler_steps_total", "scheduler ticks")
        self.ttft = registry.histogram(
            "serving_ttft_seconds", "arrival to first token")
        self.token_latency = registry.histogram(
            "serving_token_latency_seconds",
            "per-token steady-decode latency (chunk dispatch-to-fetch "
            "wall time / chunk tokens)")
        self.request_latency = registry.histogram(
            "serving_request_latency_seconds", "arrival to completion")
        # -- resilience (serving.resilience) ------------------------------
        flt = registry.counter(
            "serving_faults_detected_total",
            "faults detected at engine seams, by cause",
            labels=("cause",))
        self.faults = {c: flt.labels(cause=c) for c in FAULT_CAUSES}
        shed = registry.counter(
            "serving_requests_shed_total",
            "requests rejected/shed by overload protection, by reason",
            labels=("reason",))
        self.shed = {r: shed.labels(reason=r) for r in SHED_REASONS}
        self.retries = registry.counter(
            "serving_retries_total",
            "fault-affected requests scheduled for re-admission")
        self.rebuilds = registry.counter(
            "serving_rebuilds_total",
            "cache/state buffer rebuilds after a fault")
        self.watchdog = registry.counter(
            "serving_watchdog_trips_total",
            "decode chunks whose dispatch-to-fetch wall time exceeded "
            "the watchdog timeout (hung dispatches)")
        self.replayed = registry.counter(
            "serving_replayed_tokens_total",
            "tokens re-derived (and suppressed) during deterministic "
            "replay after a rebuild")
        # -- KV-cache capacity (quantized cache + prefix pool) ------------
        registry.gauge(
            "serving_kv_cache_bytes",
            "device bytes held by the slot KV cache (quantized data + "
            "scale planes under a quantized kv_cache_dtype)"
        ).set(engine.cache_bytes())
        # -- paged KV cache (EngineConfig.page_size) ----------------------
        # pre-created even for contiguous engines (explicit zeros in
        # scrapes, same convention as every ladder counter above)
        self.pages_in_use = registry.gauge(
            "serving_pages_in_use",
            "KV-cache pages currently allocated (paged layout; 0 under "
            "the contiguous layout)")
        self.pages_free = registry.gauge(
            "serving_pages_free",
            "KV-cache pages on the free list (paged layout)")
        self.pages_shared = registry.gauge(
            "serving_pages_shared",
            "KV-cache pages pinned by more than one holder — "
            "copy-on-write prefix pages with live sharers")
        self.page_fragmentation = registry.gauge(
            "serving_page_fragmentation",
            "internal fragmentation of the allocated pages: 1 - "
            "used_tokens / (pages_in_use * page_size)")
        self.page_share_hits = registry.counter(
            "serving_page_share_hits_total",
            "admissions that mapped a registered prefix's pages "
            "copy-on-write instead of copying prefix K/V bytes")
        self.pages_exhausted = registry.counter(
            "serving_pages_exhausted_total",
            "admission waves deferred because the page pool had fewer "
            "free pages than the head request needed (backpressure — "
            "the request stays queued)")
        # -- host-swap oversubscription (EngineConfig.host_swap) ----------
        self.pages_swapped = registry.gauge(
            "serving_pages_swapped",
            "KV-cache pages parked in the host-RAM swap tier (paused "
            "conversations' private pages; 0 without host_swap)")
        self.swap_bytes = registry.gauge(
            "serving_swap_bytes",
            "host-RAM bytes held by parked swap payloads (storage-form "
            "page blocks plus state rows)")
        self.preemptions = registry.counter(
            "serving_preemptions_total",
            "active requests preempted under page pressure (the WFQ "
            "victim's pages freed; its stream resumes bit-identically "
            "via fault replay)")
        self.chunked_chunks = registry.counter(
            "serving_chunked_prefill_chunks_total",
            "chunked-prefill chunk forwards dispatched (long-prompt "
            "admissions interleaved with decode waves)")
        self.chunked_admissions = registry.counter(
            "serving_chunked_admissions_total",
            "requests admitted through the chunked-prefill path")
        self.prefix_hits = registry.counter(
            "serving_prefix_hits_total",
            "submitted requests that matched a pooled shared prefix "
            "(admission pays the tail bucket only)")
        self.prefix_misses = registry.counter(
            "serving_prefix_misses_total",
            "submitted requests that missed the prefix pool (cold "
            "prefill at the full prompt bucket)")
        # -- speculative decoding (EngineConfig.spec_k) -------------------
        self.spec_drafted = registry.counter(
            "serving_spec_drafted_total",
            "draft tokens proposed to the speculative verify forward")
        self.spec_accepted = registry.counter(
            "serving_spec_accepted_total",
            "draft tokens the target's verification accepted (emitted "
            "beyond the one-per-wave baseline)")
        self.spec_gate = registry.gauge(
            "serving_spec_gate_state",
            "speculation payoff gate: 2 open, 1 measuring, 0 closed")
        self.spec_accept_ewma = registry.gauge(
            "serving_spec_acceptance_ewma",
            "EWMA of tokens emitted per speculative wave (the gate "
            "compares it to the measured wall_spec/wall_plain "
            "break-even)")
        # -- multi-tenant serving (serving.tenancy) -----------------------
        # tenant-labeled children are created lazily per tenant (the
        # label set is the live tenant population, not a config-time
        # ladder) and cached so the per-token path pays a dict get
        tt = registry.counter(
            "serving_tenant_tokens_total",
            "generated tokens streamed, by tenant", labels=("tenant",))
        ta = registry.counter(
            "serving_tenant_admissions_total",
            "requests prefilled into a slot, by tenant",
            labels=("tenant",))
        ts = registry.counter(
            "serving_tenant_sheds_total",
            "requests shed or rate-throttled, by tenant and reason",
            labels=("tenant", "reason"))
        tq = registry.gauge(
            "serving_tenant_queue_depth",
            "queued requests, by tenant", labels=("tenant",))
        self._tenant_families = (tt, ta, ts, tq)
        self._tenant_children: Dict[str, Dict[str, Any]] = {}
        # -- self-tuning control plane (serving.tuner) --------------------
        # pre-created even without a tuner (explicit zeros in scrapes,
        # the ladder-counter convention); per-knob children are bound
        # by the scheduler once the declared knobs are known
        self.tuner_state = registry.gauge(
            "serving_tuner_state",
            "self-tuning controller: 0 frozen, 1 measuring, 2 steady, "
            "3 probing")
        self._tuner_knob_family = registry.gauge(
            "serving_tuner_knob",
            "incumbent operating-point value per tuned knob",
            labels=("knob",))
        self._tuner_switch_family = registry.counter(
            "serving_tuner_switches_total",
            "operating-point switches the controller committed, by "
            "knob", labels=("knob",))
        self.tuner_knob: Dict[str, Any] = {}
        self.tuner_switches: Dict[str, Any] = {}
        # -- SLO observatory (telemetry.slo) ------------------------------
        # pre-created even without an SLO config (explicit zeros in
        # scrapes); quantile/objective children are bound lazily by
        # the scheduler's gauge refresh once the monitor exists
        self._slo_quantile_family = registry.gauge(
            "serving_slo_quantile_seconds",
            "streaming sketch-backed latency quantiles, by metric "
            "(ttft/token_latency/queue_wait/e2e) and quantile "
            "(p50/p95/p99)", labels=("metric", "quantile"))
        self._slo_burn_family = registry.gauge(
            "serving_slo_burn_rate",
            "error-budget burn rate per objective and window (1.0 = "
            "consuming the budget exactly on schedule)",
            labels=("objective", "window"))
        self._slo_state_family = registry.gauge(
            "serving_slo_state",
            "burn-rate machine state per objective: 0 ok, 1 warning, "
            "2 burning", labels=("objective",))
        self._slo_budget_family = registry.gauge(
            "serving_slo_budget_remaining",
            "fraction of the error budget left per objective (1 "
            "untouched, 0 exhausted, negative = overrun)",
            labels=("objective",))
        self._slo_alert_family = registry.counter(
            "serving_slo_alerts_total",
            "burn-rate alerts fired (transitions into warning or "
            "burning), by objective and state",
            labels=("objective", "state"))
        self.slo_quantile: Dict[Tuple[str, str], Any] = {}
        self.slo_children: Dict[str, Dict[str, Any]] = {}
        # -- durable request journal (serving.journal) --------------------
        # pre-created even without a journal (explicit zeros in
        # scrapes, the ladder-counter convention); refreshed at the
        # scheduler's fetch-boundary commit
        self.journal_appends = registry.counter(
            "serving_journal_appends_total",
            "write-ahead journal records appended (submit/extend/"
            "finish/park/resume/registrations)")
        self.journal_rotations = registry.counter(
            "serving_journal_rotations_total",
            "journal segments sealed and rotated")
        self.journal_compactions = registry.counter(
            "serving_journal_compactions_total",
            "journal compactions (finished requests dropped, live "
            "state rewritten into one fresh segment)")
        self.journal_fsync = registry.counter(
            "serving_journal_fsync_seconds",
            "wall seconds spent in journal fsync calls — the "
            "durability tax the fsync policy prices")
        self.journal_bytes = registry.gauge(
            "serving_journal_bytes",
            "write-ahead journal bytes on disk across all segments")
        self.journal_lag = registry.gauge(
            "serving_journal_lag_bytes",
            "journal bytes appended since the last fsync — what a "
            "crash right now could lose to the page cache")
        self.journal_recovered = registry.counter(
            "serving_journal_recovered_total",
            "unfinished requests resubmitted from a journal during "
            "crash recovery (replay_into/recover_scheduler)")
        # the health families (serving_health_*) are the scheduler's
        # HealthMonitor's, created right after these

    def tenant(self, t: str) -> Dict[str, Any]:
        """Cached per-tenant metric children (created on first
        sight)."""
        ch = self._tenant_children.get(t)
        if ch is None:
            tt, ta, ts, tq = self._tenant_families
            ch = self._tenant_children[t] = {
                "tokens": tt.labels(tenant=t),
                "admitted": ta.labels(tenant=t),
                "queue": tq.labels(tenant=t),
                "shed": {r: ts.labels(tenant=t, reason=r)
                         for r in SHED_REASONS},
            }
        return ch

    def bind_tuner(self, knobs) -> None:
        """Pre-create the per-knob children for the declared ladder
        (explicit zeros in scrapes, like every ladder counter)."""
        for k in knobs:
            self.tuner_knob[k] = self._tuner_knob_family.labels(knob=k)
            self.tuner_switches[k] = \
                self._tuner_switch_family.labels(knob=k)

    def bind_slo(self, metrics, objective_keys) -> None:
        """Pre-create the SLO children for the declared surface —
        quantile gauges per metric and burn/state/budget/alert
        children per objective (explicit zeros in scrapes)."""
        for m in metrics:
            for q in ("p50", "p95", "p99"):
                self.slo_quantile[(m, q)] = \
                    self._slo_quantile_family.labels(metric=m,
                                                     quantile=q)
        for k in objective_keys:
            self.slo_children[k] = {
                "fast": self._slo_burn_family.labels(objective=k,
                                                     window="fast"),
                "slow": self._slo_burn_family.labels(objective=k,
                                                     window="slow"),
                "state": self._slo_state_family.labels(objective=k),
                "budget": self._slo_budget_family.labels(objective=k),
                "alerts": {
                    s: self._slo_alert_family.labels(objective=k,
                                                     state=s)
                    for s in ("warning", "burning")},
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
    """Recovery bookkeeping of one request that left its slot mid-stream
    (a fault, a park, a preemption, a failover hand-off): the tokens and
    logprobs the client was streamed (the emitted-prefix snapshot a
    replay re-derives, which only ever grows), the retries the request
    has used and the backoff gate before its next admission."""

    __slots__ = ("tokens", "logprobs", "attempts", "not_before")

    def __init__(self):
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.attempts = 0
        self.not_before = float("-inf")


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


#: _ingest outcomes: the slot is still decoding, was released, or a
#: retire-seam fault ran the recovery mid-call (the caller abandons its
#: unpack or admission loop: the scheduler's state was rebuilt)
_LIVE, _RELEASED, _RECOVERED = 0, 1, 2


@dataclasses.dataclass
class EvictedRequest:
    """One interrupted request handed to a :attr:`Scheduler.on_evict`
    hook instead of an ``error`` completion: the request and the longest
    stream its client was sent. A fleet router resubmits it to a healthy
    replica with ``submit(request, replay_prefix=tokens)``; the replay
    re-derives the prefix silently, so the client's stream continues
    with no token duplicated or lost."""

    request: Request
    tokens: List[int]
    logprobs: List[float]


class Scheduler:
    """Drive an :class:`Engine` over a stream of requests.

    ``clock`` is injectable (tests drive deadlines with a fake clock) and
    must be monotonic; inject ``sleep`` beside it (backoff waits go
    through ``sleep``, and real sleeping cannot advance a fake clock).
    ``resilience`` sets the recovery and overload policy
    (:class:`~.resilience.ResilienceConfig`), ``on_evict`` hands work
    this scheduler gives up to a fleet router, and ``journal`` (a
    :class:`~.journal.Journal`) makes every stream durable. Each tick:
    expire deadlines; hand the queued requests that fit the free slots
    (and, paged, the free pages:
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
    pages preempt the tenant furthest ahead of its fair share.

    Telemetry (all optional, all host-side): ``metrics`` (a
    :class:`~apex_tpu_torch.profiler.MetricsLogger`), ``registry`` (a
    :class:`~apex_tpu_torch.telemetry.registry.Registry`), ``spans`` (a
    :class:`~apex_tpu_torch.telemetry.spans.SpanRecorder`), ``recorder``
    (a :class:`~apex_tpu_torch.telemetry.flightrec.FlightRecorder`) and
    ``slo`` (a :class:`~apex_tpu_torch.telemetry.slo.SLOConfig`); the
    span recorder's and flight recorder's clocks are slaved to ``clock``.
    ``bundle_dir`` is where :meth:`dump_bundle` writes by default and
    where at most ``max_auto_bundles`` automatic bundles land (one a
    trigger wave); ``bundle_meta`` goes into the manifest verbatim (put
    ``{"params": {"init_seed": N}}`` there so a replay can rebuild the
    weights); ``request_log`` bounds the completed-request records a
    bundle carries.

    ``tuner`` (a :class:`~apex_tpu_torch.serving.tuner.TunerConfig`)
    builds the knob controller: every ``decode_chunk`` / ``spec_k``
    candidate must be a rung of the engine's ladder (checked here), and
    ``pipeline_depth`` / ``max_admit_batch`` become live attributes the
    controller rewrites each tick. A tuner that owns ``spec_k`` replaces
    the payoff gate, and passing ``spec_gate`` with it raises."""

    def __init__(self, engine: Engine, *, max_queue: int = 256,
                 metrics: Optional[MetricsLogger] = None,
                 registry=None, spans=None,
                 clock: Callable[[], float] = time.monotonic,
                 pipeline_depth: int = 1,
                 max_admit_batch: Optional[int] = None,
                 spec_gate: Optional[SpecGateConfig] = None,
                 tuner: Optional[TunerConfig] = None,
                 tenancy: Optional[TenancyConfig] = None,
                 slo: Optional[SLOConfig] = None,
                 recorder=None, bundle_dir: Optional[str] = None,
                 bundle_meta: Optional[Dict] = None,
                 max_auto_bundles: int = 4,
                 request_log: int = 4096,
                 preempt: Optional[bool] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 resilience: Optional[ResilienceConfig] = None,
                 on_evict: Optional[
                     Callable[[List["EvictedRequest"], str], None]] = None,
                 journal=None):
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth {pipeline_depth} must be >= 1 (1 = the "
                f"serial loop)")
        if max_admit_batch is not None and max_admit_batch < 1:
            raise ValueError(
                f"max_admit_batch {max_admit_batch} must be >= 1 or None")
        self.engine = engine
        self.max_queue = max_queue
        self.metrics = metrics
        self.clock = clock
        self.sleep = sleep
        self.resilience = resilience or ResilienceConfig()
        self.pipeline_depth = pipeline_depth
        self.max_admit_batch = max_admit_batch
        #: constructor values, kept for the bundle's config: a tuner
        #: rewrites the live attributes each tick
        self._cfg_pipeline_depth = pipeline_depth
        self._cfg_max_admit_batch = max_admit_batch
        self.queue: Deque[Request] = collections.deque()
        self.active: Dict[int, _Active] = {}
        self._free: List[int] = list(range(engine.slots))[::-1]
        self.events: List[StreamEvent] = []
        self.completions: Dict[str, Completion] = {}
        self.ttft_stats = LatencyStats()
        self.token_latency_stats = LatencyStats()
        #: telemetry sinks: pre-bound registry handles (the per-token
        #: path pays an attribute access and an add), the span recorder
        #: and the flight recorder, their clocks slaved to this one
        self._registry = registry
        self.telemetry = (None if registry is None
                          else _RegistryMetrics(registry, engine))
        self.spans = spans
        if spans is not None:
            spans.clock = self.clock
        self.recorder = recorder
        if recorder is not None:
            recorder.clock = self.clock
        if engine.fault_plan is not None:
            # the newest scheduler owns the observer: one without a
            # recorder clears a predecessor's wiring over a shared engine
            engine.fault_plan.on_inject = (
                None if recorder is None else
                lambda spec: recorder.record(
                    "inject", spec.point, spec.index, spec.kind))
        #: post-mortem bundles: the default directory, the manifest's
        #: caller metadata, the paths written (oldest first) and the
        #: auto-dump gate (one bundle a trigger wave, at most
        #: ``max_auto_bundles``)
        self.bundle_dir = bundle_dir
        self.bundle_meta = dict(bundle_meta or {})
        self.max_auto_bundles = max_auto_bundles
        self.bundles_written: List[str] = []
        self._auto_bundles = 0
        self._bundle_counter = 0
        self._dump_token = 0
        self._last_dump_token = -1
        #: replayable per-request records (the bundle's requests.jsonl):
        #: live ones by id, completed ones in a bounded ring
        self._req_records: Dict[str, Dict] = {}
        self._req_done = Ring(request_log)
        self._submit_seq = 0
        #: the router-facing eviction hook (``(evicted, cause) -> None``):
        #: work this scheduler can no longer serve (everything at a
        #: terminal failure, or one request whose retries ran out) goes
        #: there as EvictedRequest records instead of error outcomes.
        #: None keeps the single-engine abort-with-error semantics
        self.on_evict = on_evict
        #: the durable write-ahead journal (None journals nothing), each
        #: stream's journaled length (the extend cursor), the requests
        #: this scheduler was recovered with, and the journal counters
        #: last mirrored into the registry (deltas at each commit)
        self.journal = journal
        self._journal_len: Dict[str, int] = {}
        self._journal_recovered = 0
        self._j_seen = {"appends": 0, "rotations": 0, "compactions": 0,
                        "fsync_s": 0.0}
        if journal is not None and journal.seq == 0:
            # a fresh journal opens with the engine spec, so recovery can
            # refuse an incompatible engine; a recovered one keeps its
            self._jlog("meta", format=journal_mod.FORMAT_VERSION,
                       engine_spec=journal_mod._engine_spec(engine))
        #: the ok → degraded → draining → failed machine
        #: (``health.healthz`` is the /healthz callback)
        self.health = HealthMonitor(
            registry=registry,
            recovery_chunks=self.resilience.recovery_chunks,
            on_transition=self._on_health_transition)
        self._retries = 0
        self._retry_exhausted = 0
        self._rebuilds = 0
        self._shed = 0
        self._watchdog_trips = 0
        self._evicted_requests = 0
        self._consecutive_rebuilds = 0
        #: chunks dispatched but not yet fetched, oldest first: (handle,
        #: slot -> _Active snapshot at dispatch, dispatch time, pipeline
        #: depth at dispatch counting this chunk, the tuner's operating
        #: point at dispatch or None)
        self._inflight: Deque[
            Tuple[StepHandle, Dict[int, _Active], float, int,
                  Optional[Dict[str, int]]]] = collections.deque()
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
        #: the knob controller (None without a tuner), validated against
        #: the engine's ladders here; owning ``spec_k`` it replaces the
        #: payoff gate
        tunes_spec = tuner is not None and tuner.spec_k is not None
        self._tuner: Optional[Controller] = None
        if tuner is not None:
            self._tuner = self._build_tuner(tuner, engine)
        #: the payoff gate (None unless the engine speculates at its base
        #: point and no tuner owns the knob)
        self._gate: Optional[_SpecGate] = None
        if engine.engine_cfg.spec_k > 0 and not tunes_spec:
            self._gate = _SpecGate(spec_gate or SpecGateConfig(),
                                   engine.engine_cfg.spec_k)
        elif spec_gate is not None:
            raise ValueError(
                "spec_gate given but unusable — speculation needs "
                "EngineConfig.spec_k > 0, and a tuner that owns "
                "the spec_k knob replaces the gate (two "
                "controllers would fight over one variant choice)")
        self._gate_state_seen: Optional[float] = None
        self._gate_spec_decisions = 0
        self._gate_plain_decisions = 0
        self._spec_chunks = 0
        self._spec_waves = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        #: weighted-fair queueing, rate limits and per-tenant accounting
        self._tenancy_cfg = tenancy
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
        #: the SLO observatory: sketches over ttft / token_latency /
        #: queue_wait / e2e (global and per tenant) and one burn-rate
        #: machine an objective, sharing this clock and recorder
        self._slo_cfg = slo
        self.slo: Optional[SLOMonitor] = None
        if slo is not None:
            self.slo = SLOMonitor(slo, clock=self.clock, recorder=recorder,
                                  on_state=self._on_slo_state)
            if self.telemetry is not None:
                self.telemetry.bind_slo(
                    SLO_METRICS, [o.key() for o in slo.objectives])

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request, *,
               replay_prefix: Optional[Sequence[int]] = None,
               replay_logprobs: Optional[Sequence[float]] = None) -> None:
        """Enqueue ``request``; raises :class:`QueueFull` at capacity (or
        under an injected flood), ``EngineFailed`` once the health machine
        is terminal, :class:`TenantThrottled` when the tenant's token
        budget cannot cover ``max_tokens``, and ``ValueError`` on an
        invalid request. A prompt that already ends in the request's eos
        token completes here with no tokens. A prompt that starts with a
        registered prefix is matched here and admits through the pool.

        ``replay_prefix`` (a router's failover, a journal's recovery)
        primes the emitted-prefix snapshot with the tokens the client
        already saw elsewhere: generation re-derives them and suppresses
        their events, so the continued stream is the one it was being
        sent. Such a hand-off is not charged to the tenant's budget
        again."""
        if self.health.state == HEALTH_FAILED:
            raise EngineFailed(
                f"engine health is failed ({self.health.last_cause}); "
                f"not accepting requests")
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
        self._dump_token += 1
        rec = self.recorder
        tele = self.telemetry
        book = self.tenants
        # bounded tenant cardinality: past max_tenants distinct ids a new
        # one folds into the overflow tenant (the request is rewritten,
        # so every consumer sees one identity)
        tenant = request.tenant = book.admit_tenant(request.tenant)
        if eos is not None and prompt[-1] == eos:
            book.stats(tenant).submitted += 1
            if tele is not None:
                tele.submitted.inc()
            self._record_request(request, now)
            if rec is not None:
                rec.record("submit_terminal", rid)
            self._complete(request, [], [], FINISH_EOS, ttft=None, now=now)
            self.events.append(StreamEvent(rid, None, True, FINISH_EOS))
            return
        plan = self.engine.fault_plan
        spec = plan.take("submit") if plan is not None else None
        flooded = spec is not None and spec.kind == KIND_FLOOD
        if flooded or len(self.queue) >= self.max_queue:
            depth = self.max_queue if flooded else len(self.queue)
            hint = depth * self._chunk_ewma
            self._shed += 1
            if rec is not None:
                rec.record("queue_full", rid, depth, flooded)
            self.health.record_fault("queue_full")
            self._maybe_dump("queue_full")
            book.stats(tenant).shed += 1
            if tele is not None:
                tele.shed["queue_full"].inc()
                tele.tenant(tenant)["shed"]["queue_full"].inc()
            raise QueueFull(
                f"queue at capacity ({depth}"
                f"{', injected flood' if flooded else ''}); retry in "
                f"~{hint:.3f}s", queue_depth=depth, retry_after_s=hint)
        # the token budget is charged after the capacity gate, so a
        # QueueFull rejection never debits the bucket, and not for a
        # hand-off (its original submit was charged)
        wait = (None if replay_prefix is not None
                else book.throttle(tenant, request.max_tokens, now))
        if wait is not None:
            self._throttled += 1
            book.stats(tenant).throttled += 1
            book.stats(tenant).shed += 1
            if rec is not None:
                rec.record("tenant_throttle", rid, tenant, wait)
            if tele is not None:
                tele.shed["tenant_rate"].inc()
                tele.tenant(tenant)["shed"]["tenant_rate"].inc()
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
        if matchable and tele is not None:
            (tele.prefix_hits if hit is not None
             else tele.prefix_misses).inc()
        self._record_request(request, now)
        self._journal_submit(request, now)
        if replay_prefix:
            # a hand-off: what the client was streamed elsewhere becomes
            # this scheduler's snapshot, journaled and committed at once
            # (a crash before the first chunk must not forget it)
            st = self._replay.setdefault(rid, _ReplayState())
            if len(replay_prefix) > len(st.tokens):
                st.tokens = [int(t) for t in replay_prefix]
                st.logprobs = list(replay_logprobs or [])
            self._journal_extend(rid, st.tokens, st.logprobs)
            if self.journal is not None:
                self.journal.commit()
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
        if rec is not None:
            rec.record("submit", rid, len(prompt), request.max_tokens,
                       len(self.queue))
        if tele is not None:
            tele.submitted.inc()
            tele.queue_depth.set(len(self.queue))
        if self.spans is not None:
            self.spans.mark(rid, spans_mod.PHASE_QUEUED)

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

    def predicted_ttft_s(self) -> float:
        """The TTFT a request submitted now would likely see: the
        queue-drain estimate (:meth:`overload_hint_s`) plus the measured
        admission component, the gap between the median TTFT and the
        median queue wait of the SLO sketches (0 without them)."""
        base = self.overload_hint_s()
        if self.slo is None:
            return base
        ttft_p50 = self.slo.quantile("ttft", 0.5)
        wait_p50 = self.slo.quantile("queue_wait", 0.5)
        if ttft_p50 is None or wait_p50 is None:
            return base
        return base + max(ttft_p50 - wait_p50, 0.0)

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting: weight, submitted / admitted / shed /
        throttled / tokens and the live deficit counter
        (:meth:`TenantBook.summary`)."""
        return self.tenants.summary()

    def register_prefix(self, tokens) -> int:
        """Register a shared prompt-prefix template into the engine's
        pool (:meth:`Engine.register_prefix`); requests submitted after
        it match it. Journaled, so a recovered scheduler pools it
        again."""
        page = self.engine.register_prefix(tokens)
        self._jlog("prefix", tokens=[int(t) for t in tokens])
        return page

    def register_adapter(self, weights=None, *, name: Optional[str] = None,
                         seed: Optional[int] = None) -> int:
        """Register a LoRA adapter into the engine's pool
        (:meth:`Engine.register_adapter`), log the ``adapter_register``
        flight-recorder event and return its id. Journaled with its
        seed: a recovery re-registers it by name and re-derives the
        weights (an explicit-weights registration journals ``seed:
        null``, and its requests are skipped at recovery)."""
        aid = self.engine.register_adapter(weights, name=name, seed=seed)
        meta = self.engine._adapter_meta.get(aid, {})
        if self.recorder is not None:
            self.recorder.record("adapter_register", meta.get("name"), aid,
                                 meta.get("seed"))
        self._jlog("adapter", name=meta.get("name"), seed=meta.get("seed"),
                   rank=meta.get("rank"), adapter_id=aid)
        return aid

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
        release. A failed park (it rides the retire seam) recovers like
        any fault: the conversation replays from the snapshot just
        taken."""
        rid = act.request.request_id
        self._snapshot(act)
        n_pages = self.engine.slot_page_count(slot)
        try:
            evicted = self.engine.park_slot(slot, rid)
        except Exception as e:
            self._recover(now, cause="retire", detail=str(e), affected=[])
            return
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
        # the snapshot is the recompute resume's contract: journaled with
        # the park marker, so a crash while parked recovers it
        st = self._replay[rid]
        self._journal_extend(rid, st.tokens, st.logprobs)
        self._jlog("park", request_id=rid)
        if self.recorder is not None:
            self.recorder.record("page_swap_out", rid, slot, n_pages,
                                 self.engine.parked_bytes(rid))
        if self.spans is not None:
            self.spans.mark(rid, spans_mod.PHASE_QUEUED,
                            note=f"parked ({n_pages} pages)")
        if self.telemetry is not None:
            self.telemetry.active_slots.set(len(self.active))

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
                self._jlog("resume", request_id=rid, path="recompute")
                if self.recorder is not None:
                    self.recorder.record("page_swap_in", rid, -1, n_pages,
                                         "recompute")
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
            except PagesExhausted as e:
                self._free.append(slot)
                self._note_pages_exhausted(act.request, e.requested)
                return
            except KeyError:
                # evicted between the check and the take: the next spin
                # takes the recompute branch
                self._free.append(slot)
                pk.swap = False
                continue
            except ValueError:
                # an adapter thrash: the payload stays parked
                self._free.append(slot)
                self._adapter_waits += 1
                return
            except Exception as e:
                # the scatter failed: the payload is consumed and the
                # engine poisoned — recover, this conversation replaying
                # from its snapshot beside every interrupted slot
                self._free.append(slot)
                self._resume_q.popleft()
                self._parked.pop(rid, None)
                self._recover(now, cause="admit", detail=str(e),
                              affected=[], batch_reqs=[act.request])
                return
            self._resume_q.popleft()
            self._parked.pop(rid)
            self.active[slot] = act
            self._swap_resumes += 1
            self._jlog("resume", request_id=rid, path="swap")
            if self.recorder is not None:
                self.recorder.record("page_swap_in", rid, slot, n_pages,
                                     "swap")
            if self.spans is not None:
                self.spans.mark(rid, spans_mod.PHASE_DECODE,
                                note=f"swap-resume slot {slot}")
            if self.telemetry is not None:
                self.telemetry.active_slots.set(len(self.active))

    def _note_pages_exhausted(self, r: Request, needed: int) -> None:
        """Backpressure, not a fault: the head request waits until
        releases free its pages. With :attr:`preempt` the wait also runs
        the preemption pass."""
        self._pages_exhausted_waits += 1
        if self.recorder is not None:
            self.recorder.record("pages_exhausted", r.request_id, needed,
                                 self.engine.page_allocator.free_pages)
        if self.telemetry is not None:
            self.telemetry.pages_exhausted.inc()
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
        vid = act.request.request_id
        n_pages = self.engine.slot_page_count(slot)
        self._snapshot(act)
        if self.recorder is not None:
            self.recorder.record(
                "preempt", vid, slot, victim_tenant, n_pages,
                candidates[victim_tenant], dict(sorted(candidates.items())))
        try:
            self.engine.retire(slot)
        except Exception as e:
            self._recover(self.clock(), cause="retire", detail=str(e),
                          affected=[])
            return
        self.engine.free_slot(slot)
        self.active.pop(slot)
        self._free.append(slot)
        self._preemptions += 1
        self.queue.append(act.request)
        if self.spans is not None:
            self.spans.mark(vid, spans_mod.PHASE_QUEUED, note="preempted")
        if self.telemetry is not None:
            self.telemetry.preemptions.inc()
            self.telemetry.queue_depth.set(len(self.queue))
            self.telemetry.active_slots.set(len(self.active))

    # -- the loop ----------------------------------------------------------

    def step(self) -> None:
        """One tick: expire deadlines, admit queued requests into free
        slots, run one chunk of the chunked admission in progress,
        dispatch a decode chunk if any slot is live, then fetch and
        unpack chunks down to ``pipeline_depth - 1`` in flight (all of
        them when nothing was dispatched, so a tick always makes
        progress). Admissions come first so a short prompt never queues
        behind this tick's chunk forward. A fault anywhere in the tick
        runs the recovery instead of escaping; once the health machine is
        terminal a tick does nothing."""
        self._dump_token += 1
        if self.health.state == HEALTH_FAILED:
            return
        now = self.clock()
        if self._started is None:
            self._started = now
        self._sync_tuner()
        self._sync_slo(now)
        self._expire(now)
        # resumes first (their clients wait mid-stream), then the batched
        # admissions, the chunked start last: the wave of short prompts
        # must not queue behind chunk 0's forward
        if self._resume_q:
            self._admit_parked(now)
        self._admit_batches(now)
        self._start_chunked(now)
        self._advance_chunked()
        dispatched = bool(self.active) and self._dispatch_chunk()
        keep = self.pipeline_depth - 1 if dispatched else 0
        while len(self._inflight) > keep:
            self._collect_oldest()
        self._steps += 1
        tele = self.telemetry
        if tele is not None:
            tele.steps.inc()
            tele.queue_depth.set(len(self.queue))
            tele.active_slots.set(len(self.active))
            if len(self.tenants._stats) > 1:
                # per-tenant depth gauges only once a second tenant
                # exists: the single-tenant case pays no queue walk
                depth: Dict[str, int] = {}
                for r in self.queue:
                    depth[r.tenant] = depth.get(r.tenant, 0) + 1
                for t in self.tenants._stats:
                    tele.tenant(t)["queue"].set(depth.get(t, 0))
            if self.engine.paged:
                ps = self.engine.page_stats()
                tele.pages_in_use.set(ps["pages_in_use"])
                tele.pages_free.set(ps["pages_free"])
                tele.pages_shared.set(ps["pages_shared"])
                tele.page_fragmentation.set(ps["fragmentation"])
                tele.pages_swapped.set(ps["pages_swapped"])
                tele.swap_bytes.set(ps["swap_bytes"])
        if self.metrics is not None:
            elapsed = max(self.clock() - self._started, 1e-9)
            self.metrics.log(self._steps, {
                "queue_depth": len(self.queue),
                "slot_occupancy": len(self.active) / self.engine.slots,
                "tokens_emitted": self._tokens_emitted,
                "tokens_per_sec": self._tokens_emitted / elapsed,
            })

    def drain(self) -> None:
        """Fetch and unpack every in-flight chunk: afterwards ``events``
        and ``completions`` reflect all dispatched work. A tuner freezes
        for it (drained chunks are shutdown traffic, not steady state)
        and thaws at the next tick. The health machine reads
        ``draining`` meanwhile (``/healthz`` answers 503), then returns
        to its prior state."""
        if self._tuner is not None:
            self._tuner.freeze("drain")
        self.health.begin_drain()
        try:
            while self._inflight:
                self._collect_oldest()
        finally:
            self.health.end_drain()

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until the queue, the slots, the pipeline, any chunked
        admission and the resume queue are empty. When every queued
        request waits out a retry backoff and nothing is in flight, the
        earliest gate is slept out through ``sleep``."""
        steps = 0
        while not self.idle():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"not idle after {max_steps} steps — live slots "
                    f"{sorted(self.active)}, queue {len(self.queue)}, "
                    f"{len(self._inflight)} chunks in flight")
            wait = self._backoff_wait_s()
            if wait is not None:
                self.sleep(wait)

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
        """Deadlines: a queued request past its deadline expires; one the
        queue ahead already dooms (its wave of ``slots`` x the measured
        chunk latency lands past the deadline) is shed now, unless it
        fits the free slots and admits this tick; an active or parked
        request past its deadline times out with its stream so far."""
        kept: Deque[Request] = collections.deque()
        n_free, n_slots = len(self._free), self.engine.slots
        pos = 0
        for r in self.queue:
            if r.deadline is not None and now >= r.deadline:
                if self.recorder is not None:
                    self.recorder.record("queue_expired", r.request_id)
                if self.telemetry is not None:
                    self.telemetry.queue_expired.inc()
                self._abort(r, FINISH_TIMEOUT, now)
                continue
            wave = (pos - n_free) // n_slots + 1
            if (self.resilience.shed_deadlines and r.deadline is not None
                    and self._chunk_ewma > 0.0 and pos >= n_free
                    and now + wave * self._chunk_ewma > r.deadline):
                self._shed += 1
                self.tenants.stats(r.tenant).shed += 1
                if self.recorder is not None:
                    self.recorder.record("shed", r.request_id, "deadline")
                if self.telemetry is not None:
                    self.telemetry.shed["deadline"].inc()
                    self.telemetry.tenant(r.tenant)["shed"][
                        "deadline"].inc()
                self._abort(r, FINISH_TIMEOUT, now)
                continue
            kept.append(r)
            pos += 1
        self.queue = kept
        for slot in list(self.active):
            act = self.active.get(slot)
            if act is None:
                continue        # a retire-seam recovery below cleared it
            dl = act.request.deadline
            if dl is not None and now >= dl:
                # a timeout streams the matcher's held tail (nothing
                # matched, so nothing is trimmed)
                self._flush_held(act)
                try:
                    self.engine.retire(slot)
                except Exception as e:
                    # the expiring request still times out (its tokens
                    # are on the host); everyone else replays
                    self.events.append(StreamEvent(
                        act.request.request_id, None, True, FINISH_TIMEOUT))
                    self._release(slot, FINISH_TIMEOUT, now)
                    self._recover(now, cause="retire", detail=str(e),
                                  affected=[])
                    continue
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
               act: Optional[_Active] = None,
               error: Optional[str] = None) -> None:
        """A finish outside a slot (a queued or parked request timing
        out, a fault's exhausted retries): one finished event (carrying
        ``error``), and a completion carrying the longest stream the
        client saw, the parked stream's or the snapshot of one that left
        its slot."""
        if act is not None:
            self._flush_held(act)
        streamed = (act.tokens, act.logprobs) if act is not None else ([], [])
        tokens, lps = self._longest(request, *streamed)
        ttft = None
        if act is not None and act.first_token_time is not None:
            ttft = act.first_token_time - request.arrival_time
        self.events.append(StreamEvent(request.request_id, None, True,
                                       reason, error=error))
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
        the first eligible request: the strict FIFO pop. A request waiting
        out a retry backoff is not eligible (and blocks nobody behind it).
        ``now`` is the tick's clock reading (the heads' waits)."""
        by_tenant: Dict[str, List[Tuple[int, Request]]] = {}
        for idx, r in enumerate(self.queue):
            if not self._chunked_only(r) and not self._backing_off(r, now):
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

    def _backing_off(self, r: Request, now: float) -> bool:
        """Whether ``r`` waits out a retry backoff at ``now``."""
        st = self._replay.get(r.request_id)
        return st is not None and now < st.not_before

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
            if self.spans is not None:
                for r, slot in zip(reqs, slots):
                    self.spans.mark(r.request_id, spans_mod.PHASE_PREFILL,
                                    note=f"slot {slot}")
            for r in reqs:
                # every admission restarts the schema automaton
                if r.constraint is not None:
                    r.constraint.reset()
            t_admit = self.clock()
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
            except Exception as e:      # an error escaping the admission
                self._recover(self.clock(), cause="admit", detail=str(e),
                              affected=list(reqs), batch_reqs=list(reqs))
                return
            t_first = self.clock()
            # a NaN-poisoned prefill: a garbage first token means the
            # admission's cache insert cannot be trusted — quarantine
            # before any event leaks, charging only the bad rows
            vocab = self.engine.cfg.vocab_size
            bad = [r for r, res in zip(reqs, results)
                   if not 0 <= res.first_token < vocab]
            if bad:
                self._recover(t_first, cause="invalid_token",
                              detail="invalid first token from admission "
                              "(NaN-poisoned prefill)",
                              affected=bad, batch_reqs=list(reqs))
                return
            n_groups = results[-1].group + 1
            self._admitted_requests += len(reqs)
            self._admit_dispatches += n_groups
            if self.spans is not None:
                self.spans.section_at("engine.admit", t_admit, t_first)
            tele = self.telemetry
            if tele is not None:
                tele.admit_dispatches.inc(n_groups)
                tele.queue_depth.set(len(self.queue))
            rows = list(zip(reqs, slots, results))
            for idx, (r, slot, res) in enumerate(rows):
                if self._activate(slot, r, res, t_first,
                                  t_admit=t_admit) == _RECOVERED:
                    # a retire-seam fault rebuilt the engine mid-wave: the
                    # rows not yet activated lost their slots and go back
                    # to the queue's front (no event of theirs left)
                    self.queue.extendleft(
                        reversed([rr for rr, _, _ in rows[idx + 1:]]))
                    if tele is not None:
                        tele.queue_depth.set(len(self.queue))
                    return

    def _activate(self, slot: int, r: Request, res, t_first: float, *,
                  t_admit: Optional[float] = None) -> int:
        """The request occupies ``slot`` from its first token on (TTFT is
        the first token computed, even when the stop matcher holds it
        back). ``t_admit`` is the batched admission dispatch's start (the
        end of the queue wait); None on the chunked path, which observed
        the wait at its start. Returns :meth:`_ingest`'s outcome."""
        act = _Active(r)
        st = self._replay.get(r.request_id)
        act.suppress = 0 if st is None else len(st.tokens)
        act.first_token_time = t_first
        self.active[slot] = act
        self.tenants.stats(r.tenant).admitted += 1
        hit = self._prefix_hits.get(r.request_id)
        rec = self.recorder
        if rec is not None:
            rec.record("admit", r.request_id, slot, res.bucket,
                       res.batch_size, res.group,
                       0 if hit is None else hit[1])
        tele = self.telemetry
        if hit is not None and self.engine.paged:
            # the hit mapped the prefix's pages copy-on-write
            self._page_share_hits += 1
            if rec is not None:
                rec.record("page_share", r.request_id,
                           hit[1] // self.engine.engine_cfg.page_size)
            if tele is not None:
                tele.page_share_hits.inc()
        if tele is not None:
            tele.admitted.inc()
            tele.tenant(r.tenant)["admitted"].inc()
            if t_admit is not None:
                tele.admit_batch[res.batch_size].inc()
            if res.bucket in tele.bucket:
                tele.bucket[res.bucket].inc()
        if act.suppress < 1:
            # a replay's re-derived first token is not a first token
            ttft = t_first - r.arrival_time
            self.ttft_stats.add(ttft)
            if self.slo is not None:
                # the queue wait is arrival to the admission dispatch;
                # TTFT adds the prefill on top
                self.slo.observe("ttft", ttft, r.tenant, now=t_first)
                if t_admit is not None:
                    self.slo.observe("queue_wait", t_admit - r.arrival_time,
                                     r.tenant, now=t_first)
            if self._tuner is not None:
                self._tuner.observe_ttft(ttft)
            if self.spans is not None:
                self.spans.mark(r.request_id, spans_mod.PHASE_FIRST_TOKEN)
            if tele is not None:
                tele.ttft.observe(ttft)
        reason = None
        if res.finished:
            reason = FINISH_EOS if res.hit_eos else FINISH_LENGTH
        return self._ingest(slot, act, res.first_token, res.logprob,
                            t_first, device_done=res.finished,
                            device_reason=reason)

    def _start_chunked(self, now: float) -> None:
        """Begin a chunked admission for the queue head when it takes
        the chunked path, none is in progress, and a slot and the pages
        are free."""
        if (self._chunked is not None
                or not self.engine.chunked_prefill_enabled
                or not self._free or not self.queue):
            return
        r = self.queue[0]
        if not self._chunked_only(r) or self._backing_off(r, now):
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
        if self.spans is not None:
            self.spans.mark(r.request_id, spans_mod.PHASE_PREFILL,
                            note=f"slot {slot} (chunked)")
        try:
            ca = self.engine.admit_chunked_start(self._admission_of(r, slot))
        except PagesExhausted:
            self._free.append(slot)
            self.queue.appendleft(r)
            self._note_pages_exhausted(r, self._request_pages_needed(r))
            return
        except Exception as e:
            self._free.append(slot)
            self._recover(self.clock(), cause="admit", detail=str(e),
                          affected=[r], batch_reqs=[r])
            return
        self._chunked = (ca, r)
        self._chunked_fresh = True
        self._chunked_chunks += 1
        if self.slo is not None and r.request_id not in self._replay:
            # the chunked path's queue wait ends here, where its
            # admission dispatch starts
            self.slo.observe("queue_wait", now - r.arrival_time, r.tenant,
                             now=now)
        if self.recorder is not None:
            self.recorder.record("prefill_chunk", r.request_id, 0,
                                 ca.chunks_total)
        if self.telemetry is not None:
            self.telemetry.chunked_chunks.inc()
            self.telemetry.queue_depth.set(len(self.queue))

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
        try:
            res = self.engine.admit_chunked_step(ca)
        except Exception as e:
            self._chunked = None
            self._recover(self.clock(), cause="admit", detail=str(e),
                          affected=[r], batch_reqs=[r])
            return
        if res is None:
            self._chunked_chunks += 1
            if self.recorder is not None:
                self.recorder.record("prefill_chunk", r.request_id,
                                     ca.next_chunk - 1, ca.chunks_total)
            if self.telemetry is not None:
                self.telemetry.chunked_chunks.inc()
            return
        self._chunked = None
        t_first = self.clock()
        if not 0 <= res.first_token < self.engine.cfg.vocab_size:
            self._recover(t_first, cause="invalid_token",
                          detail="invalid first token from chunked "
                          "admission (NaN-poisoned prefill)",
                          affected=[r], batch_reqs=[r])
            return
        self._chunked_admissions += 1
        self._admitted_requests += 1
        self._admit_dispatches += 1
        if self.telemetry is not None:
            self.telemetry.chunked_admissions.inc()
            self.telemetry.admit_dispatches.inc()
        self._activate(ca.slot, r, res, t_first)

    def _constrained_active(self) -> bool:
        return any(a.request.constraint is not None
                   for a in self.active.values())

    # -- the tuner and the SLO monitor -------------------------------------

    def _build_tuner(self, cfg: TunerConfig, engine: Engine) -> Controller:
        """Validate the declared ladders against the engine's and build
        the controller. Device-shaping knobs may only name the engine's
        declared rungs; host knobs are checked for shape only."""
        if cfg.decode_chunk is not None:
            bad = [c for c in cfg.decode_chunk
                   if c not in engine.decode_chunks]
            if bad:
                raise ValueError(
                    f"tuner decode_chunk candidates {bad} are not "
                    f"pre-warmed step variants "
                    f"{engine.decode_chunks} — declare them in "
                    f"EngineConfig.decode_chunks so warmup() compiles "
                    f"them (switching to an unwarmed variant would "
                    f"recompile mid-serve)")
        if cfg.spec_k is not None:
            bad = [k for k in cfg.spec_k
                   if k != 0 and k not in engine.spec_ks]
            if bad:
                raise ValueError(
                    f"tuner spec_k candidates {bad} are not pre-warmed "
                    f"spec variants {engine.spec_ks} — declare them in "
                    f"EngineConfig.spec_ks")
        base = {
            "decode_chunk": engine.engine_cfg.decode_chunk,
            "pipeline_depth": self.pipeline_depth,
            # 0 is the ladder spelling of "unlimited" (None)
            "max_admit_batch": self.max_admit_batch or 0,
            "spec_k": engine.engine_cfg.spec_k,
        }
        tele = self.telemetry
        ctl = Controller(
            cfg, base, recorder=self.recorder,
            on_switch=(None if tele is None
                       else lambda knob: tele.tuner_switches[knob].inc()))
        if tele is not None:
            tele.bind_tuner(ctl.knobs)
        return ctl

    def _exclusion_cause(self) -> Optional[str]:
        """The per-slot exclusions, as a cause: a constrained request is
        active (its vocab mask advances a token at a time), or a slot is
        re-deriving a replayed prefix (a preempted or recompute-resumed
        stream). One spelling shared by the payoff gate's plain-forcing
        (:meth:`_plain_only`) and the tuner's freeze, so the two never
        disagree."""
        for act in self.active.values():
            if act.request.constraint is not None:
                return "constrained"
            if len(act.tokens) < act.suppress:
                return "replay"
        return None

    def _tuner_freeze_cause(self) -> Optional[str]:
        """The hard-freeze condition, re-evaluated each tick: the health
        machine draining, or a per-slot exclusion
        (:meth:`_exclusion_cause`). The watchdog and a rebuild freeze the
        controller where they happen."""
        if self.health.state == HEALTH_DRAINING:
            return "drain"
        return self._exclusion_cause()

    def _sync_tuner(self) -> None:
        """Tick-start controller sync: freeze or thaw from the live
        exclusions, then apply the operating point's HOST knobs (depth,
        admission cap) so this tick's admissions and drain target run
        the point the next dispatch uses."""
        tn = self._tuner
        if tn is None:
            return
        cause = self._tuner_freeze_cause()
        if cause is not None:
            tn.freeze(cause)
        else:
            tn.thaw()
        point = tn.current_point()
        if "pipeline_depth" in point:
            self.pipeline_depth = point["pipeline_depth"]
        if "max_admit_batch" in point:
            self.max_admit_batch = point["max_admit_batch"] or None
        if self.telemetry is not None:
            self.telemetry.tuner_state.set(tn.state())
            for k, v in tn.incumbent.items():
                self.telemetry.tuner_knob[k].set(v)

    def _on_slo_state(self, obj: SLOObjective, old: str,
                      new: str) -> None:
        """Burn-machine transition hook: count alerts into the registry
        (the transition and alert events are the monitor's own)."""
        if self.telemetry is None:
            return
        ch = self.telemetry.slo_children.get(obj.key())
        if ch is not None and new in ch["alerts"]:
            ch["alerts"][new].inc()

    def _sync_slo(self, now: float) -> None:
        """Tick-cadence SLO work: run any due burn-machine evaluation and
        refresh the quantile / burn / state / budget gauges when one ran
        (never per token)."""
        mon = self.slo
        if mon is None:
            return
        if not mon.tick(now) or self.telemetry is None:
            return
        for metric in SLO_METRICS:
            sk = mon.sketch(metric)
            if sk is None or not sk.count:
                continue
            for q, g in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                self.telemetry.slo_quantile[(metric, g)].set(
                    sk.quantile(q))
        for key, m in mon.machines.items():
            ch = self.telemetry.slo_children[key]
            ch["fast"].set(m.fast_burn)
            ch["slow"].set(m.slow_burn)
            ch["state"].set(SLO_STATE_CODE[m.state])
            ch["budget"].set(m.budget_remaining())

    # -- the decode loop ---------------------------------------------------

    def _guard_alarm_count(self) -> float:
        """The recompile guard's alarm count, which the fleet router's
        ``guard_alarm`` breaker reads. The port compiles nothing at serve
        time and has no guard: always 0.0."""
        return 0.0

    def _backoff_wait_s(self) -> Optional[float]:
        """Seconds until the earliest retry-backoff gate opens, when
        waiting for it is the only work left (else None)."""
        if self.active or self._inflight or self._chunked is not None \
                or not self.queue:
            return None
        now = self.clock()
        waits = []
        for r in self.queue:
            st = self._replay.get(r.request_id)
            if st is None or st.not_before <= now:
                return None     # something is admissible now
            waits.append(st.not_before - now)
        return min(waits) + 1e-4

    def _plain_only(self) -> bool:
        """Whether the next chunk must be plain (:meth:`_exclusion_cause`:
        a constrained request is active, or a slot is re-deriving a
        replayed prefix; streams are the same either way, and the replay
        stays on the plain path, as in JAX)."""
        return self._exclusion_cause() is not None

    def _use_spec(self) -> bool:
        """The kind of the next chunk under the payoff gate: its choice
        (at most one speculative probe in flight while it measures);
        plain while :meth:`_plain_only`."""
        g = self._gate
        if g is None or self._plain_only():
            return False
        spec = g.want_spec(sum(1 for e in self._inflight if e[0].spec))
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
        for handle, snapshot, _, _, _ in self._inflight:
            for slot, act in snapshot.items():
                if self.active.get(slot) is act:
                    cols[slot] = cols.get(slot, 0) + handle.ncols
        return any(len(act.tokens) + cols.get(slot, 0)
                   < act.request.max_tokens
                   for slot, act in self.active.items())

    def _tuned_step(self) -> Tuple[Optional[Dict[str, Any]],
                                   Optional[Dict[str, int]]]:
        """The tuner's choice for the next chunk: ``(step_async kwargs,
        the operating point to attribute the chunk to)``; the kwargs are
        None to hold the dispatch (a probe chunk is in flight), the point
        None for a chunk the controller must not observe (a frozen
        dispatch, or a gate-driven speculative one)."""
        tn = self._tuner
        cause = self._exclusion_cause()
        if cause is not None:
            # re-evaluated at dispatch: a constrained or replaying request
            # admitted this tick, after the tick-start sync, must not
            # decode at a probe's chunk width
            tn.freeze(cause)
        point = tn.want_dispatch(len(self._inflight))
        if point is None:
            return None, None
        step_kw: Dict[str, Any] = {}
        if "pipeline_depth" in point:
            # a probe window's candidate depth governs its own chunks
            self.pipeline_depth = point["pipeline_depth"]
        if "decode_chunk" in point:
            step_kw["chunk"] = point["decode_chunk"]
        k = point.get("spec_k", 0)
        if k > 0 and not self._plain_only():
            step_kw["spec"], step_kw["spec_k"] = True, k
        else:
            # gate-owned speculation composes, except in a probe window,
            # whose chunks must measure this point's knobs
            step_kw["spec"] = ("spec_k" not in point and tn.probe is None
                               and self._use_spec())
            if "spec_k" in point:
                # the point the chunk really ran at
                point["spec_k"] = 0
        if tn.frozen is not None or (step_kw["spec"]
                                     and "spec_k" not in tn.knobs):
            point = None
        return step_kw, point

    def _dispatch_chunk(self) -> bool:
        """Dispatch the next decode chunk if it can pay for itself; True
        when one went out. With a tuner the controller picks the operating
        point, or holds the dispatch while a probe chunk is in flight.
        Nothing here waits for the device."""
        if not self._dispatchable():
            return False
        point: Optional[Dict[str, int]] = None
        if self._tuner is not None:
            step_kw, point = self._tuned_step()
            if step_kw is None:
                return False
        else:
            step_kw = {"spec": self._use_spec()}
        t0 = self.clock()
        try:
            handle = self.engine.step_async(**step_kw)
        except Exception as e:      # an error escaping the dispatch
            self._recover(self.clock(), cause="dispatch", detail=str(e),
                          affected=[a.request for _, a in
                                    sorted(self.active.items())])
            return False
        if self.spans is not None:
            self.spans.section_at("engine.dispatch", t0, self.clock())
        self._inflight.append((handle, dict(self.active), t0,
                               len(self._inflight) + 1, point))
        if self.recorder is not None:
            self.recorder.record("dispatch", handle.spec, handle.ncols,
                                 len(self._inflight), len(self.active))
        if self.telemetry is not None:
            self.telemetry.inflight.set(len(self._inflight))
        return True

    def _observe(self, handle, wall: float, live_rows: List[int],
                 t_dispatch: float, now: float) -> None:
        """Per-chunk speculation accounting and the gate's samples:
        tokens per wave over the still-live rows (a live wave always
        emits its first column), and each kind's chunk wall time."""
        g = self._gate
        tele = self.telemetry
        if not handle.spec:
            if g is not None:
                g.observe_plain(wall)
        else:
            self._spec_chunks += 1
            tpw = None
            if live_rows:
                v = handle.valid[live_rows]
                live_waves = int(v[:, ::handle.spec_k + 1].sum())
                emitted = int(v.sum())
                if live_waves:
                    tpw = emitted / live_waves
                    drafted = handle.spec_k * live_waves
                    self._spec_waves += live_waves
                    self._spec_drafted += drafted
                    self._spec_accepted += emitted - live_waves
                    if tele is not None:
                        tele.spec_drafted.inc(drafted)
                        tele.spec_accepted.inc(emitted - live_waves)
            if g is not None:
                g.observe_spec(wall, tpw)
            if self.spans is not None:
                # the verify chunk's host window, dispatch to value
                self.spans.section_at("engine.verify", t_dispatch, now)
        if g is not None:
            st = g.state()
            if st != self._gate_state_seen:
                # a gate transition is a scheduling decision: logged
                # once a flip, not a chunk
                self._gate_state_seen = st
                if self.recorder is not None:
                    self.recorder.record("spec_gate", st, g.accept_ewma,
                                         g.break_even())
            if tele is not None:
                tele.spec_gate.set(st)
                tele.spec_accept_ewma.set(g.accept_ewma)

    def _collect_oldest(self) -> None:
        """Fetch the oldest in-flight chunk and emit its columns for the
        slots still held by the requests they were dispatched for. With a
        tuner the chunk's realized tokens, its dispatch-to-fetch wall and
        its depth at dispatch are the controller's sample (the JAX
        scheduler's measurement convention). A fetch error recovers; a
        chunk whose dispatch-to-fetch wall passed the watchdog's timeout
        is flagged (its tokens are good; it is kept out of every latency
        estimate and the controller's samples); an out-of-vocab token
        anywhere in the batch quarantines the whole chunk before a token
        is unpacked. A chunk that lands ends a rebuild streak, counts
        toward the health machine's recovery and is the journal's commit
        point."""
        handle, snapshot, t_dispatch, depth_at_dispatch, point = \
            self._inflight.popleft()
        t0 = self.clock()
        try:
            tokens, logprobs, finished = handle.fetch()
        except Exception as e:      # an error escaping the fetch
            self._recover(self.clock(), cause="fetch", detail=str(e),
                          affected=[a.request
                                    for s, a in sorted(snapshot.items())
                                    if self.active.get(s) is a])
            return
        now = self.clock()
        tele = self.telemetry
        if tele is not None:
            tele.inflight.set(len(self._inflight))
        live_rows = [s for s, a in snapshot.items()
                     if self.active.get(s) is a]
        if self.spans is not None:
            # the blocking wait for the chunk's value
            self.spans.section_at("engine.fetch", t0, now)
            for s in live_rows:
                self.spans.mark(snapshot[s].request.request_id,
                                spans_mod.PHASE_DECODE)
        chunk_wall = max(now - t_dispatch, 0.0)
        rec = self.recorder
        if rec is not None:
            rec.record("fetch", handle.spec, handle.ncols, chunk_wall,
                       len(live_rows))
        # at depth d the dispatch-to-fetch wall waits behind the d - 1
        # chunks ahead: the gate's sample is the chunk's share
        wall = max(now - max(self._decode_mark, t_dispatch), 0.0)
        hung = chunk_wall > self.resilience.watchdog_timeout_s
        if hung:
            # a hung dispatch: counted as a fault and kept out of the
            # latency estimates (a hang folded into the EWMA would shed
            # deadlined requests against a latency the engine does not
            # have) and of the controller's samples
            self._watchdog_trips += 1
            if rec is not None:
                rec.record("watchdog", chunk_wall)
            if self._tuner is not None:
                self._tuner.freeze("watchdog")
            self.health.record_fault("watchdog")
            self._maybe_dump("watchdog")
            if tele is not None:
                tele.watchdog.inc()
        else:
            self._chunk_ewma = (wall if self._chunk_ewma == 0.0
                                else 0.7 * self._chunk_ewma + 0.3 * wall)
        # the NaN quarantine: an out-of-vocab id anywhere in the batch
        # (a released lane's too: the step wrote the shared cache) drops
        # the chunk before a token is unpacked; only still-live corrupt
        # lanes are charged a retry
        vocab = self.engine.cfg.vocab_size
        if tokens.size and (int(tokens.min()) < 0
                            or int(tokens.max()) >= vocab):
            bad = [act.request for slot, act in sorted(snapshot.items())
                   if self.active.get(slot) is act
                   and bool(((tokens[slot] < 0)
                             | (tokens[slot] >= vocab)).any())]
            self._recover(now, cause="invalid_token",
                          detail="invalid token id in decode batch "
                          "(NaN-poisoned step)", affected=bad)
            return
        self._decode_time += wall
        self._decode_mark = now
        if not hung:
            self._observe(handle, wall, live_rows, t_dispatch, now)
        valid = handle.valid
        n_cols = tokens.shape[1]
        if valid is None:
            per_tok = wall / n_cols
        else:
            # per REAL token: pad lanes are not tokens
            mean_emitted = (valid[live_rows].sum() / len(live_rows)
                            if live_rows else 0.0)
            per_tok = wall / max(float(mean_emitted), 1.0)
        # the tuner's numerator: the tokens this chunk really emitted (pad
        # columns past a finish are not tokens, so an over-wide chunk is
        # charged for its waste)
        chunk_tokens = 0
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
                chunk_tokens += 1
                # the accepted tokens of a speculative wave too: the stop
                # matcher and the automaton see every real column
                if self._ingest(slot, act, tok, float(logprobs[slot, j]),
                                now, device_done=done, device_reason=reason,
                                latency=per_tok) == _RECOVERED:
                    return      # the recovery rebuilt everything
        if self._tuner is not None and point is not None and not hung:
            self._tuner.observe(point, chunk_tokens, chunk_wall,
                                depth_at_dispatch)
        self._consecutive_rebuilds = 0
        self.health.record_progress()
        self._journal_commit()

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
        tele = self.telemetry
        if len(act.tokens) <= act.suppress:
            if tele is not None:
                tele.replayed.inc()
            return
        self._tokens_emitted += 1
        # the WFQ deficit counter charges tokens actually streamed
        self.tenants.on_tokens(act.request.tenant, 1)
        if latency is not None:
            self._decode_tokens += 1
            self.token_latency_stats.add(latency)
            if self.slo is not None:
                self.slo.observe("token_latency", latency,
                                 act.request.tenant)
            if tele is not None:
                tele.token_latency.observe(latency)
        if tele is not None:
            tele.tokens.inc()
            tele.tenant(act.request.tenant)["tokens"].inc()
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
                latency: Optional[float] = None) -> int:
        """Fold ONE generated token into a live request: the stop matcher
        (trimmed emission), the constraint's advance and next mask row,
        the events, and the release when the token finishes the request
        (the device's eos or budget, a stop match, or a completed
        constraint). A host-side finish retires the slot on the engine;
        chunks in flight drop its columns by the snapshot rule. Returns
        ``_LIVE`` / ``_RELEASED``, or ``_RECOVERED`` when that retire
        faulted and the recovery rebuilt the scheduler's state."""
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
            return _LIVE
        if host_stop:
            self._stop_finishes += 1
            if not device_done:
                # the device lane is still live: retire it so later
                # chunks stop spending its budget
                try:
                    self.engine.retire(slot)
                except Exception as e:
                    self._release(slot, reason, now)
                    self._recover(now, cause="retire", detail=str(e),
                                  affected=[])
                    return _RECOVERED
        self._release(slot, reason, now)
        return _RELEASED

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
        rid = request.request_id
        self._prefix_hits.pop(rid, None)
        arrival = (request.arrival_time if request.arrival_time is not None
                   else now)
        comp = self.completions[rid] = Completion(
            rid, list(tokens), reason, ttft=ttft, latency=now - arrival,
            logprobs=list(logprobs))
        if self.recorder is not None:
            self.recorder.record("finish", rid, reason, len(tokens))
        self._journal_finish(request, tokens, logprobs, reason)
        rrec = self._req_records.pop(rid, None)
        if rrec is not None:
            # the replayable record moves to the bounded completed ring
            # with the final client stream
            rrec["status"] = "completed"
            rrec["finish_reason"] = reason
            rrec["emitted"] = list(tokens)
            self._req_done.append(rrec)
        if self.slo is not None:
            self.slo.observe("e2e", comp.latency, request.tenant, now=now)
        if self.telemetry is not None:
            self.telemetry.finished[reason].inc()
            self.telemetry.request_latency.observe(comp.latency)
        if self.spans is not None:
            self.spans.mark(rid, spans_mod.PHASE_RETIRED, note=reason)
        if self.metrics is not None:
            # a completion without a first token has no ttft key (a
            # sentinel would poison every downstream mean)
            row = {"completed": 1.0, "n_tokens": float(len(tokens)),
                   "latency_s": comp.latency}
            if ttft is not None:
                row["ttft_s"] = ttft
            self.metrics.log(self._steps, row)

    # -- failure isolation and recovery --------------------------------------

    def _reset_free(self) -> None:
        """Every slot free, popped in slot order."""
        self._free = list(range(self.engine.slots))[::-1]

    def _recover(self, now: float, *, cause: str, detail: str,
                 affected: Sequence[Request],
                 batch_reqs: Sequence[Request] = ()) -> None:
        """Quarantine, rebuild and replay. The chunks in flight were
        dispatched against the poisoned cache: dropped unfetched. The
        engine rebuilds its slots in place; every interrupted request —
        the live slots, the chunked admission, ``batch_reqs`` from a
        failed admission call — goes back to the queue's front with its
        emitted-prefix snapshot grown to what its client was streamed.
        ``affected`` requests (the fault's blast radius) are charged a
        retry with backoff and an ``error`` event; past ``max_retries``
        they complete with ``error`` (or go to ``on_evict``). More than
        ``max_consecutive_rebuilds`` rebuilds with no healthy chunk
        between fail the engine terminally."""
        tele = self.telemetry
        rec = self.recorder
        rcfg = self.resilience
        if self._tuner is not None:
            # a hard freeze: the dropped chunks go unmeasured, and the
            # replay traffic re-freezes at the next tick
            self._tuner.freeze("rebuild")
        if rec is not None:
            rec.record("fault", cause, detail, len(affected))
        self.health.record_fault(cause)
        if tele is not None and cause in tele.faults:
            tele.faults[cause].inc()
        self._inflight.clear()
        if tele is not None:
            tele.inflight.set(0)
        self._consecutive_rebuilds += 1
        if self._consecutive_rebuilds > rcfg.max_consecutive_rebuilds:
            self.queue.extendleft(reversed(list(batch_reqs)))
            self._fail_all(f"recovery storm ({cause}: {detail})", now)
            return
        # interrupted work: the slots in slot order (admitted earliest),
        # then the failed admission's batch, then a chunked admission
        interrupted: List[Tuple[Request, Optional[_Active]]] = [
            (act.request, act) for _, act in sorted(self.active.items())]
        interrupted += [(r, None) for r in batch_reqs]
        if self._chunked is not None:
            _, cr = self._chunked
            self._chunked = None
            if all(r.request_id != cr.request_id for r, _ in interrupted):
                interrupted.append((cr, None))
        self.active.clear()
        self._reset_free()
        # always rebuild: even a fault detected on the host (invalid
        # tokens) leaves a cache that cannot be trusted
        self.engine.rebuild_slots()
        self._rebuilds += 1
        if rec is not None:
            rec.record("rebuild", cause, max(self.clock() - now, 0.0),
                       self._consecutive_rebuilds)
        if tele is not None:
            tele.rebuilds.inc()
            tele.active_slots.set(0)
        if self.spans is not None:
            self.spans.section_at("engine.rebuild", now, self.clock())
        affected_ids = {r.request_id for r in affected}
        front: List[Request] = []
        for r, act in interrupted:
            rid = r.request_id
            if act is not None:
                # grown, never shrunk: a second fault mid-replay sees a
                # stream shorter than the one already sent
                self._snapshot(act)
            st = self._replay.setdefault(rid, _ReplayState())
            if rec is not None:
                rec.record("replay", rid, len(st.tokens))
            if rid in affected_ids:
                st.attempts += 1
                if st.attempts > rcfg.max_retries:
                    if rec is not None:
                        rec.record("retry_exhausted", rid, st.attempts)
                    self.health.record_fault("retry_exhausted")
                    self._retry_exhausted += 1
                    if self.on_evict is not None:
                        # a fleet hand-off: another replica may serve it
                        # (journaled "evicted", so a restart from this
                        # replica's journal never resubmits it)
                        self._evicted_requests += 1
                        self._replay.pop(rid, None)
                        self._req_records.pop(rid, None)
                        self._journal_finish(r, st.tokens, st.logprobs,
                                             "evicted")
                        self.on_evict(
                            [EvictedRequest(r, list(st.tokens),
                                            list(st.logprobs))],
                            f"retry_exhausted ({cause}: {detail})")
                        continue
                    self._abort(r, FINISH_ERROR, now, act=act,
                                error=f"{cause}: {detail}; "
                                f"{rcfg.max_retries} retries exhausted")
                    continue
                st.not_before = now + rcfg.backoff_s(st.attempts)
                self._retries += 1
                if rec is not None:
                    rec.record("retry", rid, st.attempts)
                if tele is not None:
                    tele.retries.inc()
                self.events.append(StreamEvent(
                    rid, None, False, None,
                    error=f"{cause}: {detail}; retry "
                    f"{st.attempts}/{rcfg.max_retries}"))
                if self.spans is not None:
                    self.spans.mark(rid, spans_mod.PHASE_ERROR, note=cause)
            front.append(r)
        self.queue.extendleft(reversed(front))
        if tele is not None:
            tele.queue_depth.set(len(self.queue))
        # the bundle lands after the bracket: it carries the fault and
        # its rebuild, replay and retry events
        self._maybe_dump(f"fault-{cause}")

    def _fail_all(self, cause: str, now: float) -> None:
        """Terminal: every queued, active, chunked and parked request ends
        with an ``error`` outcome (its stream so far kept) and the health
        machine goes ``failed``; the process survives. The terminal
        bundle is dumped first, while the state it explains exists. With
        an :attr:`on_evict` hook the work is handed over instead."""
        if self.recorder is not None:
            self.recorder.record("failed", cause)
        self._maybe_dump("failed")
        self.health.fail(cause)
        if self.on_evict is not None:
            self._evict_all(cause)
            return
        for slot, act in sorted(self.active.items()):
            self._abort(act.request, FINISH_ERROR, now, act=act,
                        error=cause)
            self.engine.free_slot(slot)
        if self._chunked is not None:
            ca, cr = self._chunked
            self._chunked = None
            self.engine.free_slot(ca.slot)
            self._abort(cr, FINISH_ERROR, now, error=cause)
        self.active.clear()
        self._reset_free()
        for r in self.queue:
            self._abort(r, FINISH_ERROR, now, error=cause)
        self.queue.clear()
        for rid, pk in sorted(self._parked.items()):
            self.engine.drop_parked(rid)
            self._abort(pk.act.request, FINISH_ERROR, now, act=pk.act,
                        error=cause)
        self._parked.clear()
        self._resume_q.clear()
        self._replay.clear()
        self._inflight.clear()
        if self.telemetry is not None:
            self.telemetry.queue_depth.set(0)
            self.telemetry.active_slots.set(0)
            self.telemetry.inflight.set(0)

    def eject_all(self, cause: str) -> None:
        """Router-facing: hand every queued, active and parked request to
        the :attr:`on_evict` hook with its emitted prefix and clear this
        scheduler's work (a circuit breaker's eviction; the caller
        rebuilds the engine's slots next, since chunks in flight are
        dropped unfetched)."""
        if self.on_evict is None:
            raise ValueError(
                "eject_all needs an on_evict hook — without one the "
                "evicted requests would simply vanish")
        self._evict_all(cause)

    def _evict_all(self, cause: str) -> None:
        """Hand every interrupted request (the slots first, then a
        chunked admission, the queue and the parked conversations) to
        :attr:`on_evict` with the longest stream its client saw, with no
        error event and no completion: the router owns them now. Each is
        journaled finished ("evicted") and committed before the hand-off,
        so a restart from this replica's journal never resubmits work the
        fleet moved."""
        evicted: List[EvictedRequest] = []

        def take(request: Request, act: Optional[_Active]) -> None:
            streamed = ((list(act.tokens), list(act.logprobs))
                        if act is not None else ([], []))
            tokens, lps = self._longest(request, *streamed)
            tokens, lps = list(tokens), list(lps)
            self._journal_finish(request, tokens, lps, "evicted")
            self._req_records.pop(request.request_id, None)
            self._prefix_hits.pop(request.request_id, None)
            evicted.append(EvictedRequest(request, tokens, lps))

        for slot, act in sorted(self.active.items()):
            take(act.request, act)
            self.engine.free_slot(slot)
        if self._chunked is not None:
            ca, cr = self._chunked
            self._chunked = None
            self.engine.free_slot(ca.slot)
            take(cr, None)
        for r in self.queue:
            take(r, None)
        for rid, pk in sorted(self._parked.items()):
            self.engine.drop_parked(rid)
            take(pk.act.request, pk.act)
        self._parked.clear()
        self._resume_q.clear()
        self.active.clear()
        self.queue.clear()
        self._reset_free()
        self._replay.clear()
        self._inflight.clear()
        self._evicted_requests += len(evicted)
        if self.telemetry is not None:
            self.telemetry.queue_depth.set(0)
            self.telemetry.active_slots.set(0)
            self.telemetry.inflight.set(0)
        self._journal_commit()
        self.on_evict(evicted, cause)

    # -- the durable request journal (serving.journal) ------------------------

    def _jlog(self, kind: str, **fields) -> None:
        """Append one journal record (a no-op without a journal) and log
        it in the flight recorder."""
        j = self.journal
        if j is None:
            return
        rot = j.rotations
        seq = j.append(kind, **fields)
        rec = self.recorder
        if rec is not None:
            rec.record("journal_append", seq, kind, j.last_append_bytes)
            if j.rotations != rot and j.last_sealed is not None:
                rec.record("journal_rotate", *j.last_sealed)

    def _journal_submit(self, request: Request, now: float) -> None:
        """Journal an accepted request: its replayable record, the
        absolute deadline turned into the budget remaining (a monotonic
        clock does not survive a restart) and the adapter's name (the
        stable key across recoveries)."""
        if self.journal is None:
            return
        row = dict(self._req_records[request.request_id])
        row.pop("arrival", None)
        deadline = row.pop("deadline", None)
        row["deadline_remaining"] = (
            None if deadline is None else max(deadline - now, 0.0))
        if row.get("adapter"):
            meta = self.engine._adapter_meta.get(int(row["adapter"]), {})
            row["adapter_name"] = meta.get("name")
        self._jlog("submit", **row)
        self._journal_len[request.request_id] = 0

    def _journal_extend(self, rid: str, tokens, logprobs) -> None:
        """Journal the growth of one stream since its last extend, at an
        absolute offset (replaying a record twice changes nothing).
        Requests the journal never saw are skipped."""
        jl = self._journal_len.get(rid)
        if jl is None or len(tokens) <= jl:
            return
        self._jlog("extend", request_id=rid, start=jl,
                   tokens=[int(t) for t in tokens[jl:]],
                   logprobs=[float(x) for x in logprobs[jl:]])
        self._journal_len[rid] = len(tokens)

    def _journal_commit(self) -> None:
        """The fetch-boundary durability point: extend every live stream
        (the slots and the snapshots of parked and preempted ones), sync
        by the journal's policy, let compaction run, and mirror the
        journal's counters into the registry by delta."""
        j = self.journal
        if j is None:
            return
        for act in self.active.values():
            self._journal_extend(act.request.request_id, act.tokens,
                                 act.logprobs)
        for rid, st in self._replay.items():
            self._journal_extend(rid, st.tokens, st.logprobs)
        j.commit()
        j.maybe_compact()
        tele = self.telemetry
        if tele is not None:
            seen = self._j_seen
            for attr, handle in (
                    ("appends", tele.journal_appends),
                    ("rotations", tele.journal_rotations),
                    ("compactions", tele.journal_compactions)):
                d = getattr(j, attr) - seen[attr]
                if d:
                    handle.inc(d)
                    seen[attr] = getattr(j, attr)
            ds = j.fsync_s - seen["fsync_s"]
            if ds > 0:
                tele.journal_fsync.inc(ds)
                seen["fsync_s"] = j.fsync_s
            tele.journal_bytes.set(j.bytes_on_disk())
            tele.journal_lag.set(j.lag_bytes)

    def _journal_finish(self, request: Request, tokens, logprobs,
                        reason: str) -> None:
        """Journal a terminal outcome: the final extend, then the finish
        record, so recovery never resubmits finished (or evicted)
        work."""
        if self.journal is None:
            return
        rid = request.request_id
        if rid not in self._journal_len:
            return
        self._journal_extend(rid, tokens, logprobs or [])
        self._journal_len.pop(rid, None)
        self._jlog("finish", request_id=rid, reason=reason)

    def _on_health_transition(self, old: str, new: str,
                              cause: Optional[str]) -> None:
        if self.recorder is not None:
            self.recorder.record("health", old, new, cause)

    # -- flight recorder and post-mortem bundles -----------------------------

    def _record_request(self, request: Request, now: float) -> None:
        """Start the replayable record of one accepted request (the
        bundle's ``requests.jsonl`` row; the emitted stream attaches at
        completion or dump time). Kept with or without a recorder."""
        sp = request.sampling
        self._req_records[request.request_id] = {
            "order": self._submit_seq,
            "request_id": request.request_id,
            "prompt": [int(t) for t in request.prompt],
            "max_tokens": request.max_tokens,
            "temperature": sp.temperature,
            "top_k": sp.top_k,
            "top_p": sp.top_p,
            "seed": sp.seed,
            "eos_token_id": request.eos_token_id,
            "stop": ([[int(t) for t in s] for s in request.stop]
                     if request.stop else None),
            "constrained": request.constraint is not None,
            "deadline": request.deadline,
            "arrival": now,
            "tenant": request.tenant,
            "adapter": request.adapter,
        }
        self._submit_seq += 1

    def _maybe_dump(self, cause: str) -> None:
        """Auto-dump gate: one bundle a trigger wave (a tick or a
        submit), at most ``max_auto_bundles``. A disk error is swallowed:
        losing a bundle must not take the serving loop down."""
        if self.bundle_dir is None \
                or self._auto_bundles >= self.max_auto_bundles \
                or self._last_dump_token == self._dump_token:
            return
        self._last_dump_token = self._dump_token
        self._auto_bundles += 1
        try:
            self.dump_bundle(cause)
        except OSError:
            pass

    def dump_bundle(self, cause: str = "manual",
                    bundle_dir: Optional[str] = None) -> str:
        """Write a self-contained post-mortem bundle directory, in the
        JAX package's layout, and return its path: the manifest (cause,
        ``summary()``, versions, ``bundle_meta``), the flight recorder's
        events (``events.jsonl``), the engine and scheduler configuration
        (``config.json``: everything
        :func:`apex_tpu_torch.telemetry.replay.replay_bundle` needs to
        rebuild the run), the per-request records (``requests.jsonl``),
        and the registry snapshot and spans when those sinks exist.
        Atomic: a reader sees the whole bundle or none. Safe to call from
        another thread (``/debug/bundle``): the payload walk snapshots the
        mutable maps and retries if the loop mutates one mid-walk."""
        base = bundle_dir or self.bundle_dir
        if base is None:
            raise ValueError(
                "no bundle directory: pass bundle_dir here or "
                "Scheduler(bundle_dir=...)")
        for attempt in range(3):
            try:
                files = self._bundle_payload(cause)
                break
            except RuntimeError:  # a map mutated during iteration
                if attempt == 2:
                    raise
        slug = "".join(c if c.isalnum() else "-" for c in cause)[:40]
        while True:
            path = os.path.join(
                base, f"bundle-{self._bundle_counter:04d}-{slug}")
            self._bundle_counter += 1
            if not os.path.exists(path):
                break
        path = flightrec_mod.write_bundle(path, files)
        self.bundles_written.append(path)
        if self.recorder is not None:
            self.recorder.record("bundle", cause, os.path.basename(path))
        return path

    def _bundle_payload(self, cause: str) -> Dict[str, object]:
        engine = self.engine
        rec = self.recorder
        # completed records first, then the live ones with the stream the
        # client has so far (the longer of the slot's and the snapshot's)
        requests = [dict(r) for r in self._req_done.values()]
        by_id = {a.request.request_id: a for a in list(self.active.values())}
        parked = {pk.act.request.request_id: pk.act
                  for pk in list(self._parked.values())}
        for rid, row in list(self._req_records.items()):
            row = dict(row)
            act = by_id.get(rid) or parked.get(rid)
            toks = list(act.tokens) if act is not None else []
            st = self._replay.get(rid)
            if st is not None and len(st.tokens) > len(toks):
                toks = list(st.tokens)
            row["emitted"] = toks
            row["status"] = ("active" if rid in by_id
                             else "parked" if rid in parked else "queued")
            requests.append(row)
        requests.sort(key=lambda r: r["order"])
        manifest: Dict[str, object] = {
            "bundle_version": 1,
            "cause": cause,
            "wall_time": time.time(),
            "clock": self.clock(),
            "health": {"state": self.health.state,
                       "last_cause": self.health.last_cause},
            "summary": self.summary(),
            "flightrec": rec.summary() if rec is not None else None,
            "versions": flightrec_mod.versions(),
            "meta": self.bundle_meta,
        }
        tc = self._tenancy_cfg
        config: Dict[str, object] = {
            "engine": engine.describe(),
            "scheduler": {
                "max_queue": self.max_queue,
                "pipeline_depth": self._cfg_pipeline_depth,
                "max_admit_batch": self._cfg_max_admit_batch,
                "resilience": dataclasses.asdict(self.resilience),
                "spec_gate": (dataclasses.asdict(self._gate.cfg)
                              if self._gate is not None else None),
                # the tuner's ladders and policy and its base point:
                # everything replay_decisions needs to re-run it
                "tuner": (dataclasses.asdict(self._tuner.cfg)
                          if self._tuner is not None else None),
                "tuner_base": (dict(self._tuner.base)
                               if self._tuner is not None else None),
                "tenancy": (None if tc is None else {
                    "weights": dict(tc.weights),
                    "default_weight": tc.default_weight,
                    "rates": dict(tc.rates),
                    "default_rate": tc.default_rate,
                    "burst_s": tc.burst_s,
                    "aging_per_s": tc.aging_per_s,
                }),
                # objectives and burn policy: everything replay_slo needs
                "slo": (self._slo_cfg.to_dict()
                        if self._slo_cfg is not None else None),
            },
        }
        files: Dict[str, object] = {
            "manifest.json": manifest,
            "config.json": config,
            "events.jsonl": (rec.to_dicts(rec.events())
                             if rec is not None else []),
            "requests.jsonl": requests,
        }
        if self._registry is not None:
            files["registry.json"] = self._registry.to_dict()
        if self.spans is not None:
            files["spans_trace.json"] = self.spans.to_chrome_trace()
            # raw rows keep absolute scheduler-clock times (the Chrome
            # trace rebases to its own t0), so the report merges spans
            # and flight events on one axis
            raw = []
            for e in self.spans.events():
                if e[0] == spans_mod._MARK:
                    raw.append({"kind": "mark", "t": e[1],
                                "request_id": e[2], "phase": e[3],
                                "note": e[4]})
                else:
                    raw.append({"kind": "section", "t": e[1],
                                "name": e[2], "t_end": e[3]})
            files["spans_raw.jsonl"] = raw
        plan = engine.fault_plan
        if plan is not None:
            files["fault_plan.json"] = {
                "specs": [dataclasses.asdict(s) for s in plan.specs],
                "injected": [dataclasses.asdict(s) for s in plan.injected],
                "counts": plan.counts(),
            }
        return files

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
        state and its decisions (a tuner owning ``spec_k``: the counts
        only). ``bundles_written`` counts post-mortem bundles; a tuner
        adds ``tuner_state``, ``tuner_probes``, ``tuner_switches`` and the
        incumbent ``tuner_<knob>`` values; an SLO monitor its
        sketch-backed percentiles and alert roll-up
        (:meth:`SLOMonitor.summary`) and ``predicted_ttft_s``. The
        resilience counters are always there (``retries``,
        ``retry_exhausted``, ``rebuilds``, ``shed``, ``watchdog_trips``,
        ``evicted_requests``, ``health_state``); a journal adds its
        ``journal_*`` stats and ``journal_recovered_requests``."""
        out = {
            "requests_completed": float(len(self.completions)),
            "tokens_emitted": float(self._tokens_emitted),
            "steps": float(self._steps),
            "admitted_requests": float(self._admitted_requests),
            "admit_dispatches": float(self._admit_dispatches),
            "pipeline_depth": float(self.pipeline_depth),
            "retries": float(self._retries),
            "retry_exhausted": float(self._retry_exhausted),
            "rebuilds": float(self._rebuilds),
            "shed": float(self._shed),
            "watchdog_trips": float(self._watchdog_trips),
            "evicted_requests": float(self._evicted_requests),
            "health_state": float(self.health.code),
            "decode_steps": float(self.engine.decode_steps_taken),
            "cache_bytes": float(self.engine.cache_bytes()),
            "prefix_hits": float(self._prefix_hit_count),
            "prefix_misses": float(self._prefix_miss_count),
            "tenants_seen": float(len(self.tenants.tenants_seen)),
            "tenant_throttled": float(self._throttled),
            "stop_finishes": float(self._stop_finishes),
            "mask_uploads": float(self.engine.mask_uploads),
            "bundles_written": float(len(self.bundles_written)),
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
        if self.journal is not None:
            for k, v in self.journal.stats().items():
                out[f"journal_{k}"] = v
            out["journal_recovered_requests"] = float(
                self._journal_recovered)
        g = self._gate
        tn = self._tuner
        if g is not None or (tn is not None and "spec_k" in tn.knobs):
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
        if g is not None:
            out["spec_gate_state"] = g.state()
            out["spec_acceptance_ewma"] = g.accept_ewma
            out["spec_break_even"] = g.break_even()
            out["spec_gate_spec_decisions"] = float(
                self._gate_spec_decisions)
            out["spec_gate_plain_decisions"] = float(
                self._gate_plain_decisions)
        if tn is not None:
            out["tuner_state"] = tn.state()
            out["tuner_probes"] = float(tn.probes_total)
            out["tuner_switches"] = float(sum(tn.switch_counts.values()))
            for k, v in tn.incumbent.items():
                out[f"tuner_{k}"] = float(v)
        for name, stats in (("ttft", self.ttft_stats),
                            ("token_latency", self.token_latency_stats)):
            for k, v in stats.summary().items():
                out[f"{name}_{k}"] = v
        if self.slo is not None:
            out.update(self.slo.summary())
            out["predicted_ttft_s"] = self.predicted_ttft_s()
        return out
