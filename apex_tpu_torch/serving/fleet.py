"""Fleet router — N engine replicas as one unit of reliability.

The port's copy of ``apex_tpu/serving/fleet.py``. :class:`Router` lifts
the scheduler's detect → isolate → recover loop to fleet level over N
``(Engine, Scheduler)`` replicas in one process, on one device (each
replica is its own failure domain; replicas may share the parameters):

- **Health-weighted routing** — ``submit`` places each request on the
  best replica: ``ok`` before ``degraded``, never ``draining`` /
  ``failed`` / breaker-open, then by estimated wait (queue depth x the
  replica's chunk-latency EWMA). A per-replica circuit breaker driven by
  the watchdog and retry-exhaustion counters takes a misbehaving replica
  out of rotation, fails its work over, rebuilds it and re-admits it
  after a cooldown. (The ``guard_alarm`` threshold is kept for the
  configuration's sake: the port compiles nothing at serve time and has
  no recompile guard, so that breaker never trips.)
- **Deterministic failover** — a replica that fails terminally (or gives
  up a request after bounded retries) hands its interrupted work to the
  router through the scheduler's ``on_evict`` hook, each request
  carrying the emitted-prefix snapshot of everything its client saw. The
  router resubmits it on a healthy replica with ``submit(request,
  replay_prefix=...)``: generation re-derives the prefix and suppresses
  the duplicates, so client streams continue across a replica death with
  no token duplicated or lost.
- **Drain for a rolling restart** — :meth:`Router.drain` takes a replica
  out of rotation, serves its remaining work to completion (the rest of
  the fleet keeps serving), brackets ``Scheduler.drain()``, rebuilds the
  slots (``rebuild_slots``, or a fresh factory replica) and re-admits
  it, shedding nothing. :meth:`Router.restart` replaces a terminally
  failed replica from the factory.
- **Fleet overload and observability** — a fleet-wide all-or-nothing
  ``QueueFull`` whose retry-after is the best replica's
  ``overload_hint_s()``; an aggregated ``/healthz`` that answers 200
  while any replica is ok or degraded; per-replica-labelled metrics
  (``serving_fleet_*``); ``route`` / ``failover`` / ``drain`` /
  ``restart`` flight-recorder events; and a fleet incident manifest
  written next to (and linking) the failed replica's own post-mortem
  bundles.

The router duck-types the scheduler surface the API front end drives
(``submit`` / ``step`` / ``pop_events`` / ``completions`` / ``idle`` /
``can_accept`` / ``overload_hint_s`` / ``health`` / ``engine``), so
``ApiServer(router, ...)`` serves a fleet: 429s then mean every routable
replica is saturated, 503s that no replica is left standing.

Chaos at fleet scale: build each replica's engine with one plan of a
:class:`~apex_tpu_torch.serving.resilience.FleetFaultPlan` (seeded
``.random``, or ``.kill(i, n)`` for a kill-one-replica-mid-burst drill)
and the whole soak replays exactly.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

from apex_tpu_torch.serving.request import FINISH_ERROR, Completion, Request, \
    StreamEvent
from apex_tpu_torch.serving.resilience import (
    HEALTH_DEGRADED,
    HEALTH_FAILED,
    HEALTH_OK,
    HEALTH_STATES,
    EngineFailed,
)
from apex_tpu_torch.serving.scheduler import (
    EvictedRequest,
    QueueFull,
    Scheduler,
)
from apex_tpu_torch.telemetry import flightrec as flightrec_mod

#: router-level replica states (orthogonal to the per-replica health
#: machine: health says how the ENGINE feels, this says what the
#: ROUTER does with it)
REPLICA_LIVE = "live"          # in rotation
REPLICA_DRAINING = "draining"  # rolling restart: no new routes
REPLICA_COOLING = "cooling"    # breaker open: evicted, counting down
REPLICA_FAILED = "failed"      # terminal; restart(i) replaces it

REPLICA_STATES = (REPLICA_LIVE, REPLICA_DRAINING, REPLICA_COOLING,
                  REPLICA_FAILED)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router policy knobs. The circuit breaker reads the existing
    per-replica resilience counters as DELTAS since it last closed:
    crossing any threshold opens it — the replica's interrupted work
    fails over, its buffers rebuild, and it rejoins rotation after
    ``breaker_cooldown_steps`` router ticks (tick-based, not
    time-based, so chaos soaks with injected clocks stay
    deterministic). ``max_failovers`` bounds how many times one
    request may be failed over before the router completes it with an
    ``error`` outcome (a request that kills every replica it touches
    must not ping-pong forever).

    ``breaker_half_open`` softens the trip: instead of discarding the
    replica's in-flight chunks unfetched, the router lets them finish
    (collects them host-side — no new routes either way) BEFORE
    evicting, so every failed-over snapshot carries the longest
    stream its client saw and fewer tokens re-derive on the healthy
    replicas. Off by default: a watchdog-tripped replica's chunks may
    be the very thing hanging, and the hard trip must stay the safe
    floor."""

    breaker_watchdog_trips: int = 2
    breaker_guard_alarms: int = 1
    breaker_retry_exhausted: int = 2
    breaker_cooldown_steps: int = 50
    breaker_half_open: bool = False
    max_failovers: int = 2
    drain_max_steps: int = 100_000

    def __post_init__(self):
        for f in ("breaker_watchdog_trips", "breaker_guard_alarms",
                  "breaker_retry_exhausted"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1 (the breaker must "
                                 f"tolerate zero signals)")
        if self.breaker_cooldown_steps < 1:
            raise ValueError("breaker_cooldown_steps must be >= 1")
        if self.max_failovers < 1:
            raise ValueError("max_failovers must be >= 1")


class _Pending:
    """One evicted request awaiting placement: the request, the
    emitted prefix its client already saw, the replica it came from
    (excluded from re-placement while any other candidate exists), and
    how many times it has failed over already."""

    __slots__ = ("request", "tokens", "logprobs", "source", "failovers")

    def __init__(self, request: Request, tokens: List[int],
                 logprobs: List[float], source: int, failovers: int):
        self.request = request
        self.tokens = tokens
        self.logprobs = logprobs
        self.source = source
        self.failovers = failovers


class _Replica:
    """Router-side bookkeeping for one ``(Engine, Scheduler)`` pair."""

    __slots__ = ("index", "sched", "state", "cooldown", "routed",
                 "base_watchdog", "base_guard", "base_exhausted",
                 "evicted_ids", "evict_cause")

    def __init__(self, index: int, sched: Scheduler):
        self.index = index
        self.sched = sched
        self.state = REPLICA_LIVE
        self.cooldown = 0
        self.routed = 0
        #: ids + cause of the most recent eviction wave — the incident
        #: manifest's evidence
        self.evicted_ids: List[str] = []
        self.evict_cause: Optional[str] = None
        self.reset_breaker()

    def reset_breaker(self) -> None:
        """Re-baseline the breaker deltas at the current counters —
        called when the breaker closes (cooldown over, drain cycle
        done) so old incidents never re-trip it."""
        s = self.sched
        self.base_watchdog = s._watchdog_trips
        self.base_exhausted = s._retry_exhausted
        self.base_guard = s._guard_alarm_count()

    def breaker_cause(self, cfg: FleetConfig) -> Optional[str]:
        """Which breaker threshold (if any) the counter deltas since
        the last close have crossed."""
        s = self.sched
        if s._watchdog_trips - self.base_watchdog \
                >= cfg.breaker_watchdog_trips:
            return "watchdog"
        if s._guard_alarm_count() - self.base_guard \
                >= cfg.breaker_guard_alarms:
            return "guard_alarm"
        if s._retry_exhausted - self.base_exhausted \
                >= cfg.breaker_retry_exhausted:
            return "retry_exhausted"
        return None

    @property
    def health_state(self) -> str:
        return self.sched.health.state

    def routable(self) -> bool:
        return (self.state == REPLICA_LIVE
                and self.health_state in (HEALTH_OK, HEALTH_DEGRADED))


class _FleetMetrics:
    """Pre-bound fleet-registry handles (one labels() resolution here,
    none on the routing hot path) — the per-replica-labeled surface
    dashboards watch a fleet through."""

    def __init__(self, registry, n: int):
        registry.gauge(
            "serving_fleet_replicas", "engine replicas owned by the "
            "router (any state)").set(n)
        self.routable = registry.gauge(
            "serving_fleet_replicas_routable",
            "replicas currently accepting routed submits")
        h = registry.gauge(
            "serving_fleet_replica_health",
            "per-replica health: 0=ok 1=degraded 2=draining 3=failed",
            labels=("replica",))
        self.health = {i: h.labels(replica=str(i)) for i in range(n)}
        b = registry.gauge(
            "serving_fleet_breaker_open",
            "per-replica circuit breaker: 1 while the replica is out "
            "of rotation (cooling/draining/failed), 0 in rotation",
            labels=("replica",))
        self.breaker = {i: b.labels(replica=str(i)) for i in range(n)}
        r = registry.counter(
            "serving_fleet_routed_total",
            "requests placed on a replica by the router",
            labels=("replica",))
        self.routed = {i: r.labels(replica=str(i)) for i in range(n)}
        p = registry.gauge(
            "serving_fleet_predicted_ttft_seconds",
            "per-replica predicted time-to-first-token for the NEXT "
            "submit (queue depth x chunk-latency EWMA + sketch-backed "
            "admission overhead) — the SLO-aware routing signal "
            "precursor",
            labels=("replica",))
        self.predicted_ttft = {i: p.labels(replica=str(i))
                               for i in range(n)}
        self.failovers = registry.counter(
            "serving_fleet_failovers_total",
            "eviction waves failed over (replica deaths, breaker "
            "trips, per-request retry exhaustion hand-offs)")
        self.failed_over = registry.counter(
            "serving_fleet_failed_over_requests_total",
            "requests resubmitted to another replica with their "
            "emitted-prefix snapshot")
        self.drains = registry.counter(
            "serving_fleet_drains_total",
            "drain -> rebuild -> re-admit rolling-restart cycles "
            "completed")
        self.queue_full = registry.counter(
            "serving_fleet_queue_full_total",
            "fleet-wide submit rejections (no replica could accept)")


class FleetHealth:
    """The fleet-aggregated health view: the best replica wins. 200
    while ANY replica is ``ok`` or ``degraded`` (the fleet is
    serving), 503 only when none is — a load balancer in front of the
    router keeps sending traffic as long as one replica can take it.
    Duck-types the per-engine ``HealthMonitor`` surface the API server
    and ``MetricsServer(health=...)`` read (``state`` / ``code`` /
    ``healthz``)."""

    def __init__(self, router: "Router"):
        self._router = router

    @property
    def state(self) -> str:
        states = [r.health_state for r in self._router.replicas]
        for s in (HEALTH_OK, HEALTH_DEGRADED):
            if s in states:
                return s
        return ("draining" if "draining" in states else HEALTH_FAILED)

    @property
    def code(self) -> int:
        return HEALTH_STATES.index(self.state)

    @property
    def last_cause(self) -> Optional[str]:
        causes = [r.sched.health.last_cause
                  for r in self._router.replicas]
        return next((c for c in causes if c), None)

    def healthz(self) -> Tuple[int, str]:
        state = self.state
        status = 200 if state in (HEALTH_OK, HEALTH_DEGRADED) else 503
        per = " ".join(f"r{r.index}={r.health_state}"
                       for r in self._router.replicas)
        return status, f"{state} ({per})\n"


class Router:
    """Own N replicas; route, fail over, drain, restart.

    >>> scheds = [Scheduler(Engine(cfg, params, ecfg)) for _ in range(2)]
    >>> with Router(scheds) as router:
    ...     router.submit(Request("r0", prompt, max_tokens=16))
    ...     router.run_until_idle()
    ...     router.completions["r0"].tokens

    Every scheduler must be exclusively owned (the router installs its
    ``on_evict`` hook) over an engine of IDENTICAL model/engine config —
    any replica must be able to serve any request, and failover
    determinism rests on identical programs.
    ``factory(i) -> Scheduler`` (optional) builds replacement replicas
    for :meth:`restart` and ``drain(i, replace=True)``.

    ``registry`` receives the fleet-level metrics (give each replica
    its OWN registry if you also want per-replica scrapes — the
    unlabeled per-engine names would collide in a shared one);
    ``recorder`` logs ``route``/``failover``/``drain``/``restart``
    decisions; ``bundle_dir`` is where fleet incident manifests land,
    next to (and linking) the replicas' own post-mortem bundles.

    ONE thread drives the router (``step``/``run_until_idle``/
    ``drain``/``restart``), exactly like a scheduler — the ApiServer's
    driver thread, or your loop, never both at once.
    """

    def __init__(self, schedulers: Sequence[Scheduler], *,
                 factory: Optional[Callable[[int], Scheduler]] = None,
                 config: Optional[FleetConfig] = None,
                 registry=None, recorder=None,
                 bundle_dir: Optional[str] = None,
                 tenancy=None,
                 clock: Callable[[], float] = time.monotonic):
        scheds = list(schedulers)
        if not scheds:
            raise ValueError("a fleet needs at least one replica")
        if len({id(s) for s in scheds}) != len(scheds) or \
                len({id(s.engine) for s in scheds}) != len(scheds):
            raise ValueError(
                "replicas must be distinct (Engine, Scheduler) pairs — "
                "two routes into one engine would double-admit")
        for s in scheds:
            self._check_compatible(scheds[0], s)
            if s.on_evict is not None:
                raise ValueError(
                    "scheduler already has an on_evict owner — a "
                    "replica belongs to exactly one router")
            if s.health.state == HEALTH_FAILED:
                raise ValueError(
                    "cannot adopt a terminally failed scheduler")
        self.cfg = config or FleetConfig()
        self.factory = factory
        self.clock = clock
        self.recorder = recorder
        self.bundle_dir = bundle_dir
        #: fleet incident manifests written so far (paths, oldest
        #: first) — one per terminal replica failure
        self.incidents_written: List[str] = []
        self._incident_counter = 0
        self.telemetry = (None if registry is None
                          else _FleetMetrics(registry, len(scheds)))
        self._registry = registry
        self.replicas: List[_Replica] = []
        for i, s in enumerate(scheds):
            rep = _Replica(i, s)
            s.on_evict = self._evict_hook(rep)
            self.replicas.append(rep)
        #: merged client-facing surfaces — the router harvests every
        #: replica's events/completions each step, so these are the
        #: ONE place callers read (replica-level maps stay empty)
        self.events: Deque[StreamEvent] = collections.deque()
        self.completions: Dict[str, Completion] = {}
        self.health = FleetHealth(self)
        self._pending: Deque[_Pending] = collections.deque()
        self._failover_counts: Dict[str, int] = {}
        #: tenant → last replica index that served it (the affinity
        #: HINT: a warm-cache tiebreak in routing, never a constraint)
        self._tenant_affinity: Dict[str, int] = {}
        #: fleet-level tenant rate limiting (serving.tenancy): a
        #: tenant's token budget is a FLEET property — per-replica
        #: buckets would multiply the effective cap by the replica
        #: count and 429 one replica while others sat full — so rate
        #: limits belong HERE, at ingress, with ONE bucket per tenant.
        #: Pass a TenancyConfig with `rates` to the Router and leave
        #: the replica schedulers' tenancy rate-free (their WFQ
        #: weights still apply per replica). Failover re-placements
        #: bypass it the same way the scheduler-level bucket does —
        #: the original submit already charged the budget.
        self._tenant_book = None
        if tenancy is not None:
            from apex_tpu_torch.serving.tenancy import TenantBook

            self._tenant_book = TenantBook(tenancy, clock)
        #: fleet-level adapter registrations, replayed onto factory
        #: replacements so ids mean the same weights fleet-wide
        self._adapter_registrations: List[Dict[str, Any]] = []
        self._steps = 0
        self._routed = 0
        self._failover_waves = 0
        self._failed_over_requests = 0
        self._aborted_requests = 0
        self._drains = 0
        self._restarts = 0
        self._queue_full = 0
        self._update_gauges()

    @staticmethod
    def _check_compatible(a: Scheduler, b: Scheduler) -> None:
        ea, eb = a.engine, b.engine
        same = (ea.cfg.vocab_size == eb.cfg.vocab_size
                and ea.engine_cfg.max_prompt_len
                == eb.engine_cfg.max_prompt_len
                and ea.engine_cfg.max_seq_len == eb.engine_cfg.max_seq_len
                and ea.engine_cfg.decode_chunk
                == eb.engine_cfg.decode_chunk
                and ea.engine_cfg.spec_k == eb.engine_cfg.spec_k
                and ea.engine_cfg.adapter_slots
                == eb.engine_cfg.adapter_slots
                and ea.engine_cfg.adapter_rank
                == eb.engine_cfg.adapter_rank
                and ea.engine_cfg.adapter_alpha
                == eb.engine_cfg.adapter_alpha)
        if not same:
            raise ValueError(
                "replica engine configs differ (vocab / prompt room / "
                "seq len / decode_chunk / spec_k / adapter pool) — "
                "any replica must be able to serve any request, and "
                "failover streams must be bit-identical across "
                "replicas")

    # -- intake -------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Route ``request`` to the best replica (health tier, then
        estimated wait, then index — deterministic). Raises
        :class:`~apex_tpu.serving.scheduler.QueueFull` when NO replica
        can take it right now (retry-after = the best replica's drain
        estimate) and
        :class:`~apex_tpu.serving.resilience.EngineFailed` only when
        the whole fleet is terminally failed. Request-validity errors
        raise unchanged."""
        rid = request.request_id
        if rid in self.completions or any(
                p.request.request_id == rid for p in self._pending) \
                or any(rid in rep.sched._req_records
                       for rep in self.replicas):
            raise ValueError(f"duplicate request_id {rid!r}")
        book = self._tenant_book
        if book is not None:
            from apex_tpu_torch.serving.tenancy import TenantThrottled

            tenant = request.tenant = book.admit_tenant(
                request.tenant or "default")
            wait = book.throttle(tenant, request.max_tokens)
            if wait is not None:
                book.stats(tenant).throttled += 1
                book.stats(tenant).shed += 1
                if self.recorder is not None:
                    self.recorder.record("tenant_throttle", rid,
                                         tenant, wait)
                raise TenantThrottled(
                    f"tenant {tenant!r} over its fleet token budget; "
                    f"retry in ~{wait:.3f}s", tenant=tenant,
                    retry_after_s=wait)
        self._route(request, None, None, exclude=None, fresh=True)

    def can_accept(self, n: int = 1) -> bool:
        """Fleet pre-flight for an all-or-nothing batch: can the
        routable replicas absorb ``n`` submissions between them?"""
        room = 0
        for rep in self.replicas:
            if rep.routable():
                room += max(rep.sched.max_queue
                            - len(rep.sched.queue), 0)
                if room >= n:
                    return True
        return False

    def overload_hint_s(self) -> float:
        """The BEST routable replica's queue-drain estimate — what a
        fleet-wide 429's Retry-After should say (the next request goes
        to that replica)."""
        hints = [rep.sched.overload_hint_s()
                 for rep in self.replicas if rep.routable()]
        return min(hints) if hints else 0.0

    def _candidates(self, exclude: Optional[int],
                    tenant: Optional[str] = None) -> List[_Replica]:
        reps = [r for r in self.replicas
                if r.routable() and r.index != exclude]
        if not reps and exclude is not None:
            # the excluded source is the only replica left standing —
            # better the same replica than an error outcome
            reps = [r for r in self.replicas if r.routable()]
        # tenant affinity is a HINT, deliberately the weakest key:
        # among replicas tied on health AND load, prefer the one that
        # last served this tenant (its adapter gathers / prefix pages
        # are warm there) — never at the cost of routing onto a
        # sicker or busier replica, so fairness and failover
        # determinism are untouched
        sticky = (self._tenant_affinity.get(tenant)
                  if tenant is not None else None)
        # parked conversations and queued resumes are LATENT load: a
        # host-swap replica's idle slots are spoken for by streams
        # that will swap back in, so the occupancy key counts them —
        # routing spreads new arrivals away from oversubscribed
        # replicas before their resumes reclaim the pages
        return sorted(reps, key=lambda r: (
            0 if r.health_state == HEALTH_OK else 1,
            r.sched.overload_hint_s(),
            len(r.sched.queue) + len(r.sched.active)
            + len(r.sched._parked) + len(r.sched._resume_q),
            0 if r.index == sticky else 1,
            r.index))

    def _route(self, request: Request, tokens: Optional[List[int]],
               logprobs: Optional[List[float]], *,
               exclude: Optional[int], fresh: bool) -> bool:
        """Place one request (fresh submit, or a failover with its
        emitted prefix). Fresh submits raise on fleet saturation;
        failovers return False and stay pending."""
        candidates = self._candidates(exclude,
                                      getattr(request, "tenant", None))
        if not candidates:
            if all(r.state == REPLICA_FAILED or
                   r.health_state == HEALTH_FAILED
                   for r in self.replicas):
                if fresh:
                    raise EngineFailed(
                        "every fleet replica is terminally failed; "
                        "not accepting requests")
                return False
            if fresh:
                self._note_queue_full(request, 0)
                raise QueueFull(
                    "no replica in rotation (draining/cooling); retry "
                    "shortly", queue_depth=0,
                    retry_after_s=self.overload_hint_s())
            return False
        depth = 0
        for rep in candidates:
            try:
                rep.sched.submit(request, replay_prefix=tokens,
                                 replay_logprobs=logprobs)
            except QueueFull as e:
                depth = max(depth, e.queue_depth)
                continue
            except EngineFailed:
                continue  # lost a race with a terminal transition
            rep.routed += 1
            self._routed += 1
            tenant = getattr(request, "tenant", None)
            if tenant:
                self._tenant_affinity[tenant] = rep.index
            if self.recorder is not None:
                self.recorder.record(
                    "route", request.request_id, rep.index,
                    rep.health_state, rep.sched.overload_hint_s())
            if self.telemetry is not None:
                self.telemetry.routed[rep.index].inc()
            return True
        if fresh:
            self._note_queue_full(request, depth)
            raise QueueFull(
                f"every routable replica is at capacity "
                f"({len(candidates)} tried)", queue_depth=depth,
                retry_after_s=self.overload_hint_s())
        return False

    def _note_queue_full(self, request: Request, depth: int) -> None:
        self._queue_full += 1
        if self.recorder is not None:
            self.recorder.record("queue_full", request.request_id,
                                 depth, False)
        if self.telemetry is not None:
            self.telemetry.queue_full.inc()

    # -- failover ------------------------------------------------------------

    def _evict_hook(self, rep: _Replica):
        def hook(evicted: List[EvictedRequest], cause: str) -> None:
            self._on_evict(rep, evicted, cause)
        return hook

    def _on_evict(self, rep: _Replica, evicted: List[EvictedRequest],
                  cause: str) -> None:
        """A replica handed over interrupted work (terminal failure,
        breaker eviction, or one retry-exhausted request): queue it
        for placement on a healthy replica. Runs inside the failing
        scheduler's tick — placement happens in :meth:`step`, never
        re-entrantly."""
        self._failover_waves += 1
        rep.evict_cause = cause
        rep.evicted_ids = [e.request.request_id for e in evicted]
        if self.recorder is not None:
            self.recorder.record("failover", rep.index, cause,
                                 len(evicted))
        if self.telemetry is not None:
            self.telemetry.failovers.inc()
        for e in evicted:
            n = self._failover_counts.get(e.request.request_id, 0) + 1
            self._failover_counts[e.request.request_id] = n
            self._pending.append(_Pending(
                e.request, e.tokens, e.logprobs, rep.index, n))

    def _place_pending(self) -> None:
        if not self._pending:
            return
        still: Deque[_Pending] = collections.deque()
        any_routable = any(r.routable() for r in self.replicas)
        while self._pending:
            p = self._pending.popleft()
            if p.failovers > self.cfg.max_failovers:
                self._abort(p, f"{p.failovers - 1} failovers exhausted")
                continue
            if not any_routable:
                if all(r.state == REPLICA_FAILED
                       or r.health_state == HEALTH_FAILED
                       for r in self.replicas):
                    self._abort(p, "every replica terminally failed")
                else:
                    still.append(p)  # a drain/cooldown will end
                continue
            try:
                placed = self._route(p.request, p.tokens, p.logprobs,
                                     exclude=p.source, fresh=False)
            except ValueError as e:
                self._abort(p, f"failover resubmit rejected: {e}")
                continue
            if placed:
                self._failed_over_requests += 1
                if self.telemetry is not None:
                    self.telemetry.failed_over.inc()
            else:
                still.append(p)
        self._pending = still

    def _abort(self, p: _Pending, cause: str) -> None:
        """Terminal router-level outcome: the fleet could not serve
        this request anywhere — one ``error`` event + a completion
        carrying the longest stream the client saw (the single-engine
        exhaustion semantics, at fleet scope)."""
        self._aborted_requests += 1
        self._failover_counts.pop(p.request.request_id, None)
        arrival = p.request.arrival_time
        latency = (max(self.clock() - arrival, 0.0)
                   if arrival is not None else 0.0)
        self.events.append(StreamEvent(
            p.request.request_id, None, True, FINISH_ERROR,
            error=cause))
        self.completions[p.request.request_id] = Completion(
            p.request.request_id, list(p.tokens), FINISH_ERROR,
            ttft=None, latency=latency, logprobs=list(p.logprobs))

    # -- the loop ------------------------------------------------------------

    def step(self) -> None:
        """One fleet tick: tick every non-failed replica, scan for
        terminal failures and breaker trips (evict + rebuild + cool),
        harvest events/completions into the merged surfaces, place
        pending failovers."""
        self._steps += 1
        for rep in self.replicas:
            if rep.state != REPLICA_FAILED:
                rep.sched.step()
        self._scan()
        self._harvest()
        self._place_pending()
        self._update_gauges()

    def _scan(self) -> None:
        for rep in self.replicas:
            if rep.state == REPLICA_FAILED:
                continue
            if rep.health_state == HEALTH_FAILED:
                # the scheduler's terminal transition already evicted
                # its work through the hook; record the incident and
                # take the replica out of the fleet
                rep.state = REPLICA_FAILED
                self._write_incident(rep, rep.sched.health.last_cause
                                     or "failed")
                continue
            if rep.state == REPLICA_COOLING:
                rep.cooldown -= 1
                if rep.cooldown <= 0:
                    rep.reset_breaker()
                    rep.state = REPLICA_LIVE
                    if self.recorder is not None:
                        self.recorder.record("drain", rep.index,
                                             "readmit")
                continue
            if rep.state != REPLICA_LIVE:
                continue
            cause = rep.breaker_cause(self.cfg)
            if cause is not None:
                self._trip_breaker(rep, cause)

    def _trip_breaker(self, rep: _Replica, cause: str) -> None:
        """Open the replica's circuit: evict its current work to the
        healthy replicas, rebuild its buffers, and cool it down out of
        rotation. The health machine stays whatever it was — the
        breaker is ROUTER policy layered on top.

        Half-open mode (``FleetConfig.breaker_half_open``) first
        collects the replica's in-flight chunks so their tokens land
        in the eviction snapshots instead of being discarded unfetched
        — the failed-over streams re-derive less on arrival. A seam
        fault during that collection recovers through the scheduler's
        own machinery (snapshots grow either way); the eviction below
        proceeds regardless."""
        if self.cfg.breaker_half_open:
            try:
                while rep.sched._inflight:
                    rep.sched._collect_oldest()
            except Exception:  # collection died with the replica —
                pass           # eject what the snapshots already hold
        rep.sched.eject_all(f"breaker ({cause})")
        rep.sched.engine.rebuild_slots()
        rep.state = REPLICA_COOLING
        rep.cooldown = self.cfg.breaker_cooldown_steps

    def _harvest(self) -> None:
        for rep in self.replicas:
            sched = rep.sched
            evs = sched.pop_events()
            if evs:
                self.events.extend(evs)
            if sched.completions:
                for rid in list(sched.completions):
                    self.completions[rid] = sched.completions.pop(rid)
                    self._failover_counts.pop(rid, None)

    def pop_events(self) -> List[StreamEvent]:
        """Drain the merged response stream."""
        out = list(self.events)
        self.events.clear()
        return out

    def idle(self) -> bool:
        """Nothing to do — no pending failovers, every non-failed
        replica idle, AND no breaker cooldown counting down: the
        cooldown is tick-based, so a cooling replica is pending work
        (an idle-gated driver that stopped ticking would otherwise
        strand it out of rotation forever — with an all-cooling fleet
        429ing every submit that could have re-admitted it)."""
        if self._pending:
            return False
        return all(rep.state == REPLICA_FAILED
                   or (rep.state != REPLICA_COOLING and rep.sched.idle())
                   for rep in self.replicas)

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until every replica and the failover queue are empty
        (offline batch mode). Sleeps out retry-backoff gates exactly
        like the single-replica loop."""
        steps = 0
        while not self.idle():
            self.step()
            steps += 1
            if steps > max_steps:
                busy = [r.index for r in self.replicas
                        if r.state != REPLICA_FAILED
                        and not r.sched.idle()]
                raise RuntimeError(
                    f"fleet not idle after {max_steps} steps — busy "
                    f"replicas {busy}, {len(self._pending)} failovers "
                    f"pending")
            self._maybe_sleep()

    def _maybe_sleep(self) -> None:
        """When backoff gates are the ONLY remaining fleet work, wait
        the earliest one out through the first gated replica's
        injected ``sleep`` instead of spinning ticks."""
        if self._pending:
            return
        waits = []
        sleeper = None
        for rep in self.replicas:
            if rep.state == REPLICA_FAILED or rep.sched.idle():
                continue
            w = rep.sched._backoff_wait_s()
            if w is None:
                return  # this replica can make real progress now
            waits.append(w)
            sleeper = sleeper or rep.sched
        if waits and sleeper is not None:
            sleeper.sleep(min(waits))

    # -- rolling restart -----------------------------------------------------

    def drain(self, index: int, *, replace: bool = False) -> None:
        """Zero-downtime rolling restart of replica ``index``: take it
        out of rotation, serve its remaining queued + active work to
        completion (the rest of the fleet keeps serving — this call
        drives fleet ticks), bracket the scheduler's pipeline drain (a
        replica-level ``/healthz`` probe reads ``draining``), rebuild
        the slot buffers — or build a fresh factory replica with
        ``replace=True`` — and re-admit it to rotation. Zero requests
        are shed or errored by the cycle.

        Threading: this call DRIVES fleet ticks, so it must run on the
        thread that owns the router's step loop — the router inherits
        the scheduler's single-driver-thread discipline. Under a live
        ``ApiServer`` (whose driver thread owns the stepping), run the
        drain through that thread (stop the server, or hand it a
        closure to execute between ticks); calling it from another
        thread would race two drivers over the same schedulers."""
        rep = self._replica(index)
        if rep.state == REPLICA_FAILED:
            raise ValueError(
                f"replica {index} is terminally failed — use "
                f"restart({index})")
        if self.recorder is not None:
            self.recorder.record("drain", index, "begin")
        rep.state = REPLICA_DRAINING
        steps = 0
        while not rep.sched.idle():
            self.step()
            steps += 1
            if steps > self.cfg.drain_max_steps:
                raise RuntimeError(
                    f"replica {index} not idle after {steps} drain "
                    f"steps")
            if rep.state == REPLICA_FAILED:
                raise EngineFailed(
                    f"replica {index} failed terminally mid-drain "
                    f"({rep.sched.health.last_cause}); its work was "
                    f"failed over — restart({index}) replaces it")
            self._maybe_sleep()
        rep.sched.drain()   # the drain bracket: draining observed
        if self.recorder is not None:
            self.recorder.record("drain", index, "idle")
        if replace:
            self._replace(rep, "drain")
        else:
            rep.sched.engine.rebuild_slots()
        if self.recorder is not None:
            self.recorder.record("drain", index, "rebuilt")
        rep.reset_breaker()
        rep.cooldown = 0
        rep.state = REPLICA_LIVE
        self._drains += 1
        if self.recorder is not None:
            self.recorder.record("drain", index, "readmit")
        if self.telemetry is not None:
            self.telemetry.drains.inc()
        self._update_gauges()

    def restart(self, index: int,
                journal_dir: Optional[str] = None) -> None:
        """Replace a terminally failed replica from the factory and
        re-admit it to rotation (its interrupted work already failed
        over when it died).

        ``journal_dir`` points at the dead replica's write-ahead
        journal (``apex_tpu.serving.journal``): the replacement
        replays its unfinished state — pooled prefixes and every
        request the eviction hook never got to hand over (a SIGKILL'd
        process evicts nothing), with their emitted prefixes intact —
        so a whole-process replica death recovers instead of dropping
        streams. Work that DID fail over was journaled finished
        ("evicted") by the dying scheduler and is never resubmitted
        twice; adapters re-register through the fleet's own ledger
        either way, keeping ids aligned across siblings."""
        rep = self._replica(index)
        if rep.state != REPLICA_FAILED:
            raise ValueError(
                f"replica {index} is {rep.state}, not failed — use "
                f"drain({index}) for a rolling restart")
        self._replace(rep, "failed")
        if journal_dir is not None:
            from apex_tpu_torch.serving import journal as journal_mod
            journal_mod.replay_into(rep.sched, journal_dir)
        rep.reset_breaker()
        rep.cooldown = 0
        rep.state = REPLICA_LIVE
        self._restarts += 1
        if self.recorder is not None:
            self.recorder.record("restart", index,
                                 rep.evict_cause or "failed")
        self._update_gauges()

    def _replace(self, rep: _Replica, why: str) -> None:
        if self.factory is None:
            raise ValueError(
                f"no replica factory: Router(factory=...) is required "
                f"to replace replica {rep.index} ({why})")
        sched = self.factory(rep.index)
        self._check_compatible(self.replicas[0].sched, sched)
        if sched.on_evict is not None:
            raise ValueError("factory scheduler already has an "
                             "on_evict owner")
        for kw in self._adapter_registrations:
            # a replacement replica must serve every registered
            # adapter at the SAME ids as its siblings, or a tenant's
            # failed-over stream would decode on the wrong weights
            sched.register_adapter(**kw)
        old = rep.sched
        rep.sched = sched
        sched.on_evict = self._evict_hook(rep)
        old.on_evict = None

    def _replica(self, index: int) -> _Replica:
        if not 0 <= index < len(self.replicas):
            raise ValueError(
                f"replica {index} outside fleet "
                f"[0, {len(self.replicas)})")
        return self.replicas[index]

    # -- incidents -----------------------------------------------------------

    def _write_incident(self, rep: _Replica, cause: str) -> None:
        """One terminal replica failure = one fleet incident manifest:
        an atomic bundle directory linking the replica's own
        auto-dumped post-mortem bundles to the fleet-level picture
        (what was evicted, where the fleet stood). Disk errors are
        swallowed — losing the manifest must never take down the
        routing loop that survived the replica."""
        if self.bundle_dir is None:
            return
        manifest = {
            "incident_version": 1,
            "kind": "fleet_incident",
            "cause": cause,
            "replica": rep.index,
            "wall_time": time.time(),
            "evicted_request_ids": list(rep.evicted_ids),
            "replica_bundles": list(rep.sched.bundles_written),
            "replica_health": {
                "state": rep.health_state,
                "last_cause": rep.sched.health.last_cause,
            },
            "fleet": self.summary(),
        }
        while True:
            name = (f"fleet-incident-{self._incident_counter:04d}"
                    f"-r{rep.index}")
            path = os.path.join(self.bundle_dir, name)
            self._incident_counter += 1
            if not os.path.exists(path):
                break
        try:
            path = flightrec_mod.write_bundle(
                path, {"manifest.json": manifest})
        except OSError:
            return
        self.incidents_written.append(path)
        if self.recorder is not None:
            self.recorder.record("bundle", f"fleet-{cause}",
                                 os.path.basename(path))

    # -- shared-engine conveniences ------------------------------------------

    @property
    def engine(self):
        """Replica 0's engine — the config surface API layers read
        (every replica's model/engine config is identical by
        construction). Use :meth:`register_prefix` (not
        ``router.engine.register_prefix``) to register templates, so
        EVERY replica serves the hit."""
        return self.replicas[0].sched.engine

    def register_prefix(self, tokens) -> List[int]:
        """Register a shared-prompt template into EVERY replica's
        prefix pool — failover keeps streams
        bit-identical either way (prefix-hit == cold is an oracle),
        but only a fleet-wide registration keeps the admission
        SPEEDUP after a request moves replicas."""
        return [rep.sched.engine.register_prefix(tokens)
                for rep in self.replicas]

    def register_adapter(self, weights=None, *, name=None,
                         seed=None) -> List[int]:
        """Register a LoRA adapter into EVERY replica's pool —
        registration order is identical across replicas by
        construction, so a tenant's adapter id means the same weights
        everywhere and failover streams stay bit-identical. Recorded
        fleet-side too: a factory replacement replays the sequence."""
        self._adapter_registrations.append(
            {"weights": weights, "name": name, "seed": seed})
        return [rep.sched.register_adapter(weights, name=name,
                                           seed=seed)
                for rep in self.replicas]

    # -- reporting -----------------------------------------------------------

    def _update_gauges(self) -> None:
        tele = self.telemetry
        if tele is None:
            return
        tele.routable.set(sum(r.routable() for r in self.replicas))
        for rep in self.replicas:
            g = tele.health.get(rep.index)
            if g is not None:
                g.set(HEALTH_STATES.index(rep.health_state))
            b = tele.breaker.get(rep.index)
            if b is not None:
                b.set(0.0 if rep.state == REPLICA_LIVE else 1.0)
            p = tele.predicted_ttft.get(rep.index)
            if p is not None:
                p.set(rep.sched.predicted_ttft_s())

    def fleet_sketch(self, metric: str):
        """Merge every replica's quantile sketch for ``metric`` into
        one fleet sketch (merge works on COPIES — a replica's live
        sketch is never mutated by reporting). DDSketch merge is exact
        bucket addition, so the fleet percentile equals the percentile
        of the pooled samples within the configured relative error —
        NOT an average of per-replica percentiles, which would be
        meaningless. None when no replica runs an SLO monitor (or all
        sketches are empty)."""
        merged = None
        for rep in self.replicas:
            mon = rep.sched.slo
            if mon is None:
                continue
            sk = mon.sketch(metric)
            if sk is None or not sk.count:
                continue
            merged = sk.copy() if merged is None else merged.merge(
                sk.copy())
        return merged

    def fleet_percentiles(self, metric: str) -> Dict[str, float]:
        """Fleet-pooled ``{count, p50_ms, p95_ms, p99_ms}`` for one
        SLO metric — empty dict when nothing is recorded yet."""
        sk = self.fleet_sketch(metric)
        if sk is None:
            return {}
        return {"count": float(sk.count),
                "p50_ms": sk.quantile(0.50) * 1e3,
                "p95_ms": sk.quantile(0.95) * 1e3,
                "p99_ms": sk.quantile(0.99) * 1e3}

    def slo_status(self) -> Optional[Dict[str, Any]]:
        """The fleet ``/slo`` aggregate: per-replica monitor status
        plus fleet-merged percentiles and the worst objective state
        across the fleet. None when no replica runs a monitor (the
        route 404s, matching the single-scheduler contract)."""
        from apex_tpu_torch.telemetry.slo import METRICS as SLO_METRICS
        per_replica = {
            str(rep.index): rep.sched.slo.status()
            for rep in self.replicas if rep.sched.slo is not None}
        if not per_replica:
            return None
        order = ("ok", "warning", "burning")
        worst = max((s["state"] for s in per_replica.values()),
                    key=order.index)
        return {
            "state": worst,
            "fleet": {m: self.fleet_percentiles(m)
                      for m in SLO_METRICS},
            "replicas": per_replica,
            "predicted_ttft_s": {
                str(rep.index): rep.sched.predicted_ttft_s()
                for rep in self.replicas},
        }

    def summary(self) -> Dict[str, float]:
        """Fleet-level aggregate (flat floats, like
        ``Scheduler.summary()`` — the bench's JSON line): routing /
        failover / restart counters plus per-replica health codes,
        routed counts, predicted TTFT, and — when SLO monitors are
        wired — fleet-pooled latency percentiles."""
        out: Dict[str, float] = {
            "replicas": float(len(self.replicas)),
            "replicas_routable": float(
                sum(r.routable() for r in self.replicas)),
            "requests_completed": float(len(self.completions)),
            "routed": float(self._routed),
            "steps": float(self._steps),
            "failover_waves": float(self._failover_waves),
            "failed_over_requests": float(self._failed_over_requests),
            "aborted_requests": float(self._aborted_requests),
            "pending_failovers": float(len(self._pending)),
            "drains": float(self._drains),
            "restarts": float(self._restarts),
            "queue_full": float(self._queue_full),
            "incidents": float(len(self.incidents_written)),
            "health_state": float(self.health.code),
            "tokens_emitted": 0.0,
        }
        for rep in self.replicas:
            out[f"replica{rep.index}_health"] = float(
                HEALTH_STATES.index(rep.health_state))
            out[f"replica{rep.index}_routed"] = float(rep.routed)
            out[f"replica{rep.index}_predicted_ttft_s"] = \
                rep.sched.predicted_ttft_s()
            out["tokens_emitted"] += rep.sched.summary().get(
                "tokens_emitted", 0.0)
        if any(rep.sched.slo is not None for rep in self.replicas):
            from apex_tpu_torch.telemetry.slo import METRICS as SLO_METRICS
            for metric in SLO_METRICS:
                for k, v in self.fleet_percentiles(metric).items():
                    out[f"fleet_slo_{metric}_{k}"] = v
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Detach the router's eviction ownership from every replica.
        Idempotent."""
        for rep in self.replicas:
            rep.sched.on_evict = None

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
