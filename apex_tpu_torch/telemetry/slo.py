"""SLO observatory — streaming latency percentiles, error budgets, and
burn-rate alerting.

The registry's fixed-bucket histograms answer "roughly where do
samples land" but not "what IS p99 right now", and the scheduler's
:class:`~apex_tpu_torch.profiler.LatencyStats` window forgets everything
older than its ring. This module is the measurement substrate a
latency-aware controller needs, stdlib-only like tuner/tenancy/flightrec
(the ``telemetry.replay`` report path re-derives an alert timeline with
no torch installed), and the port's copy of the JAX package's: the same
samples give bit-equal quantiles and the same alert sequence:

- :class:`QuantileSketch` — a fixed-γ log-bucket sketch (the DDSketch
  construction): ``add`` is O(1) (one log + one dict bump), memory is
  bounded by ``max_buckets`` whatever the sample count (the lowest
  buckets collapse first — SLOs live in the upper tail), every
  quantile estimate carries a GUARANTEED relative error ≤ ``rel_err``,
  and sketches with the same γ merge exactly (bucket-count addition) —
  fleet-merged percentiles equal pooled-sample percentiles, which is
  what lets the fleet router aggregate replicas without shipping raw
  samples.
- :class:`SLOObjective` / :class:`SLOConfig` — declared objectives
  (``p99 ttft_s < 0.2``, optionally per tenant) with error-budget
  accounting (allowed bad fraction = ``1 - target``) and the
  multi-window burn-rate policy knobs.
- :class:`BurnMachine` — one ok → warning → burning state machine per
  objective: burn rate = (bad fraction) / (error budget) over a fast
  and a slow window; BURNING requires both windows elevated (the
  classic multi-window page condition — a blip trips neither, a real
  regression trips both), WARNING keys off the slow window, and every
  exit threshold is scaled by ``hysteresis`` (symmetric recovery
  hysteresis, the spec-gate pattern) so a burn hovering at the line
  cannot flap. Window counts are integer per-second bins keyed to the
  injected clock — fake-clock deterministic by construction.
- :class:`SLOMonitor` — the aggregation front the scheduler feeds:
  global + per-tenant sketches for the four latency surfaces the
  scheduler already timestamps (``ttft``, ``token_latency``,
  ``queue_wait``, ``e2e``; per-tenant population bounded like the
  tenant book's metric children), objective machines, and the
  evaluation/snapshot cadence. Every evaluation input (``slo_eval``),
  state transition (``slo_state``), page-worthy alert (``slo_alert``),
  and sketch snapshot (``slo_sketch``) is a flight-recorder event, so
  :func:`replay_alerts` can re-run the machines from a post-mortem
  bundle's recorded window counts and reproduce the full alert
  sequence bit-identically — the same replayability contract the tuner
  meets (:func:`compare_alerts` is ``compare_decisions``'s sibling).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

#: the latency surfaces the scheduler feeds, in canonical order:
#: time-to-first-token, inter-token gap, queue wait (arrival →
#: admission), and end-to-end request latency
METRICS: Tuple[str, ...] = ("ttft", "token_latency", "queue_wait", "e2e")

#: burn-rate machine states, and their ``serving_slo_state`` gauge
#: codes (0 ok / 1 warning / 2 burning)
STATE_OK, STATE_WARNING, STATE_BURNING = "ok", "warning", "burning"
STATE_CODE: Dict[str, float] = {STATE_OK: 0.0, STATE_WARNING: 1.0,
                                STATE_BURNING: 2.0}

#: window-count bin width (seconds) — integer per-second bins make the
#: windows exact functions of the injected clock (fake-clock replayable)
_BIN_S = 1.0

#: samples at or below this are the sketch's zero bucket (a log-bucket
#: index is undefined at 0; sub-nanosecond latencies are clock noise)
_MIN_TRACKABLE = 1e-9


class QuantileSketch:
    """Mergeable fixed-γ log-bucket quantile sketch (DDSketch).

    A sample ``x`` lands in bucket ``ceil(log_γ(x))`` with
    ``γ = (1 + rel_err) / (1 - rel_err)``; the bucket's midpoint
    estimate ``2·γ^i/(γ+1)`` is within ``rel_err`` of every value the
    bucket covers, so ``quantile(q)`` is rank-exact over buckets and
    value-accurate to ``rel_err`` — guaranteed, not statistical.
    Merging adds bucket counts, so (same γ) merged == pooled exactly;
    ``max_buckets`` bounds memory by collapsing the LOWEST buckets
    (the upper tail — where SLOs are read — keeps full resolution).
    """

    __slots__ = ("rel_err", "gamma", "max_buckets", "_log_gamma",
                 "_buckets", "_zero", "count", "sum", "min", "max")

    def __init__(self, rel_err: float = 0.01, max_buckets: int = 2048):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err {rel_err} outside (0, 1)")
        if max_buckets < 16:
            raise ValueError(f"max_buckets {max_buckets} must be >= 16")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self.max_buckets = int(max_buckets)
        self._log_gamma = math.log(self.gamma)
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- ingestion (hot path) ------------------------------------------------

    def add(self, value: float, n: int = 1) -> None:
        """Fold ``n`` samples of ``value`` in: one log, one dict bump."""
        if n <= 0:
            return
        value = float(value)
        if value <= _MIN_TRACKABLE:
            value = max(value, 0.0)
            self._zero += n
        else:
            key = math.ceil(math.log(value) / self._log_gamma)
            self._buckets[key] = self._buckets.get(key, 0) + n
            if len(self._buckets) > self.max_buckets:
                self._collapse()
        self.count += n
        self.sum += value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def _collapse(self) -> None:
        # collapse lowest-index buckets into their neighbour: low
        # quantiles lose resolution first, the upper tail never does
        keys = sorted(self._buckets)
        while len(self._buckets) > self.max_buckets:
            k0 = keys.pop(0)
            self._buckets[keys[0]] += self._buckets.pop(k0)

    # -- merging (the fleet aggregation path) --------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` in (in place; returns self). Same-γ bucket
        addition — merged == pooled by construction."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different gamma "
                f"({self.gamma} vs {other.gamma}) — bucket indices "
                f"would not line up")
        for k, c in other._buckets.items():
            self._buckets[k] = self._buckets.get(k, 0) + c
        if len(self._buckets) > self.max_buckets:
            self._collapse()
        self._zero += other._zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.rel_err, self.max_buckets)
        out._buckets = dict(self._buckets)
        out._zero = self._zero
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        return out

    # -- queries -------------------------------------------------------------

    def quantile(self, q: float) -> Optional[float]:
        """The value at rank ``q`` (0..1), within ``rel_err`` relative
        error; ``None`` before the first sample."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        acc = self._zero
        if rank < acc:
            return 0.0
        for k in sorted(self._buckets):
            acc += self._buckets[k]
            if rank < acc:
                est = 2.0 * self.gamma ** k / (self.gamma + 1.0)
                # clamp to the observed range: exact min/max are free
                # to keep, and they make constant streams exact
                return min(max(est, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def buckets_in_use(self) -> int:
        """Live bucket count — the O(1)-memory invariant the tests pin
        (≤ ``max_buckets`` whatever the sample count)."""
        return len(self._buckets) + (1 if self._zero else 0)

    # -- serialisation (bundles + fleet transport) ---------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rel_err": self.rel_err,
            "max_buckets": self.max_buckets,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "zero": self._zero,
            "buckets": {str(k): c for k, c in self._buckets.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantileSketch":
        out = cls(d.get("rel_err", 0.01), d.get("max_buckets", 2048))
        out._buckets = {int(k): int(c)
                        for k, c in (d.get("buckets") or {}).items()}
        out._zero = int(d.get("zero", 0))
        out.count = int(d.get("count", 0))
        out.sum = float(d.get("sum", 0.0))
        out.min = math.inf if d.get("min") is None else float(d["min"])
        out.max = -math.inf if d.get("max") is None else float(d["max"])
        return out


# -- declared objectives ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One declared objective: "``quantile`` of ``metric`` stays under
    ``threshold_s``" for ``target`` of traffic (the error budget is
    ``1 - target``). ``tenant=None`` covers all traffic; a named tenant
    scopes the objective to that tenant's samples only."""

    metric: str
    quantile: float = 0.99
    threshold_s: float = 0.2
    target: float = 0.999
    tenant: Optional[str] = None

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown SLO metric {self.metric!r} — one of {METRICS}")
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(
                f"quantile {self.quantile} outside (0, 1)")
        if not self.threshold_s > 0.0:
            raise ValueError(
                f"threshold_s {self.threshold_s} must be > 0")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target {self.target} outside (0, 1) — target 1.0 "
                f"has a zero error budget (every burn rate is infinite)")

    def key(self) -> str:
        """Canonical spec string — ``"p99:ttft:0.2"`` (the CLI flag
        syntax, the event field, and the metric label)."""
        out = f"p{self.quantile * 100:g}:{self.metric}:{self.threshold_s:g}"
        if self.tenant is not None:
            out += f":{self.tenant}"
        return out


def parse_objective(spec: str) -> SLOObjective:
    """Parse ``"p99:ttft:0.2"`` (optionally ``:tenant`` suffixed) —
    the ``--slo`` flag syntax, inverse of :meth:`SLOObjective.key`."""
    parts = spec.strip().split(":")
    if len(parts) not in (3, 4) or not parts[0].lower().startswith("p"):
        raise ValueError(
            f"bad SLO spec {spec!r} — want 'p99:ttft:0.2' "
            f"(quantile:metric:threshold_s[:tenant])")
    return SLOObjective(
        metric=parts[1],
        quantile=float(parts[0][1:]) / 100.0,
        threshold_s=float(parts[2]),
        tenant=parts[3] if len(parts) == 4 else None)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Objectives + sketch resolution + burn-rate policy (static,
    host-only — serialized into the bundle's scheduler config block so
    replay rebuilds identical machines)."""

    objectives: Tuple[SLOObjective, ...] = ()
    #: sketch relative-error guarantee (γ = (1+rel)/(1-rel))
    rel_err: float = 0.01
    #: fast burn window — catches a sharp regression quickly
    fast_window_s: float = 60.0
    #: slow burn window — confirms it is sustained, not a blip
    slow_window_s: float = 600.0
    #: slow-window burn rate that enters WARNING (1.0 = consuming the
    #: budget exactly at the rate that exhausts it on schedule)
    warn_burn: float = 1.0
    #: burn rate BOTH windows must clear to enter BURNING (the page)
    burn: float = 6.0
    #: exit thresholds scale by this (< 1): symmetric recovery
    #: hysteresis, so a burn hovering at a line cannot flap the state
    hysteresis: float = 0.8
    #: machine evaluation cadence (also the ``slo_eval`` event cadence)
    eval_every_s: float = 1.0
    #: ``slo_sketch`` percentile-snapshot event cadence
    snapshot_every_s: float = 30.0

    def __post_init__(self):
        if not 0.0 < self.rel_err < 1.0:
            raise ValueError(f"rel_err {self.rel_err} outside (0, 1)")
        if not 0.0 < self.fast_window_s < self.slow_window_s:
            raise ValueError(
                f"windows must satisfy 0 < fast ({self.fast_window_s}) "
                f"< slow ({self.slow_window_s})")
        if not 0.0 < self.warn_burn <= self.burn:
            raise ValueError(
                f"need 0 < warn_burn ({self.warn_burn}) <= burn "
                f"({self.burn}) — WARNING must trip at or before BURNING")
        if not 0.0 < self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis {self.hysteresis} outside (0, 1) — >= 1 "
                f"would make recovery harder than entry was")
        for n in ("eval_every_s", "snapshot_every_s"):
            if getattr(self, n) <= 0.0:
                raise ValueError(f"{n} {getattr(self, n)} must be > 0")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["objectives"] = [dataclasses.asdict(o)
                           for o in self.objectives]
        return d


def slo_config_from_dict(d: Dict[str, Any]) -> SLOConfig:
    """Rebuild an :class:`SLOConfig` from its bundle JSON form — the
    replay side of :meth:`SLOConfig.to_dict`."""
    d = dict(d)
    d["objectives"] = tuple(
        SLOObjective(**o) for o in d.get("objectives") or ())
    names = {f.name for f in dataclasses.fields(SLOConfig)}
    return SLOConfig(**{k: v for k, v in d.items() if k in names})


# -- the burn-rate state machine ---------------------------------------------


class BurnMachine:
    """One objective's error-budget accountant + ok → warning →
    burning state machine. Samples land in integer per-second bins
    (good/bad counts keyed to the injected clock); every
    :meth:`evaluate` reduces the fast and slow windows to four ints,
    records them (``slo_eval`` — the replayable input), and runs the
    recording-free :meth:`_eval_core` on them — so the full transition
    and alert sequence is a pure function of the recorded inputs,
    exactly like the tuner's decision replay."""

    __slots__ = ("obj", "cfg", "state", "good_total", "bad_total",
                 "fast_burn", "slow_burn", "_bins", "recorder",
                 "on_state")

    def __init__(self, obj: SLOObjective, cfg: SLOConfig, *,
                 recorder=None,
                 on_state: Optional[Callable[[SLOObjective, str, str],
                                             None]] = None):
        self.obj = obj
        self.cfg = cfg
        self.state = STATE_OK
        self.good_total = 0
        self.bad_total = 0
        self.fast_burn = 0.0
        self.slow_burn = 0.0
        #: per-second [good, bad] bins, keyed floor(now / _BIN_S)
        self._bins: Dict[int, List[int]] = {}
        self.recorder = recorder
        self.on_state = on_state

    # -- ingestion -----------------------------------------------------------

    def observe(self, now: float, value: float) -> None:
        good = value <= self.obj.threshold_s
        cell = self._bins.get(int(now // _BIN_S))
        if cell is None:
            cell = self._bins[int(now // _BIN_S)] = [0, 0]
        if good:
            cell[0] += 1
            self.good_total += 1
        else:
            cell[1] += 1
            self.bad_total += 1

    # -- evaluation ----------------------------------------------------------

    def _window(self, now: float, window_s: float) -> Tuple[int, int]:
        lo = (now - window_s) // _BIN_S
        g = b = 0
        for k, cell in self._bins.items():
            if k > lo:
                g += cell[0]
                b += cell[1]
        return g, b

    def evaluate(self, now: float) -> None:
        """Reduce the windows, record the input, run the core."""
        # prune bins entirely older than the slow window (bounded state)
        lo = (now - self.cfg.slow_window_s) // _BIN_S
        for k in [k for k in self._bins if k <= lo]:
            del self._bins[k]
        fg, fb = self._window(now, self.cfg.fast_window_s)
        sg, sb = self._window(now, self.cfg.slow_window_s)
        if self.recorder is not None:
            self.recorder.record("slo_eval", self.obj.key(),
                                 fg, fb, sg, sb)
        self._eval_core(fg, fb, sg, sb)

    def _eval_core(self, fast_good: int, fast_bad: int,
                   slow_good: int, slow_bad: int) -> None:
        """The recording-free arithmetic replay re-runs on recorded
        inputs: integer counts → burn rates → classification. Pure
        float arithmetic on ints, so replayed burns are bit-identical."""
        budget = 1.0 - self.obj.target
        ft, st = fast_good + fast_bad, slow_good + slow_bad
        fast = (fast_bad / ft) / budget if ft else 0.0
        slow = (slow_bad / st) / budget if st else 0.0
        self.fast_burn, self.slow_burn = fast, slow
        new = self._classify(fast, slow)
        if new == self.state:
            return
        old, self.state = self.state, new
        if self.recorder is not None:
            self.recorder.record("slo_state", self.obj.key(), old, new,
                                 fast, slow)
            if new != STATE_OK:
                self.recorder.record("slo_alert", self.obj.key(), new,
                                     max(fast, slow))
        if self.on_state is not None:
            self.on_state(self.obj, old, new)

    def _classify(self, fast: float, slow: float) -> str:
        h = self.cfg.hysteresis
        thr_burn = self.cfg.burn * (h if self.state == STATE_BURNING
                                    else 1.0)
        if fast >= thr_burn and slow >= thr_burn:
            return STATE_BURNING
        thr_warn = self.cfg.warn_burn * (h if self.state != STATE_OK
                                         else 1.0)
        if slow >= thr_warn:
            return STATE_WARNING
        return STATE_OK

    # -- reporting -----------------------------------------------------------

    def budget_remaining(self) -> float:
        """Fraction of the error budget left over everything observed
        (1.0 untouched, 0.0 exhausted, negative = overrun — reported
        honestly, not clamped)."""
        total = self.good_total + self.bad_total
        if not total:
            return 1.0
        return 1.0 - (self.bad_total / total) / (1.0 - self.obj.target)

    def status(self) -> Dict[str, Any]:
        return {
            "objective": self.obj.key(),
            "state": self.state,
            "fast_burn": self.fast_burn,
            "slow_burn": self.slow_burn,
            "good": self.good_total,
            "bad": self.bad_total,
            "budget_remaining": self.budget_remaining(),
        }


# -- the aggregation front ----------------------------------------------------


class SLOMonitor:
    """Sketches + machines + cadence — what ``Scheduler(slo=...)``
    constructs and feeds. ``observe`` is the hot path: one sketch add
    (two with a tenant label) plus one bin bump per matching
    objective. ``tick`` runs the evaluation/snapshot cadences (the
    scheduler calls it once per step; sub-cadence calls return
    immediately). Per-tenant sketch population is bounded by
    ``max_tenants`` — past it, new tenant labels fold into
    ``"overflow"``, the tenant book's cardinality discipline."""

    def __init__(self, cfg: SLOConfig, *, clock=time.monotonic,
                 recorder=None,
                 on_state: Optional[Callable[[SLOObjective, str, str],
                                             None]] = None,
                 max_tenants: int = 256):
        self.cfg = cfg
        self.clock = clock
        self.recorder = recorder
        self._sketch: Dict[str, QuantileSketch] = {
            m: QuantileSketch(cfg.rel_err) for m in METRICS}
        self._tenant_sketch: Dict[str, Dict[str, QuantileSketch]] = {}
        self.max_tenants = max_tenants
        self.machines: Dict[str, BurnMachine] = {}

        def _on_state(obj: SLOObjective, old: str, new: str) -> None:
            if new != STATE_OK:
                self.alerts_total += 1
            if on_state is not None:
                on_state(obj, old, new)

        for obj in cfg.objectives:
            k = obj.key()
            if k in self.machines:
                raise ValueError(f"duplicate SLO objective {k!r}")
            self.machines[k] = BurnMachine(obj, cfg, recorder=recorder,
                                           on_state=_on_state)
        self.alerts_total = 0
        self._last_eval: Optional[float] = None
        self._last_snapshot: Optional[float] = None

    # -- ingestion (hot path) ------------------------------------------------

    def observe(self, metric: str, value: float,
                tenant: Optional[str] = None,
                now: Optional[float] = None) -> None:
        self._sketch[metric].add(value)
        if tenant is not None:
            if (tenant not in self._tenant_sketch
                    and len(self._tenant_sketch) >= self.max_tenants):
                tenant = "overflow"  # fold past the cardinality cap
            per = self._tenant_sketch.get(tenant)
            if per is None:
                per = self._tenant_sketch[tenant] = {
                    m: QuantileSketch(self.cfg.rel_err) for m in METRICS}
            per[metric].add(value)
        if not self.machines:
            return
        if now is None:
            now = self.clock()
        for m in self.machines.values():
            if m.obj.metric == metric and (
                    m.obj.tenant is None or m.obj.tenant == tenant):
                m.observe(now, value)

    # -- cadence -------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> bool:
        """Run any due evaluation / snapshot; True when an evaluation
        ran (the caller's cue to refresh gauges)."""
        if now is None:
            now = self.clock()
        if self._last_eval is None:
            # arm the cadences at first sight of the clock — an eval at
            # t0 would alert on an empty window
            self._last_eval = self._last_snapshot = now
            return False
        ran = False
        if now - self._last_eval >= self.cfg.eval_every_s:
            for m in self.machines.values():
                m.evaluate(now)
            self._last_eval = now
            ran = True
        if now - self._last_snapshot >= self.cfg.snapshot_every_s:
            self._record_snapshots()
            self._last_snapshot = now
        return ran

    def _record_snapshots(self) -> None:
        if self.recorder is None:
            return
        for metric in METRICS:
            sk = self._sketch[metric]
            if not sk.count:
                continue
            self.recorder.record(
                "slo_sketch", metric, "", sk.count,
                sk.quantile(0.50), sk.quantile(0.95), sk.quantile(0.99))
        for tenant in sorted(self._tenant_sketch):
            for metric in METRICS:
                sk = self._tenant_sketch[tenant][metric]
                if not sk.count:
                    continue
                self.recorder.record(
                    "slo_sketch", metric, tenant, sk.count,
                    sk.quantile(0.50), sk.quantile(0.95),
                    sk.quantile(0.99))

    # -- queries -------------------------------------------------------------

    def sketch(self, metric: str,
               tenant: Optional[str] = None) -> Optional[QuantileSketch]:
        """The live sketch (None for an unseen tenant) — the fleet
        router merges copies of these across replicas."""
        if tenant is None:
            return self._sketch.get(metric)
        per = self._tenant_sketch.get(tenant)
        return None if per is None else per.get(metric)

    def quantile(self, metric: str, q: float,
                 tenant: Optional[str] = None) -> Optional[float]:
        sk = self.sketch(metric, tenant)
        return None if sk is None else sk.quantile(q)

    def percentiles(self, metric: str,
                    tenant: Optional[str] = None) -> Dict[str, float]:
        """``{count, p50_ms, p95_ms, p99_ms}`` (empty before samples)."""
        sk = self.sketch(metric, tenant)
        if sk is None or not sk.count:
            return {}
        return {
            "count": float(sk.count),
            "p50_ms": sk.quantile(0.50) * 1e3,
            "p95_ms": sk.quantile(0.95) * 1e3,
            "p99_ms": sk.quantile(0.99) * 1e3,
        }

    def worst_state(self) -> str:
        worst = STATE_OK
        for m in self.machines.values():
            if STATE_CODE[m.state] > STATE_CODE[worst]:
                worst = m.state
        return worst

    def summary(self) -> Dict[str, float]:
        """Flat floats for ``Scheduler.summary()``: sketch-backed
        percentiles per metric plus the alert roll-up."""
        out: Dict[str, float] = {}
        for metric in METRICS:
            for k, v in self.percentiles(metric).items():
                if k != "count":
                    out[f"slo_{metric}_{k}"] = v
        if self.machines:
            out["slo_state"] = STATE_CODE[self.worst_state()]
            out["slo_alerts"] = float(self.alerts_total)
            out["slo_budget_remaining"] = min(
                (m.budget_remaining() for m in self.machines.values()),
                default=1.0)
        return out

    def status(self) -> Dict[str, Any]:
        """The full ``/slo`` endpoint payload."""
        metrics = {m: self.percentiles(m) for m in METRICS
                   if self.percentiles(m)}
        tenants = {
            t: {m: self.percentiles(m, t) for m in METRICS
                if self.percentiles(m, t)}
            for t in sorted(self._tenant_sketch)}
        return {
            "objectives": {k: m.status()
                           for k, m in sorted(self.machines.items())},
            "metrics": metrics,
            "tenants": tenants,
            "state": self.worst_state(),
            "alerts_total": self.alerts_total,
        }


# -- bundle replay (compare_decisions' sibling) -------------------------------

#: event names the machines emit as outputs (everything except the
#: ``slo_eval`` inputs and the ``slo_sketch`` snapshots) — the
#: sequence replay compares
ALERT_EVENTS = ("slo_state", "slo_alert")


def _event_fields(ev: Dict[str, Any]) -> List[Any]:
    from apex_tpu_torch.telemetry.flightrec import EVENT_FIELDS

    return [ev.get(f) for f in EVENT_FIELDS[ev["event"]]]


def replay_alerts(cfg: SLOConfig,
                  events: Iterable[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Re-run fresh :class:`BurnMachine`\\ s over a bundle's recorded
    ``slo_eval`` window counts, in recorded sequence order, and return
    the transition/alert events they regenerate — pure float
    arithmetic on recorded integer counts, bit-identical to the
    original run by construction."""
    from apex_tpu_torch.telemetry.flightrec import FlightRecorder

    rec = FlightRecorder(clock=lambda: 0.0)
    machines = {o.key(): BurnMachine(o, cfg, recorder=rec)
                for o in cfg.objectives}
    for ev in events:
        if ev.get("event") != "slo_eval":
            continue
        m = machines.get(ev.get("objective"))
        if m is not None:
            m._eval_core(int(ev["fast_good"]), int(ev["fast_bad"]),
                         int(ev["slow_good"]), int(ev["slow_bad"]))
    return [e for e in rec.to_dicts(rec.events())
            if e["event"] in ALERT_EVENTS]


def compare_alerts(cfg: SLOConfig,
                   events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The bundle-side check: replay the recorded evaluation inputs
    and compare the regenerated transition/alert sequence against the
    recorded one, seq-for-seq and field-for-field (burn-rate floats
    included). ``mismatches`` empty = the alert timeline replays
    exactly."""
    events = sorted(events, key=lambda e: e.get("seq", 0))
    recorded = [e for e in events if e.get("event") in ALERT_EVENTS]
    replayed = replay_alerts(cfg, events)
    mismatches: List[Dict[str, Any]] = []
    for i in range(max(len(recorded), len(replayed))):
        a = recorded[i] if i < len(recorded) else None
        b = replayed[i] if i < len(replayed) else None
        if a is None or b is None or a["event"] != b["event"] \
                or _event_fields(a) != _event_fields(b):
            mismatches.append({"index": i, "recorded": a,
                               "replayed": b})
    return {
        "transitions_recorded": len(recorded),
        "transitions_replayed": len(replayed),
        "mismatches": mismatches,
    }
