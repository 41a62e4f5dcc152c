"""Self-tuning serving runtime — the scheduler's knob control plane.

The port's copy of the JAX package's tuner. ``decode_chunk``,
``pipeline_depth``, ``max_admit_batch`` and ``spec_k`` are otherwise
constants fixed at construction: one operating point across bursty,
shifting traffic. The speculation payoff gate (the scheduler's
``_SpecGate``) tunes ONE knob from wall-time EWMAs of both chunk kinds,
with symmetric re-probing and hysteresis; this module is that pattern
as the general mechanism:

- :class:`TunerConfig` declares, per knob, a static candidate ladder
  (e.g. ``decode_chunk in (4, 8, 16)``). Device-shaping knobs
  (:data:`VARIANT_KNOBS`) must name only values the engine declared in
  its ladders (``EngineConfig.decode_chunks`` / ``spec_ks``). In the
  port a ladder is a declared contract, not a set of compiled programs:
  the engine's decode loop takes any chunk length and the verify launch
  any width up to its row bound, and ``Engine.step_async`` refuses a
  value off the ladder exactly as the JAX engine does.
- :class:`Controller` is the live state machine: a wall-time EWMA of
  realized tokens-per-second at each operating point, measuring →
  steady → probing states, one knob moved per probe window (coordinate
  descent — no combinatorial search), probes serialized to one
  in-flight chunk (except the ``pipeline_depth`` knob, whose candidate
  IS the in-flight depth), margin hysteresis on every switch, and hard
  freezes — revert to the BASE operating point, observations ignored —
  during constrained decoding, fault replay, rebuilds, and drain (the
  same exclusions the spec gate honors).
- every decision (probe start/end/abort, switch, freeze) is recorded
  as a flight-recorder event WITH the triggering EWMAs, and every
  observation the decisions derive from is recorded too
  (``tuner_obs``), so :func:`replay_decisions` can re-run the
  controller from a post-mortem bundle's recorded clocks and reproduce
  the decision sequence bit-identically — a bad tuning trajectory is a
  replayable incident, not an anecdote. The same observations give the
  JAX package's controller the same decisions, EWMAs bit for bit.

The module is import-light (stdlib only — no torch, no numpy): the
``telemetry.replay`` report path must be able to re-run a bundle's
tuning decisions with no torch installed. Validation against the
engine's ladders lives in the scheduler (which holds the engine); the
pure arithmetic lives here.

Measurement convention: one sample per fetched chunk,
``tokens * depth_at_dispatch / chunk_wall`` — the depth normalization
makes samples comparable across operating points (at depth d the
dispatch-to-fetch wall includes waiting behind d-1 earlier chunks),
while still crediting depth for the host time it hides (a depth-1
chunk's wall carries the host gap a pipelined chunk overlaps away).
Tokens are the chunk's ACTUAL ingested emissions, so a chunk too wide
for the slots' remaining budgets is honestly charged for its pad
columns. Watchdog-tripped chunks are excluded upstream, exactly like
the overload EWMA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

#: the tunable knobs, in canonical order (the order point keys
#: serialize in, and the coordinate-descent round-robin order)
KNOBS: Tuple[str, ...] = ("decode_chunk", "pipeline_depth",
                          "max_admit_batch", "spec_k")

#: knobs whose candidate values shape the device work of a decode
#: chunk, mapped to the engine property that holds the declared ladder
#: (``Engine.decode_chunks`` / ``Engine.spec_ks``). The scheduler
#: validates every declared candidate against that ladder at
#: construction, and ``Engine.step_async`` refuses a value off it, so a
#: tuner can never dispatch an undeclared variant mid-serve. Host-level
#: knobs (``pipeline_depth``, ``max_admit_batch``) shape no device work
#: and need no declaration.
VARIANT_KNOBS: Dict[str, str] = {
    "decode_chunk": "decode_chunks",
    "spec_k": "spec_ks",
}

#: ``serving_tuner_state`` gauge values
TUNER_FROZEN, TUNER_MEASURING, TUNER_STEADY, TUNER_PROBING = \
    0.0, 1.0, 2.0, 3.0


@dataclasses.dataclass(frozen=True)
class TunerConfig:
    """Knob ladders + controller policy. A ``None`` ladder leaves that
    knob untouched at its configured value; a declared ladder must
    contain the configured value (the BASE operating point the
    controller starts from and hard-freezes back to).

    ``max_admit_batch`` ladders use ``0`` for "unlimited" (the
    scheduler's ``max_admit_batch=None``); ``spec_k`` ladders use ``0``
    for the plain step variant, and every non-zero rung must be a
    declared ``EngineConfig.spec_ks`` rung."""

    #: tokens per decode dispatch — each rung must be in
    #: ``EngineConfig.decode_chunks``
    decode_chunk: Optional[Tuple[int, ...]] = None
    #: decode chunks kept in flight by the scheduler (host knob)
    pipeline_depth: Optional[Tuple[int, ...]] = None
    #: admission-wave cap (host knob; 0 = unlimited)
    max_admit_batch: Optional[Tuple[int, ...]] = None
    #: speculative draft width — 0 = plain; non-zero rungs must be in
    #: ``EngineConfig.spec_ks``. Owning this knob replaces the
    #: ``_SpecGate`` (one controller per knob, never two).
    spec_k: Optional[Tuple[int, ...]] = None
    #: weight of the newest tokens-per-second sample in every EWMA
    ewma_alpha: float = 0.3
    #: a challenger displaces the incumbent only when its EWMA clears
    #: the incumbent's by this factor (hysteresis — staying is free)
    margin: float = 1.05
    #: incumbent chunks between probe windows — the symmetric re-probe
    #: cadence: every candidate is re-measured on this beat, and the
    #: incumbent's own EWMA refreshes continuously in between, so
    #: neither side ever goes stale
    probe_every: int = 32
    #: chunks measured per probe window before the switch/revert
    #: decision
    probe_chunks: int = 4
    #: incumbent chunks measured before the controller probes at all
    min_measure_chunks: int = 4

    def ladders(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Declared ``(knob, candidates)`` pairs in :data:`KNOBS`
        order."""
        out = []
        for name in KNOBS:
            v = getattr(self, name)
            if v is not None:
                out.append((name, tuple(int(x) for x in v)))
        return out


def ewma(prev: float, sample: float, alpha: float) -> float:
    """THE zero-bootstrap EWMA (first sample seeds it) — one spelling
    shared by the Controller and the scheduler's ``_SpecGate`` so the
    two controllers' break-even arithmetic can never drift apart."""
    return sample if prev == 0.0 else (1 - alpha) * prev + alpha * sample


def point_key(point: Dict[str, int]) -> str:
    """Canonical string form of an operating point (the ``tuner_obs``
    event field): ``"decode_chunk=8,spec_k=0"`` in :data:`KNOBS`
    order."""
    return ",".join(f"{k}={point[k]}" for k in KNOBS if k in point)


def parse_point(key: str) -> Dict[str, int]:
    """Inverse of :func:`point_key`."""
    out: Dict[str, int] = {}
    for part in key.split(","):
        if part:
            k, _, v = part.partition("=")
            out[k] = int(v)
    return out


class Controller:
    """The live knob state machine — pure host arithmetic; its output
    only ever picks which DECLARED ladder variant (and host
    depth/admit-cap) the next dispatch uses.

    ``base`` is the configured operating point (one value per declared
    knob); it is both the starting incumbent and the hard-freeze
    fallback. ``recorder`` (optional, a
    :class:`~apex_tpu_torch.telemetry.flightrec.FlightRecorder`) receives
    ``tuner_obs`` per observation and ``tuner_probe`` / ``tuner_switch``
    / ``tuner_freeze`` per decision; ``on_switch(knob)`` is the
    telemetry counter hook.

    The scheduler drives three entry points per chunk:
    :meth:`want_dispatch` before dispatching (``None`` = hold this
    tick, a probe chunk is still in flight), :meth:`observe` after the
    fetch, and :meth:`freeze`/:meth:`thaw` as the exclusion conditions
    come and go. All state transitions happen inside
    ``observe``/``freeze``/``thaw`` — every input is recorded, which is
    what makes :func:`replay_decisions` exact."""

    __slots__ = ("cfg", "knobs", "base", "incumbent", "ewma",
                 "incumbent_ewma", "samples", "since_probe", "probe",
                 "probe_seen", "probes_total", "switch_counts",
                 "frozen", "recorder", "on_switch", "_knob_order",
                 "_knob_i", "_cand_i", "ttft_ewma", "ttft_counts")

    def __init__(self, cfg: TunerConfig, base: Dict[str, int], *,
                 recorder=None,
                 on_switch: Optional[Callable[[str], None]] = None):
        ladders = cfg.ladders()
        if not ladders:
            raise ValueError(
                "TunerConfig declares no knob ladder — nothing to tune")
        if not 0.0 < cfg.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha {cfg.ewma_alpha} outside (0, 1]")
        if cfg.margin < 1.0:
            raise ValueError(
                f"margin {cfg.margin} must be >= 1.0 (a sub-unity margin "
                f"would switch on measurements WORSE than the incumbent)")
        for n in ("probe_every", "probe_chunks", "min_measure_chunks"):
            if getattr(cfg, n) < 1:
                raise ValueError(f"{n} {getattr(cfg, n)} must be >= 1")
        self.cfg = cfg
        self.knobs: Dict[str, Tuple[int, ...]] = {}
        for name, cands in ladders:
            lo = 1 if name in ("decode_chunk", "pipeline_depth") else 0
            if list(cands) != sorted(set(cands)) or (
                    cands and cands[0] < lo):
                raise ValueError(
                    f"{name} ladder must be strictly increasing with "
                    f"values >= {lo}, got {cands}")
            if name not in base:
                raise ValueError(
                    f"no base value for declared knob {name!r}")
            if int(base[name]) not in cands:
                raise ValueError(
                    f"base {name}={base[name]} is not on its ladder "
                    f"{cands} — the configured operating point must be "
                    f"a candidate (it is the freeze fallback)")
            self.knobs[name] = cands
        self.base = {k: int(base[k]) for k in self.knobs}
        self.incumbent = dict(self.base)
        #: tokens-per-second EWMA per (knob, candidate) — refreshed
        #: whenever a chunk runs with that candidate active (incumbent
        #: chunks refresh every incumbent value; probe chunks refresh
        #: the challenged one)
        self.ewma: Dict[Tuple[str, int], float] = {}
        #: tokens-per-second EWMA of the FULL incumbent operating
        #: point — the side every challenger must clear by ``margin``
        self.incumbent_ewma = 0.0
        self.samples = 0
        self.since_probe = 0
        #: the active probe window, (knob, candidate) — None in
        #: measuring/steady
        self.probe: Optional[Tuple[str, int]] = None
        self.probe_seen = 0
        self.probes_total = 0
        self.switch_counts: Dict[str, int] = {k: 0 for k in self.knobs}
        #: TTFT EWMA per full operating point (point_key → seconds) —
        #: OBSERVATION only: the admission knobs shape TTFT, not
        #: decode tok/s, so a future
        #: latency-aware policy needs per-point TTFT measured alongside
        #: the tok/s EWMAs before it can earn movement. Decisions still
        #: derive exclusively from tok/s.
        self.ttft_ewma: Dict[str, float] = {}
        self.ttft_counts: Dict[str, int] = {}
        #: freeze cause while hard-frozen (None = live)
        self.frozen: Optional[str] = None
        self.recorder = recorder
        self.on_switch = on_switch
        # coordinate-descent cursor: knobs round-robin, candidates
        # cycle within each knob (skipping the incumbent at pick time)
        self._knob_order = [k for k, c in self.knobs.items()
                            if len(c) > 1]
        if not self._knob_order:
            raise ValueError(
                f"every declared ladder has a single candidate "
                f"({ {k: v for k, v in self.knobs.items()} }) — "
                f"nothing can ever be probed; a silently inert "
                f"controller would read as autotuning that is not "
                f"happening")
        self._knob_i = 0
        self._cand_i = {k: 0 for k in self._knob_order}

    # -- the dispatch side ---------------------------------------------------

    def current_point(self) -> Dict[str, int]:
        """The operating point the next dispatch WOULD run (ignoring
        probe serialization): base while frozen, the probe point during
        a probe window, the incumbent otherwise. The scheduler applies
        its host-level knobs (depth, admit cap) from this each tick."""
        if self.frozen is not None:
            return dict(self.base)
        if self.probe is not None:
            p = dict(self.incumbent)
            p[self.probe[0]] = self.probe[1]
            return p
        return dict(self.incumbent)

    def want_dispatch(self, inflight: int) -> Optional[Dict[str, int]]:
        """The operating point for the next chunk, or ``None`` to hold
        the dispatch this tick: probe chunks are serialized to ONE in
        flight (clean walls, and no mixing of operating points inside a
        window) — except when the probed knob is ``pipeline_depth``,
        whose candidate IS the in-flight depth being measured."""
        if self.frozen is None and self.probe is not None \
                and self.probe[0] != "pipeline_depth" and inflight > 0:
            return None
        return self.current_point()

    # -- the fetch side ------------------------------------------------------

    def observe(self, point: Dict[str, int], tokens: int, wall_s: float,
                depth: int) -> None:
        """Fold one fetched chunk's measurement into the EWMAs and run
        any decision it triggers (probe end → switch/revert, probe
        start). ``point`` is the operating point the chunk was
        DISPATCHED at (attribution is per chunk, so leftovers from a
        pre-switch point never pollute the new incumbent's EWMA).
        Recorded as a ``tuner_obs`` event — the replayable input every
        decision derives from. Ignored while frozen (constrained /
        replay / rebuild traffic is atypical by construction; folding
        it in would poison the EWMAs the freeze exists to protect)."""
        if self.frozen is not None:
            return
        if self.recorder is not None:
            self.recorder.record("tuner_obs", point_key(point),
                                 int(tokens), float(wall_s), int(depth))
        self._observe(point, tokens, wall_s, depth)

    def _observe(self, point: Dict[str, int], tokens: int,
                 wall_s: float, depth: int) -> None:
        """The recording-free arithmetic (the half
        :func:`replay_decisions` re-runs on recorded inputs)."""
        if self.frozen is not None or tokens <= 0 or wall_s <= 0.0:
            return
        point = {k: point[k] for k in self.knobs}
        sample = tokens * max(depth, 1) / wall_s
        if self.probe is not None:
            knob, val = self.probe
            probe_point = dict(self.incumbent)
            probe_point[knob] = val
            if point == probe_point:
                key = (knob, val)
                self.ewma[key] = self._ewma(self.ewma.get(key, 0.0),
                                            sample)
                self.probe_seen += 1
                if self.probe_seen >= self.cfg.probe_chunks:
                    self._decide()
                return
            # a leftover chunk from another point landing mid-window:
            # attribute it (below) but never let it advance the window
        if point != self.incumbent:
            return  # stale pre-switch chunk — no attribution
        self.incumbent_ewma = self._ewma(self.incumbent_ewma, sample)
        for k, v in point.items():
            self.ewma[(k, v)] = self._ewma(self.ewma.get((k, v), 0.0),
                                           sample)
        self.samples += 1
        if self.probe is not None \
                or self.samples < self.cfg.min_measure_chunks:
            return
        self.since_probe += 1
        if self.since_probe >= self.cfg.probe_every:
            self._start_probe()

    def _ewma(self, prev: float, sample: float) -> float:
        return ewma(prev, sample, self.cfg.ewma_alpha)

    def observe_ttft(self, ttft_s: float) -> None:
        """Fold one request's time-to-first-token into the EWMA of the
        operating point it admitted under (:meth:`current_point` — the
        point the admission dispatch ran). Pure observation: no
        decision reads it yet (latency-aware control is the declared
        next step, and it needs this record to exist first). Ignored
        while frozen, like :meth:`observe` — freeze-window traffic is
        atypical by construction."""
        if self.frozen is not None or ttft_s <= 0.0:
            return
        key = point_key(self.current_point())
        if self.recorder is not None:
            self.recorder.record("tuner_ttft", key, float(ttft_s))
        self.ttft_ewma[key] = ewma(self.ttft_ewma.get(key, 0.0),
                                   ttft_s, self.cfg.ewma_alpha)
        self.ttft_counts[key] = self.ttft_counts.get(key, 0) + 1

    def ttft_by_point(self) -> Dict[str, Dict[str, float]]:
        """Per-operating-point TTFT observations:
        ``{point_key: {"ttft_ewma_s", "count"}}`` — the record the next
        latency-aware policy will read."""
        return {k: {"ttft_ewma_s": self.ttft_ewma[k],
                    "count": float(self.ttft_counts.get(k, 0))}
                for k in sorted(self.ttft_ewma)}

    # -- decisions -----------------------------------------------------------

    def _start_probe(self) -> None:
        """Open the next probe window: ONE knob moved to its next
        non-incumbent candidate (coordinate descent — knobs round-
        robin, candidates cycle within each knob)."""
        for _ in range(len(self._knob_order)):
            knob = self._knob_order[self._knob_i]
            self._knob_i = (self._knob_i + 1) % len(self._knob_order)
            cands = [v for v in self.knobs[knob]
                     if v != self.incumbent[knob]]
            if not cands:
                continue
            val = cands[self._cand_i[knob] % len(cands)]
            self._cand_i[knob] += 1
            self.probe = (knob, val)
            self.probe_seen = 0
            self.probes_total += 1
            if self.recorder is not None:
                self.recorder.record("tuner_probe", knob, val, "start",
                                     self.ewma.get((knob, val), 0.0),
                                     self.incumbent_ewma)
            # the window measures THIS regime only: a candidate EWMA
            # left over from another workload phase (or another
            # incumbent on the other knobs) would carry
            # (1-alpha)^probe_chunks stale weight into a 5%-margin
            # decision — fresh window, fresh measurement; freshness
            # across regimes is the re-probe cadence's job
            self.ewma.pop((knob, val), None)
            return

    def _decide(self) -> None:
        """Close the probe window: the challenger displaces the
        incumbent only when its EWMA clears the incumbent's by
        ``margin`` (hysteresis — reverting costs nothing, so a noisy
        tie keeps the devil we know)."""
        knob, val = self.probe
        cand = self.ewma.get((knob, val), 0.0)
        inc = self.incumbent_ewma
        self.probe = None
        self.probe_seen = 0
        self.since_probe = 0
        if self.recorder is not None:
            self.recorder.record("tuner_probe", knob, val, "end", cand,
                                 inc)
        if inc > 0.0 and cand > inc * self.cfg.margin:
            old = self.incumbent[knob]
            self.incumbent[knob] = val
            self.switch_counts[knob] += 1
            if self.recorder is not None:
                self.recorder.record("tuner_switch", knob, old, val,
                                     cand, inc)
            if self.on_switch is not None:
                self.on_switch(knob)
            # the probe window measured exactly the new full operating
            # point — seed the incumbent EWMA from it (it keeps
            # refreshing every incumbent chunk from here)
            self.incumbent_ewma = cand

    # -- hard freezes --------------------------------------------------------

    def freeze(self, cause: str) -> None:
        """Hard-freeze to the BASE operating point: an active probe
        window is aborted (no decision from partial, atypical data) and
        observations are ignored until :meth:`thaw`. Idempotent per
        cause; a cause CHANGE records a fresh enter event (the replay
        input stream must see it)."""
        if self.frozen == cause:
            return
        if self.frozen is None and self.probe is not None:
            knob, val = self.probe
            self.probe = None
            self.probe_seen = 0
            if self.recorder is not None:
                self.recorder.record("tuner_probe", knob, val, "abort",
                                     self.ewma.get((knob, val), 0.0),
                                     self.incumbent_ewma)
        self.frozen = cause
        if self.recorder is not None:
            self.recorder.record("tuner_freeze", "enter", cause)

    def thaw(self) -> None:
        """Lift a freeze (no-op when live)."""
        if self.frozen is None:
            return
        if self.recorder is not None:
            self.recorder.record("tuner_freeze", "exit", self.frozen)
        self.frozen = None

    # -- reporting -----------------------------------------------------------

    def state(self) -> float:
        """``serving_tuner_state`` gauge value: 0 frozen, 1 measuring,
        2 steady, 3 probing."""
        if self.frozen is not None:
            return TUNER_FROZEN
        if self.probe is not None:
            return TUNER_PROBING
        if self.samples < self.cfg.min_measure_chunks:
            return TUNER_MEASURING
        return TUNER_STEADY


#: event names the controller emits as decisions (everything except
#: the ``tuner_obs`` inputs) — the sequence replay compares
DECISION_EVENTS = ("tuner_probe", "tuner_switch", "tuner_freeze")


def _event_fields(ev: Dict[str, Any]) -> List[Any]:
    from apex_tpu_torch.telemetry.flightrec import EVENT_FIELDS

    return [ev.get(f) for f in EVENT_FIELDS[ev["event"]]]


def replay_decisions(cfg: TunerConfig, base: Dict[str, int],
                     events: Iterable[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Re-run a fresh :class:`Controller` over a bundle's recorded
    inputs — ``tuner_obs`` observations and ``tuner_freeze``
    enter/exit transitions, in recorded sequence order — and return
    the decision events it regenerates. Pure host arithmetic on
    recorded clocks: bit-identical to the original run's decisions by
    construction (the comparison :func:`compare_decisions` asserts)."""
    from apex_tpu_torch.telemetry.flightrec import FlightRecorder

    rec = FlightRecorder(clock=lambda: 0.0)
    ctl = Controller(cfg, base, recorder=rec)
    for ev in events:
        name = ev.get("event")
        if name == "tuner_obs":
            ctl._observe(parse_point(ev["point"]), ev["tokens"],
                         ev["wall_s"], ev["depth"])
        elif name == "tuner_freeze":
            if ev.get("phase") == "enter":
                ctl.freeze(ev.get("cause"))
            else:
                ctl.thaw()
    return [e for e in rec.to_dicts(rec.events())
            if e["event"] in DECISION_EVENTS]


def compare_decisions(cfg: TunerConfig, base: Dict[str, int],
                      events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The bundle-side check: replay the recorded inputs and compare
    the regenerated decision sequence against the recorded one,
    seq-for-seq and field-for-field. Returns the machine-readable
    verdict (``mismatches`` empty = the trajectory replays exactly)."""
    events = sorted(events, key=lambda e: e.get("seq", 0))
    recorded = [e for e in events if e.get("event") in DECISION_EVENTS]
    replayed = replay_decisions(cfg, base, events)
    mismatches: List[Dict[str, Any]] = []
    for i in range(max(len(recorded), len(replayed))):
        a = recorded[i] if i < len(recorded) else None
        b = replayed[i] if i < len(replayed) else None
        if a is None or b is None or a["event"] != b["event"] \
                or _event_fields(a) != _event_fields(b):
            mismatches.append({"index": i, "recorded": a,
                               "replayed": b})
    return {
        "decisions_recorded": len(recorded),
        "decisions_replayed": len(replayed),
        "mismatches": mismatches,
    }
