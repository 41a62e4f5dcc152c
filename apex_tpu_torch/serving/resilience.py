"""Fault injection, failure isolation and live health for serving.

The port's copy of ``apex_tpu/serving/resilience.py`` (the port imports
nothing of the JAX package). Four host-side pieces; none launches
anything on the device, so the happy path pays nothing:

- :class:`FaultPlan` — a deterministic, replayable chaos harness: each
  engine seam (``admit`` / ``dispatch`` / ``fetch`` / ``retire``, plus the
  scheduler's ``submit``) counts its calls, and a plan maps call indices
  to injected faults (raised device errors, invalid-token batches,
  artificial hangs, queue floods). Seeded plans
  (:meth:`FaultPlan.random`) draw the JAX package's specs for the same
  seed (``random.Random``), so a chaos soak reruns exactly.
- Failure-domain isolation — a fault poisons the engine's cache and
  state (:class:`EngineFault`); recovery rebuilds them in place
  (``Engine.rebuild_slots``) and replays interrupted requests from their
  prompts. Generation is per-request deterministic, so the replayed
  stream is the one the client was being sent and the tokens it already
  saw are re-derived and suppressed. Affected requests get bounded
  retries with exponential backoff and per-request ``error`` events.
- Overload protection — deadline-aware admission shedding, structured
  ``QueueFull`` backpressure with a retry-after hint, and a fetch
  watchdog that flags hung dispatches.
- :class:`HealthMonitor` — the ``ok → degraded → draining → failed``
  state machine driven by detected faults, watchdog trips, retry
  exhaustion and queue saturation, exported as the
  ``serving_health_state`` gauge and as a ``/healthz`` callback (200
  while traffic should keep flowing, 503 when it should stop).

:func:`sigkill_drill` is the crash drill the write-ahead journal
(:mod:`.journal`) is judged by: a serving child killed with SIGKILL
mid-stream, recovered from its journal in a fresh process.

Standard library only: the chaos harness imports wherever the telemetry
layer does. Injected faults are host exceptions; a real CUDA error is
not caught and carried on from — it propagates.
"""

from __future__ import annotations

import dataclasses
import random as _random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# -- fault vocabulary --------------------------------------------------------

#: a raised error at the seam (an exception escaping the device call; it
#: poisons the engine's cache and state)
KIND_ERROR = "error"
#: an invalid-token batch (what a NaN logit batch produces downstream:
#: out-of-vocab token ids in the fetched host array)
KIND_NAN = "nan"
#: an artificial dispatch hang, observed at fetch (the watchdog's prey)
KIND_HANG = "hang"
#: a queue flood: the submit seam reports the queue saturated
KIND_FLOOD = "flood"

FAULT_KINDS = (KIND_ERROR, KIND_NAN, KIND_HANG, KIND_FLOOD)

#: engine seams (``admit``/``dispatch``/``fetch``/``retire``) + the
#: scheduler's intake seam (``submit``, the only place a flood makes
#: sense)
FAULT_POINTS = ("admit", "dispatch", "fetch", "retire", "submit")

#: which kinds are meaningful at which seam
_VALID = {
    "admit": (KIND_ERROR, KIND_NAN),
    "dispatch": (KIND_ERROR, KIND_HANG),
    "fetch": (KIND_ERROR, KIND_NAN, KIND_HANG),
    "retire": (KIND_ERROR,),
    "submit": (KIND_FLOOD,),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: the ``index``-th call at ``point`` (0-based,
    counted per seam) misbehaves as ``kind``. ``slots`` are the lanes an
    invalid-token batch corrupts (admit: batch rows; fetch: engine
    slots); ``hang_s`` is the artificial stall of a ``hang``; ``token``
    is the injected out-of-vocab id (< 0 or >= vocab both detect)."""

    point: str
    index: int
    kind: str
    slots: Tuple[int, ...] = (0,)
    hang_s: float = 0.0
    token: int = -1

    def describe(self) -> str:
        extra = f" hang={self.hang_s}s" if self.kind == KIND_HANG else (
            f" slots={list(self.slots)}" if self.kind == KIND_NAN else "")
        return f"{self.kind}@{self.point}[{self.index}]{extra}"


class FaultPlan:
    """A deterministic schedule of injected faults over the engine's
    seams. Each seam keeps a monotonic call counter; :meth:`take`
    advances it and returns the planned :class:`FaultSpec` for that
    call, if any — so a plan replays exactly given the same request
    trace. ``hang_fn`` implements the stall (default ``time.sleep``);
    tests inject a fake-clock advance instead.

    >>> plan = FaultPlan([FaultSpec("fetch", 2, "nan", slots=(1,))])
    >>> eng = Engine(cfg, params, ecfg, fault_plan=plan)
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 hang_fn: Callable[[float], None] = time.sleep):
        by_point: Dict[str, Dict[int, FaultSpec]] = {}
        for s in specs:
            if s.point not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {s.point!r}; one of "
                    f"{FAULT_POINTS}")
            if s.kind not in _VALID[s.point]:
                raise ValueError(
                    f"fault kind {s.kind!r} not injectable at "
                    f"{s.point!r} (valid: {_VALID[s.point]})")
            if s.index < 0:
                raise ValueError(f"fault index {s.index} must be >= 0")
            slot = by_point.setdefault(s.point, {})
            if s.index in slot:
                raise ValueError(
                    f"duplicate fault at {s.point}[{s.index}] — one "
                    f"fault per (point, call) keeps plans replayable")
            slot[s.index] = s
        self._by_point = by_point
        self.hang_fn = hang_fn
        self._counts = {p: 0 for p in FAULT_POINTS}
        #: specs that fired, in firing order
        self.injected: List[FaultSpec] = []
        #: optional observer called with each FaultSpec the moment it
        #: fires (the scheduler wires the flight recorder here)
        self.on_inject: Optional[Callable[[FaultSpec], None]] = None

    @classmethod
    def random(cls, seed: int, n_faults: int = 3, *,
               points: Sequence[str] = ("admit", "dispatch", "fetch"),
               max_index: int = 24, slots: int = 4, hang_s: float = 0.0,
               hang_fn: Callable[[float], None] = time.sleep
               ) -> "FaultPlan":
        """A seeded random plan: ``n_faults`` faults scattered over
        ``points`` within the first ``max_index`` calls of each,
        reproducible from ``seed`` (``random.Random``, no global
        state)."""
        rng = _random.Random(seed)
        specs: List[FaultSpec] = []
        used = set()
        while len(specs) < n_faults and len(used) < len(points) * max_index:
            point = rng.choice(list(points))
            index = rng.randrange(max_index)
            if (point, index) in used:
                continue
            used.add((point, index))
            kind = rng.choice(_VALID[point])
            specs.append(FaultSpec(
                point, index, kind,
                slots=(rng.randrange(max(slots, 1)),),
                hang_s=hang_s if kind == KIND_HANG else 0.0))
        return cls(specs, hang_fn=hang_fn)

    @property
    def specs(self) -> Tuple[FaultSpec, ...]:
        return tuple(s for by in self._by_point.values()
                     for s in by.values())

    def take(self, point: str) -> Optional[FaultSpec]:
        """Advance ``point``'s call counter; return the fault planned
        for this call (recording it in :attr:`injected`), or None."""
        i = self._counts[point]
        self._counts[point] = i + 1
        spec = self._by_point.get(point, {}).get(i)
        if spec is not None:
            self.injected.append(spec)
            if self.on_inject is not None:
                self.on_inject(spec)
        return spec

    def counts(self) -> Dict[str, int]:
        """Calls seen per seam so far."""
        return dict(self._counts)

    def reset(self) -> "FaultPlan":
        """Rewind the counters and the firing record — the same plan
        replays over a fresh trace."""
        self._counts = {p: 0 for p in FAULT_POINTS}
        self.injected = []
        return self


def parse_fault_plan(text: str, *,
                     hang_fn: Callable[[float], None] = time.sleep
                     ) -> FaultPlan:
    """The CLI spelling of a plan: ``random:SEED[:N]`` or a comma list of
    ``point:index:kind[:arg]``, ``arg`` being ``hang_s`` for hangs and a
    slot index for nan faults — e.g. ``"fetch:2:nan:1,dispatch:5:error"``."""
    text = text.strip()
    if text.startswith("random:"):
        parts = text.split(":")
        seed = int(parts[1])
        n = int(parts[2]) if len(parts) > 2 else 3
        return FaultPlan.random(seed, n, hang_fn=hang_fn)
    specs = []
    for item in text.split(","):
        parts = item.strip().split(":")
        if len(parts) < 3:
            raise ValueError(
                f"fault spec {item!r}: want point:index:kind[:arg]")
        point, index, kind = parts[0], int(parts[1]), parts[2]
        kw: Dict[str, object] = {}
        if len(parts) > 3:
            if kind == KIND_HANG:
                kw["hang_s"] = float(parts[3])
            else:
                kw["slots"] = (int(parts[3]),)
        specs.append(FaultSpec(point, index, kind, **kw))
    return FaultPlan(specs, hang_fn=hang_fn)


class FleetFaultPlan:
    """Per-replica :class:`FaultPlan` schedule for a fleet: replica
    ``i``'s engine is built with ``fleet_plan[i]``, every plan is
    deterministic on its own, and a kill-one-replica-mid-burst soak
    replays exactly from its seed.

    >>> plans = FleetFaultPlan.kill(1, 2, at=4)   # replica 1 dies
    >>> engines = [Engine(cfg, params, ecfg, fault_plan=plans[i])
    ...            for i in range(2)]
    """

    def __init__(self, plans: Sequence[FaultPlan]):
        self.plans: Tuple[FaultPlan, ...] = tuple(plans)
        if not self.plans:
            raise ValueError("a fleet plan needs at least one replica")

    def __len__(self) -> int:
        return len(self.plans)

    def __getitem__(self, i: int) -> FaultPlan:
        return self.plans[i]

    def __iter__(self):
        return iter(self.plans)

    @classmethod
    def random(cls, seed: int, n_replicas: int, n_faults: int = 3,
               **kw) -> "FleetFaultPlan":
        """A seeded random plan per replica, from derived seeds."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas {n_replicas} must be >= 1")
        return cls([FaultPlan.random(seed * 1_000_003 + i, n_faults,
                                     **kw)
                    for i in range(n_replicas)])

    @classmethod
    def kill(cls, replica: int, n_replicas: int, *, at: int = 4,
             rebuilds: int = 4) -> "FleetFaultPlan":
        """Terminally fail ``replica`` at its ``at``-th decode dispatch:
        ``rebuilds`` consecutive dispatch errors with no healthy chunk
        between them exhaust the scheduler's ``max_consecutive_rebuilds``
        (default 3, so the default ``rebuilds=4`` crosses it) and the
        health machine goes ``failed``. Every other replica's plan is
        empty. Pair the victim's scheduler with ``ResilienceConfig(
        max_retries >= rebuilds)``: with fewer retries a router's
        retry-exhaustion failover can move every live request off the
        replica before the last dispatch index is reached, and the
        replica survives degraded instead of failing."""
        if not 0 <= replica < n_replicas:
            raise ValueError(
                f"replica {replica} outside fleet [0, {n_replicas})")
        specs = [FaultSpec("dispatch", at + j, KIND_ERROR)
                 for j in range(rebuilds)]
        return cls([FaultPlan(specs if i == replica else ())
                    for i in range(n_replicas)])

    @property
    def injected(self) -> List[FaultSpec]:
        """Every fault that fired, across replicas, in replica order."""
        return [s for p in self.plans for s in p.injected]

    def describe(self) -> str:
        return "; ".join(
            f"r{i}=[{', '.join(s.describe() for s in p.specs)}]"
            for i, p in enumerate(self.plans) if p.specs) or "no faults"

    def reset(self) -> "FleetFaultPlan":
        for p in self.plans:
            p.reset()
        return self


# -- exceptions --------------------------------------------------------------


class EngineFault(RuntimeError):
    """A failure at an engine seam that invalidates the cache and state.
    The engine refuses further device calls until
    :meth:`~apex_tpu_torch.serving.engine.Engine.rebuild_slots` rebuilds
    them (a poisoned buffer must never serve)."""

    def __init__(self, message: str, *, point: str = "",
                 spec: Optional[FaultSpec] = None):
        super().__init__(message)
        self.point = point
        self.spec = spec


class InjectedFault(EngineFault):
    """An :class:`EngineFault` raised by a :class:`FaultPlan` rather than
    a real device failure."""


class EngineFailed(RuntimeError):
    """The health machine reached ``failed`` (terminal): recovery was
    exhausted and the scheduler ended all work with ``error`` outcomes.
    New submissions are refused."""


# -- health state machine ----------------------------------------------------

HEALTH_OK = "ok"
HEALTH_DEGRADED = "degraded"
HEALTH_DRAINING = "draining"
HEALTH_FAILED = "failed"

#: all states, in gauge-code order: ``serving_health_state`` exports
#: the tuple index (0 = ok .. 3 = failed)
HEALTH_STATES = (HEALTH_OK, HEALTH_DEGRADED, HEALTH_DRAINING,
                 HEALTH_FAILED)


class HealthMonitor:
    """The serving health state machine.

    Any detected fault, watchdog trip or queue saturation degrades (``ok
    → degraded``); ``recovery_chunks`` consecutive healthy decode-chunk
    fetches recover (``degraded → ok``); ``begin_drain``/``end_drain``
    bracket a pipeline drain (``→ draining →`` back to the prior state;
    faults seen mid-drain land in the resume state); ``fail()`` is
    terminal. With a registry the ``serving_health_state`` gauge mirrors
    every transition, and :meth:`healthz` is the ``(status, body)``
    callback a ``/healthz`` route serves — 200 for ok/degraded, 503 for
    draining/failed, the body the state name."""

    def __init__(self, *, registry=None, recovery_chunks: int = 2,
                 on_transition: Optional[
                     Callable[[str, str, Optional[str]], None]] = None):
        if recovery_chunks < 1:
            raise ValueError(
                f"recovery_chunks {recovery_chunks} must be >= 1")
        self.state = HEALTH_OK
        self.recovery_chunks = recovery_chunks
        self.last_cause: Optional[str] = None
        #: optional observer called after each state change with ``(old,
        #: new, last_cause)`` (the scheduler's flight recorder)
        self.on_transition = on_transition
        self._resume = HEALTH_OK  # the state a drain returns to
        self._streak = 0          # consecutive healthy chunks
        self._gauge = self._transitions = None
        if registry is not None:
            self._gauge = registry.gauge(
                "serving_health_state",
                "serving health: 0=ok 1=degraded 2=draining 3=failed")
            self._gauge.set(0)
            tr = registry.counter(
                "serving_health_transitions_total",
                "health state entries, by state", labels=("to",))
            # every state pre-created: scrapes show explicit zeros
            self._transitions = {s: tr.labels(to=s) for s in HEALTH_STATES}

    def _set(self, state: str) -> None:
        if state == self.state:
            return
        old, self.state = self.state, state
        if self._gauge is not None:
            self._gauge.set(HEALTH_STATES.index(state))
            self._transitions[state].inc()
        if self.on_transition is not None:
            self.on_transition(old, state, self.last_cause)

    # -- inputs -------------------------------------------------------------

    def record_fault(self, cause: str) -> None:
        """A detected fault, watchdog trip or overload signal: degrade
        (mid-drain the drain goes on, and resumes degraded)."""
        if self.state == HEALTH_FAILED:
            return
        self.last_cause = cause
        self._streak = 0
        if self.state == HEALTH_DRAINING:
            self._resume = HEALTH_DEGRADED
        else:
            self._set(HEALTH_DEGRADED)

    def record_progress(self) -> None:
        """One healthy decode chunk fetched end to end; enough in a row
        recover a degraded engine."""
        if self.state != HEALTH_DEGRADED:
            return
        self._streak += 1
        if self._streak >= self.recovery_chunks:
            self._set(HEALTH_OK)

    def begin_drain(self) -> None:
        if self.state in (HEALTH_FAILED, HEALTH_DRAINING):
            return
        self._resume = self.state
        self._set(HEALTH_DRAINING)

    def end_drain(self) -> None:
        if self.state == HEALTH_DRAINING:
            self._set(self._resume)

    def fail(self, cause: str) -> None:
        """Terminal: recovery exhausted."""
        self.last_cause = cause
        self._set(HEALTH_FAILED)

    # -- outputs ------------------------------------------------------------

    @property
    def code(self) -> int:
        return HEALTH_STATES.index(self.state)

    def healthz(self) -> Tuple[int, str]:
        """The ``/healthz`` callback: (status code, body). 200 for
        ok/degraded (keep routing traffic), 503 for draining/failed."""
        status = 200 if self.state in (HEALTH_OK, HEALTH_DEGRADED) \
            else 503
        body = self.state + "\n"
        if self.state != HEALTH_OK and self.last_cause:
            body = f"{self.state} ({self.last_cause})\n"
        return status, body


# -- scheduler policy knobs --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Recovery and overload policy of the scheduler, all host-side.
    ``max_retries`` bounds the re-admissions of a request in a fault's
    blast radius (requests merely interrupted by a batch-mate's fault
    replay for free); the backoff before retry ``n`` is
    ``backoff_base_s * backoff_factor**(n-1)`` on the scheduler clock.
    ``watchdog_timeout_s`` flags a decode chunk whose dispatch-to-fetch
    wall time exceeds it (a hung dispatch). ``shed_deadlines`` turns on
    deadline-aware admission shedding (queue position x measured chunk
    latency against the request's deadline). ``max_consecutive_rebuilds``
    caps back-to-back recoveries with no healthy chunk between them
    before the engine is declared failed."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    watchdog_timeout_s: float = 30.0
    shed_deadlines: bool = True
    recovery_chunks: int = 2
    max_consecutive_rebuilds: int = 3

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return self.backoff_base_s * (
            self.backoff_factor ** max(attempt - 1, 0))


# -- crash drill (subprocess SIGKILL + journal recovery) ----------------------

#: the drill's engine geometry: admission groups of one, so a request
#: recovered into another process prefills at its first admission's shape
DRILL_GEOM = dict(slots=2, max_prompt_len=8, max_seq_len=24,
                  decode_chunk=2, admit_batch_sizes=(1,))


def drill_model(preset: str, device: str):
    """The drill's model and weights: ``tiny`` (a 2-layer fp32 GPT of
    vocab 96) or ``355m`` (GPT-2 355M in bf16, flash attention), from
    seed 0 on ``device``."""
    import torch

    from apex_tpu_torch.models import gpt

    if preset == "tiny":
        cfg = gpt.GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                            num_heads=4, seq_len=64, remat=False,
                            compute_dtype=torch.float32)
    else:
        cfg = gpt.GPTConfig(vocab_size=50304, hidden_size=1024,
                            num_layers=24, num_heads=16, seq_len=1024,
                            remat=False, compute_dtype=torch.bfloat16,
                            attn_impl="flash")
    return cfg, gpt.init(cfg, torch.Generator(device).manual_seed(0),
                         device=device)


def drill_requests(n: int, max_tokens: int, seed: int, vocab: int):
    """The drill's trace: prompt ``i`` of ``2 + 3i % 6`` numpy tokens
    from seed ``seed + i``, odd requests sampled (temperature 0.9, top-k
    7, their own seed)."""
    import numpy as np

    from apex_tpu_torch.serving.request import Request, SamplingParams

    out = []
    for i in range(n):
        prompt = np.random.default_rng(seed + i).integers(
            0, vocab, 2 + (3 * i) % 6).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=7, seed=seed + i)
              if i % 2 else SamplingParams())
        out.append(Request(f"d{i}", prompt, max_tokens=max_tokens,
                           sampling=sp))
    return out


#: the drill child: a serving subprocess the parent can SIGKILL
#: mid-stream. "run" serves the drill's trace (journaled with --journal),
#: printing one "TOKENS <n>" progress line a scheduler step — the parent's
#: kill trigger; "recover" rebuilds through journal.recover_scheduler and
#: serves to idle. Both end with one "DONE <json>" line carrying every
#: request's final stream (recover merges the requests the journal shows
#: finished before the crash, so the parent compares whole traces).
#: Source, not a function: the point is a separate process to kill -9.
#: On CUDA the child loads the kernel library the parent's checkout
#: already built (its build directory is keyed by the sources).
_DRILL_CHILD_SRC = '''\
"""Crash-drill child, spawned by resilience.sigkill_drill."""
import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["run", "recover"])
    ap.add_argument("--journal", default=None)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--max-tokens", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--preset", default="tiny", choices=["tiny", "355m"])
    args = ap.parse_args()

    import torch

    from apex_tpu_torch.serving.engine import Engine, EngineConfig
    from apex_tpu_torch.serving.journal import (Journal, recover_scheduler,
                                                replay_state, scan_journal)
    from apex_tpu_torch.serving.resilience import (DRILL_GEOM, drill_model,
                                                   drill_requests)
    from apex_tpu_torch.serving.scheduler import Scheduler

    if args.device == "cpu":
        torch.set_num_threads(1)
    cfg, params = drill_model(args.preset, args.device)

    def build():
        return Engine(cfg, params, EngineConfig(**DRILL_GEOM),
                      device=args.device)

    extra = {}
    if args.mode == "run":
        j = Journal(args.journal) if args.journal else None
        sched = Scheduler(build(), journal=j)
        for r in drill_requests(args.requests, args.max_tokens, args.seed,
                                cfg.vocab_size):
            sched.submit(r)
        while not sched.idle():
            sched.step()
            # the parent's kill trigger: one progress line a step
            print("TOKENS", sched._tokens_emitted, flush=True)
    else:
        t0 = time.monotonic()
        sched, report = recover_scheduler(args.journal, build)
        extra["recovery_ms"] = (time.monotonic() - t0) * 1e3
        extra["report"] = report.as_dict()
        # requests that finished before the crash live only in the
        # journal now: merged, so DONE carries the whole trace
        state = replay_state(scan_journal(args.journal)[0])
        for rid, rq in state.requests.items():
            if rq["finished"]:
                extra.setdefault("prior", {})[rid] = list(rq["emitted"])
        while not sched.idle():
            sched.step()
        extra["journal_fsync_ms"] = sched.journal.fsync_s * 1e3
    done = {rid: {"tokens": list(c.tokens), "reason": c.finish_reason}
            for rid, c in sched.completions.items()}
    print("DONE " + json.dumps({"completions": done, **extra}),
          flush=True)


if __name__ == "__main__":
    main()
'''


def sigkill_drill(workdir: str, *, requests: int = 3,
                  max_tokens: int = 10, kill_after_tokens: int = 6,
                  seed: int = 7000, timeout_s: float = 900.0,
                  python: Optional[str] = None, device: str = "cuda",
                  preset: str = "tiny") -> Dict[str, object]:
    """The crash drill: spawn a serving subprocess journaling to
    ``workdir/journal``, ``kill -9`` it once ``kill_after_tokens``
    tokens have streamed, restart from the journal in a fresh
    subprocess, and compare every request's end-to-end stream with an
    uninterrupted reference child's. The reference child runs beside the
    victim (it journals nothing, so the two share no state). ``device``
    / ``preset`` pick the children's device and model
    (:func:`drill_model`); a CUDA drill raises when there is no card.
    Returns::

        {"parity": bool, "killed_at_tokens": int, "recovery_ms": ...,
         "journal_fsync_ms": ..., "recovered_requests": int,
         "reference": {rid: [tok, ...]}, "recovered": {rid: [...]},
         "child_s": {"reference": s, "victim": s, "recover": s}}"""
    import json as _json
    import os
    import subprocess
    import sys
    import threading

    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("sigkill_drill(device='cuda'): no CUDA "
                               "device; pass device='cpu' for the CPU")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(workdir, exist_ok=True)
    child = os.path.join(workdir, "drill_child.py")
    with open(child, "w", encoding="utf-8") as f:
        f.write(_DRILL_CHILD_SRC)
    journal_dir = os.path.join(workdir, "journal")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    py = python or sys.executable
    base = [py, child, "--requests", str(requests),
            "--max-tokens", str(max_tokens), "--seed", str(seed),
            "--device", device, "--preset", preset]
    child_s: Dict[str, float] = {}

    def _done_line(text: str) -> Dict[str, object]:
        for line in text.splitlines():
            if line.startswith("DONE "):
                return _json.loads(line[5:])
        raise RuntimeError(f"drill child printed no DONE line:\n{text}")

    # 1) the uninterrupted reference (no journal) starts first and runs
    # beside 2) and 3); its output goes to files, so a full pipe never
    # blocks it
    ref_paths = [os.path.join(workdir, f"reference.{x}")
                 for x in ("out", "err")]
    t_ref = time.monotonic()
    with open(ref_paths[0], "w") as out, open(ref_paths[1], "w") as err:
        ref = subprocess.Popen(base + ["run"], env=env, stdout=out,
                               stderr=err)

    def _time_reference():
        ref.wait()
        child_s["reference"] = time.monotonic() - t_ref

    ref_timer = threading.Thread(target=_time_reference, daemon=True)
    ref_timer.start()
    try:
        # 2) the victim: journaled, killed -9 mid-stream on a progress
        # line
        t0 = time.monotonic()
        victim = subprocess.Popen(
            base + ["run", "--journal", journal_dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        killed_at = -1
        try:
            assert victim.stdout is not None
            for line in victim.stdout:
                if line.startswith("TOKENS "):
                    n = int(line.split()[1])
                    if n >= kill_after_tokens:
                        killed_at = n
                        victim.kill()   # SIGKILL: no atexit, no flush
                        break
                elif line.startswith("DONE "):
                    break   # finished before the threshold: no kill
        finally:
            if victim.poll() is None and killed_at < 0:
                victim.kill()
            victim.wait(timeout=timeout_s)
            victim.stdout.close()
        child_s["victim"] = time.monotonic() - t0
        if killed_at < 0:
            raise RuntimeError(
                f"victim finished before streaming {kill_after_tokens} "
                f"tokens — lower kill_after_tokens or raise max_tokens")

        # 3) recover from the journal in a fresh process
        t0 = time.monotonic()
        rec = subprocess.run(base + ["recover", "--journal", journal_dir],
                             env=env, capture_output=True, text=True,
                             timeout=timeout_s)
        child_s["recover"] = time.monotonic() - t0
        if rec.returncode != 0:
            raise RuntimeError(f"recovery run failed:\n{rec.stderr}")
        ref_timer.join(timeout=timeout_s)
    finally:
        if ref.poll() is None:
            ref.kill()
        ref_timer.join()
    with open(ref_paths[0]) as out, open(ref_paths[1]) as err:
        ref_text, ref_errs = out.read(), err.read()
    if ref.returncode != 0:
        raise RuntimeError(f"reference run failed:\n{ref_errs}")
    reference = {rid: c["tokens"] for rid, c in
                 _done_line(ref_text)["completions"].items()}
    payload = _done_line(rec.stdout)
    recovered = {rid: c["tokens"]
                 for rid, c in payload["completions"].items()}
    recovered.update(payload.get("prior", {}))
    return {
        "parity": recovered == reference,
        "killed_at_tokens": killed_at,
        "recovery_ms": payload.get("recovery_ms"),
        "journal_fsync_ms": payload.get("journal_fsync_ms"),
        "recovered_requests": int(
            payload.get("report", {}).get("requests", 0)),
        "reference": reference,
        "recovered": recovered,
        "child_s": child_s,
    }
