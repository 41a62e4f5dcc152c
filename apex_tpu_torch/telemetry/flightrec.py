"""Flight recorder + post-mortem bundles — the serving black box.

Counters say how often something happened; when a stream misbehaves
mid-soak, the state that explains it — scheduler decisions, spec-gate
flips, tuner probes, page swaps and preemptions — is gone by the time
anyone looks. This module keeps it:

- :class:`FlightRecorder` — an always-on bounded structured event log:
  every load-bearing host-side decision (submit/shed, admit dispatch,
  chunk dispatch/fetch, spec-gate and tuner decisions, page swaps,
  preemptions, SLO evaluations) is ONE O(1) tuple append on the hot
  path — no device calls, no dict-per-event, no formatting until
  export. Events carry a monotonic sequence number (ring wraparound
  never reorders or hides a gap) and an injectable clock (the scheduler
  slaves it to its own, so fake-clock tests produce deterministic
  timelines).
- :data:`EVENT_FIELDS` — the event vocabulary: name → positional field
  names, the JAX package's vocabulary entry for entry (events of its
  resilience, fleet and journal layers included, which the port records
  once those layers land). Export zips the hot-path tuples against it.
- :func:`write_bundle` — the atomic post-mortem bundle writer: a
  self-contained directory (event log JSONL, registry snapshot,
  Chrome-trace spans, configs, per-request records, versions)
  materialised via same-dir tmp + ``os.replace``
  (:func:`apex_tpu_torch._atomic.atomic_dir`), so a crash mid-dump never
  leaves a half-written bundle where a post-mortem tool will read it.
  The layout is the JAX package's, so either package's report reads
  the other's bundles.

The scheduler owns the *content* of a bundle
(:meth:`apex_tpu_torch.serving.scheduler.Scheduler.dump_bundle`); this
module owns the mechanics and stays stdlib-only, so ``python -m
apex_tpu_torch.telemetry.replay <bundle> --report`` renders an incident
timeline with no torch installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch import _atomic
from apex_tpu_torch.telemetry.ring import Ring

#: the event vocabulary: name → positional field names of the args
#: tuple a ``record(name, *args)`` call carries. Every recorded name
#: must appear here, as in the JAX package — an event only one side
#: knows about is a silent observability outage, exactly like a renamed
#: metric.
EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    # -- intake ------------------------------------------------------------
    "submit": ("request_id", "prompt_len", "max_tokens", "queue_depth"),
    "submit_terminal": ("request_id",),
    "queue_full": ("request_id", "queue_depth", "injected"),
    "shed": ("request_id", "reason"),
    "queue_expired": ("request_id",),
    # -- admission ---------------------------------------------------------
    "admit": ("request_id", "slot", "bucket", "batch_size", "group",
              "prefix_split"),
    # -- paged KV cache + chunked prefill ----------------------------------
    "page_share": ("request_id", "shared_pages"),
    "pages_exhausted": ("request_id", "needed", "free"),
    "prefill_chunk": ("request_id", "chunk", "chunks_total"),
    # -- host-swap oversubscription (serving.hostswap) -----------------------
    "page_swap_out": ("request_id", "slot", "pages", "bytes"),
    "page_swap_in": ("request_id", "slot", "pages", "policy"),
    "preempt": ("request_id", "slot", "tenant", "pages", "service",
                "candidates"),
    # -- the decode loop ---------------------------------------------------
    "dispatch": ("spec", "ncols", "inflight", "active_slots"),
    "fetch": ("spec", "ncols", "wall_s", "live_rows"),
    "watchdog": ("wall_s",),
    "spec_gate": ("state", "accept_ewma", "break_even"),
    # -- self-tuning control plane (serving.tuner) --------------------------
    "tuner_obs": ("point", "tokens", "wall_s", "depth"),
    "tuner_ttft": ("point", "ttft_s"),
    "tuner_probe": ("knob", "value", "phase", "ewma", "incumbent_ewma"),
    "tuner_switch": ("knob", "from", "to", "ewma", "incumbent_ewma"),
    "tuner_freeze": ("phase", "cause"),
    # -- faults + recovery -------------------------------------------------
    "inject": ("point", "index", "kind"),
    "fault": ("cause", "detail", "affected"),
    "rebuild": ("cause", "wall_s", "consecutive"),
    "replay": ("request_id", "suppress"),
    "retry": ("request_id", "attempts"),
    "retry_exhausted": ("request_id", "attempts"),
    "guard_alarm": ("alarms_total",),
    "health": ("from", "to", "cause"),
    "failed": ("cause",),
    # -- multi-tenant serving (serving.tenancy) ------------------------------
    "tenant_throttle": ("request_id", "tenant", "retry_after_s"),
    "adapter_register": ("name", "adapter", "seed"),
    # -- outcomes ----------------------------------------------------------
    "finish": ("request_id", "reason", "n_tokens"),
    "bundle": ("cause", "path"),
    # -- fleet router (serving.fleet) ---------------------------------------
    "route": ("request_id", "replica", "health", "est_wait_s"),
    "failover": ("replica", "cause", "requests"),
    "drain": ("replica", "phase"),
    "restart": ("replica", "cause"),
    # -- durable request journal (serving.journal) ---------------------------
    "journal_append": ("seq", "kind", "bytes"),
    "journal_rotate": ("segment", "records", "bytes"),
    "recover": ("requests", "adapters", "prefixes", "truncated_bytes"),
    # -- SLO observatory (telemetry.slo) -------------------------------------
    "slo_eval": ("objective", "fast_good", "fast_bad", "slow_good",
                 "slow_bad"),
    "slo_state": ("objective", "from", "to", "fast_burn", "slow_burn"),
    "slo_alert": ("objective", "state", "burn"),
    "slo_sketch": ("metric", "tenant", "count", "p50", "p95", "p99"),
}


class FlightRecorder:
    """Bounded always-on structured event log.

    >>> rec = FlightRecorder()
    >>> sched = Scheduler(engine, recorder=rec, bundle_dir="incidents")
    >>> rec.tail(3)     # the last three decisions, as dicts

    ``capacity`` bounds host memory (the ring keeps the newest events;
    ``summary()`` reports how many were dropped so a truncated log is
    never mistaken for a complete one). ``clock`` must be monotonic
    seconds; the scheduler slaves it to its own clock at construction,
    exactly like the span recorder, so injected test clocks yield
    deterministic timelines. ``record`` is the hot path: one tuple
    allocation + one ring append, nothing else — field names are only
    zipped in at export time (:meth:`tail` / :meth:`to_dicts`).
    """

    __slots__ = ("_events", "clock", "_seq")

    def __init__(self, capacity: int = 65536,
                 clock=time.monotonic):
        self._events = Ring(capacity)
        self.clock = clock
        self._seq = 0

    # -- recording (hot path) ----------------------------------------------

    def record(self, name: str, *args: Any) -> None:
        """O(1): stamp one event. ``args`` are positional per
        :data:`EVENT_FIELDS` (unvalidated here — the hot path pays no
        lookup; tests police the vocabulary)."""
        self._seq += 1
        self._events.append((self._seq, self.clock(), name, args))

    # -- export -------------------------------------------------------------

    @property
    def seq(self) -> int:
        """Sequence number of the newest event (0 = none yet)."""
        return self._seq

    def events(self) -> List[tuple]:
        """Retained ``(seq, t, name, args)`` tuples, oldest first."""
        return self._events.values()

    @staticmethod
    def to_dicts(events) -> List[Dict[str, Any]]:
        """Zip raw event tuples against :data:`EVENT_FIELDS`. Unknown
        names (a vocabulary drift) keep their
        args under ``"args"`` instead of being dropped — a post-mortem
        must never lose data to a rename."""
        out = []
        for seq, t, name, args in events:
            d: Dict[str, Any] = {"seq": seq, "t": t, "event": name}
            fields = EVENT_FIELDS.get(name)
            if fields is None or len(fields) < len(args):
                d["args"] = list(args)
            else:
                d.update(zip(fields, args))
            out.append(d)
        return out

    def tail(self, n: int = 256) -> List[Dict[str, Any]]:
        """The newest ``n`` events as dicts, oldest first — the
        ``/debug/events`` payload."""
        evs = self._events.values()
        if n < len(evs):
            evs = evs[len(evs) - max(n, 0):]
        return self.to_dicts(evs)

    def summary(self) -> Dict[str, Any]:
        """Depth/drop accounting — the ``/vars`` block."""
        return {
            "events": len(self._events),
            "events_total": self._events.total,
            "events_dropped": self._events.dropped,
            "capacity": self._events.capacity,
            "last_seq": self._seq,
        }

    def clear(self) -> None:
        self._events.clear()
        self._seq = 0


# -- bundle mechanics --------------------------------------------------------


def _jsonl(rows) -> str:
    return "".join(json.dumps(r, sort_keys=True, default=str) + "\n"
                   for r in rows)


def write_bundle(path: str, files: Dict[str, Any]) -> str:
    """Atomically materialise a post-mortem bundle directory at
    ``path``: each ``files`` entry becomes one file (``.jsonl`` values
    are lists of dicts written one JSON object per line, everything
    else is JSON), written into a same-filesystem temp directory and
    ``os.replace``d into place (:func:`apex_tpu_torch._atomic.atomic_dir`),
    so a reader either sees the
    complete bundle or no bundle. Raises if
    ``path`` already exists (bundles are immutable evidence; the
    caller picks a fresh name)."""
    path = os.path.abspath(path)
    try:
        with _atomic.atomic_dir(path) as tmp:
            for name, content in files.items():
                with open(os.path.join(tmp, name), "w",
                          encoding="utf-8") as f:
                    if name.endswith(".jsonl"):
                        f.write(_jsonl(content))
                    else:
                        json.dump(content, f, indent=1, sort_keys=True,
                                  default=str)
                        f.write("\n")
    except FileExistsError:
        raise FileExistsError(f"bundle {path} already exists — bundles "
                              f"are immutable; pick a fresh name")
    return path


def read_bundle(path: str) -> Dict[str, Any]:
    """Load every file of a bundle directory back into memory:
    ``{filename: parsed}`` — ``.jsonl`` files as lists of dicts, JSON
    files as their value. Stdlib-only (the ``--report`` path)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no bundle directory at {path}")
    out: Dict[str, Any] = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        with open(full, "r", encoding="utf-8") as f:
            if name.endswith(".jsonl"):
                out[name] = [json.loads(line)
                             for line in f if line.strip()]
            else:
                out[name] = json.load(f)
    if "manifest.json" not in out:
        raise ValueError(
            f"{path} is not a post-mortem bundle (no manifest.json)")
    return out


def versions() -> Dict[str, Optional[str]]:
    """Toolchain provenance for the manifest — best-effort, never
    imports anything heavy that is not already loaded. The port names
    torch and the CUDA toolkit torch was built with where the JAX
    package names jax and jaxlib."""
    import platform
    import sys

    out: Dict[str, Optional[str]] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    for mod in ("apex_tpu_torch", "torch", "numpy"):
        m = sys.modules.get(mod)
        out[mod] = getattr(m, "__version__", None) if m else None
    torch = sys.modules.get("torch")
    version = getattr(torch, "version", None) if torch else None
    out["cuda"] = getattr(version, "cuda", None) if version else None
    return out
