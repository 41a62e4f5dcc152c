"""Host-side metrics of the port: the serving latency accumulator and the
structured per-step metrics logger.

- :class:`LatencyStats` — streaming latency accumulator with percentile
  summaries (the scheduler's TTFT and per-token latency),
- :class:`MetricsLogger` — structured per-step metrics: an in-memory
  ring, an optional JSONL file, and an optional shared
  :class:`~apex_tpu_torch.telemetry.registry.Registry` whose gauges
  mirror every logged scalar (``Scheduler(metrics=...)`` logs one record
  a tick and one a completion).

The JAX package's module of the same name also holds its trace capture,
named ranges, step timer and op profile; their port is a later slice.
This module imports numpy and, for tensor values only, reads them with
``float()``; it never imports torch itself.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from apex_tpu_torch.telemetry.ring import Ring


class MetricsLogger:
    """Structured per-step metrics: ring buffer + optional JSONL sink +
    optional shared :class:`~apex_tpu_torch.telemetry.registry.Registry`
    (every logged scalar also sets a gauge, so training and serving
    expose through one ``/metrics``).

    Usable as a context manager (``with MetricsLogger(...) as log:``) —
    ``close()`` runs on exit. A JSONL line is the JAX package's for the
    same record.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 history: int = 1000, registry=None,
                 registry_prefix: str = ""):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._hist = Ring(history)
        self._registry = registry
        self._reg_prefix = registry_prefix
        self._gauges: Dict[str, Any] = {}

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        """Record one step's scalars (a 0-d tensor or array is read with
        ``float``, which waits for its value)."""
        flat = {k: float(v) for k, v in metrics.items()}
        flat["step"] = step
        self._hist.append(flat)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(flat) + "\n")
            self._jsonl.flush()
        if self._registry is not None:
            for k, v in flat.items():
                gauge = self._gauges.get(k)
                if gauge is None:
                    from apex_tpu_torch.telemetry.registry import \
                        sanitize_metric_name

                    gauge = self._gauges[k] = self._registry.gauge(
                        sanitize_metric_name(self._reg_prefix + k),
                        "MetricsLogger scalar")
                gauge.set(v)

    @property
    def history(self) -> List[Dict[str, float]]:
        return self._hist.values()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


class LatencyStats:
    """Streaming latency accumulator: keeps the most recent ``capacity``
    samples (seconds) in a ring and summarises to mean + percentiles in
    milliseconds — the serving scheduler's TTFT and per-token-latency
    sink."""

    def __init__(self, capacity: int = 8192):
        self._ring = Ring(capacity)

    def add(self, seconds: float) -> None:
        self._ring.append(seconds)

    @property
    def total(self) -> int:
        """Lifetime sample count."""
        return self._ring.total

    def summary(self) -> Dict[str, float]:
        """``{count, mean_ms, p50_ms, p90_ms, p99_ms, max_ms}`` over the
        retained window (empty dict before the first sample)."""
        if not self._ring.total:
            return {}
        v = self._ring.array() * 1e3
        return {
            "count": float(self._ring.total),
            "mean_ms": float(v.mean()),
            "p50_ms": float(np.percentile(v, 50)),
            "p90_ms": float(np.percentile(v, 90)),
            "p99_ms": float(np.percentile(v, 99)),
            "max_ms": float(v.max()),
        }
