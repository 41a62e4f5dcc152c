"""apex_tpu_torch.telemetry — serving observability of the port.

The port's copy of the JAX package's telemetry layer, one layer every
serving component reports through:

- :mod:`~apex_tpu_torch.telemetry.ring`      — the O(1) fixed-window
  ring buffer behind every bounded history,
- :mod:`~apex_tpu_torch.telemetry.registry`  — Counter / Gauge /
  Histogram with labels and fixed SLO buckets; Prometheus text and JSON
  snapshots (``Scheduler(registry=...)``,
  ``profiler.MetricsLogger(registry=...)``),
- :mod:`~apex_tpu_torch.telemetry.spans`     — per-request span
  timelines (queued → prefill → first_token → decode chunks → retired)
  and host sections, exported as Chrome-trace JSON,
- :mod:`~apex_tpu_torch.telemetry.http`      — ``/metrics``
  (Prometheus), ``/healthz``, ``/vars``, ``/debug/events``,
  ``/debug/bundle`` from a stdlib daemon-thread server,
- :mod:`~apex_tpu_torch.telemetry.flightrec` — the flight recorder
  (bounded structured event log of every load-bearing host decision)
  and the atomic post-mortem bundle writer,
- :mod:`~apex_tpu_torch.telemetry.replay`    — ``python -m
  apex_tpu_torch.telemetry.replay <bundle>``: deterministic replay of a
  bundle's streams on the port's engine, and the stdlib-only
  ``--report`` timeline,
- :mod:`~apex_tpu_torch.telemetry.slo`       — mergeable fixed-gamma
  quantile sketches (streaming p50/p95/p99 for TTFT, inter-token gap,
  queue wait, e2e), declared objectives with error budgets, and
  deterministic multi-window burn-rate alerting.

The JAX package's ``recompile`` sentinel has no counterpart: eager
PyTorch keeps no trace cache whose growth could be counted.

Standard library only, by contract (a test imports every module here
with torch, numpy and jax blocked); ``replay.replay_bundle`` imports
torch lazily, on the replay path only. Submodules load lazily
(PEP 562), so ``from apex_tpu_torch.telemetry.ring import Ring`` costs
exactly one module.
"""

from __future__ import annotations

__all__ = [
    "ring", "registry", "spans", "http", "flightrec", "replay", "slo",
    "Ring", "Registry", "DEFAULT_BUCKETS", "parse_prometheus_text",
    "SpanRecorder", "MetricsServer", "start_metrics_server",
    "FlightRecorder", "EVENT_FIELDS",
    "QuantileSketch", "SLOConfig", "SLOObjective", "SLOMonitor",
    "parse_objective",
]

_LAZY = {
    "ring": "apex_tpu_torch.telemetry.ring",
    "registry": "apex_tpu_torch.telemetry.registry",
    "spans": "apex_tpu_torch.telemetry.spans",
    "http": "apex_tpu_torch.telemetry.http",
    "flightrec": "apex_tpu_torch.telemetry.flightrec",
    "replay": "apex_tpu_torch.telemetry.replay",
    "slo": "apex_tpu_torch.telemetry.slo",
    "QuantileSketch": "apex_tpu_torch.telemetry.slo",
    "SLOConfig": "apex_tpu_torch.telemetry.slo",
    "SLOObjective": "apex_tpu_torch.telemetry.slo",
    "SLOMonitor": "apex_tpu_torch.telemetry.slo",
    "parse_objective": "apex_tpu_torch.telemetry.slo",
    "FlightRecorder": "apex_tpu_torch.telemetry.flightrec",
    "EVENT_FIELDS": "apex_tpu_torch.telemetry.flightrec",
    "Ring": "apex_tpu_torch.telemetry.ring",
    "Registry": "apex_tpu_torch.telemetry.registry",
    "DEFAULT_BUCKETS": "apex_tpu_torch.telemetry.registry",
    "parse_prometheus_text": "apex_tpu_torch.telemetry.registry",
    "SpanRecorder": "apex_tpu_torch.telemetry.spans",
    "MetricsServer": "apex_tpu_torch.telemetry.http",
    "start_metrics_server": "apex_tpu_torch.telemetry.http",
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(target)
    value = mod if target.endswith("." + name) else getattr(mod, name)
    globals()[name] = value
    return value
