"""Metrics registry — Counter / Gauge / Histogram with exposition.

The one sink the port reports through: training's
:class:`apex_tpu_torch.profiler.MetricsLogger` mirrors per-step scalars
into gauges, and the serving scheduler counts admissions / retirements /
tokens and observes TTFT + per-token latency into SLO-bucketed
histograms. Exposition is dual: ``to_prometheus_text()`` (text format
0.0.4, what ``telemetry/http.py`` serves at ``/metrics``, byte for byte
the JAX package's text for the same operations) and ``to_dict()`` (the
JSON snapshot ``/vars`` embeds).

Dependency-free by contract: stdlib only — no torch, no numpy, no jax
(a test imports the module with those blocked). Metric
mutation is a single ``+=`` / ``=`` under the GIL plus a lock only on
family/child creation and snapshot, so hot-path increments cost an
attribute access and an add.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Fixed SLO-oriented latency buckets (seconds). One shared ladder for
#: every latency histogram — cross-metric bucket alignment is what lets
#: an operator overlay TTFT and per-token latency on one axis. Spans
#: 0.1 ms (a warm chunked decode step per token) to 10 s (a cold
#: compile sneaking into the serve path — exactly the event the
#: recompile sentinel exists to catch).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary key (e.g. a MetricsLogger dict key like
    ``grad_norm/global``) into a legal metric name."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt(v: float) -> str:
    """Prometheus-text float formatting: integers bare, +Inf spelled."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    """One (labelset, value) sample of a family."""

    __slots__ = ("labels",)

    def __init__(self, labels: Tuple[Tuple[str, str], ...]):
        self.labels = labels


class CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        self.value += amount


class GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class HistogramChild(_Child):
    """Fixed-bucket histogram: per-bucket counts (non-cumulative in
    memory, cumulated at exposition), sum, and count. ``observe`` is one
    bisect over the bucket ladder."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, labels, buckets: Tuple[float, ...]):
        super().__init__(labels)
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


_CHILD_TYPES = {"counter": CounterChild, "gauge": GaugeChild,
                "histogram": HistogramChild}


class MetricFamily:
    """A named metric plus its labeled children. With no declared
    labels the family proxies the single default child, so
    ``registry.counter("x").inc()`` works without a ``labels()`` hop."""

    def __init__(self, name: str, help: str, type: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help
        self.type = type
        self.label_names = label_names
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        self._default: Optional[_Child] = None
        if not label_names:
            self._default = self._make(())

    def _make(self, values: Tuple[str, ...]) -> _Child:
        labels = tuple(zip(self.label_names, values))
        if self.type == "histogram":
            child = HistogramChild(labels, self.buckets)
        else:
            child = _CHILD_TYPES[self.type](labels)
        self._children[values] = child
        return child

    def labels(self, **kv: str) -> _Child:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(kv)}")
        values = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values) or self._make(values)
        return child

    # -- unlabeled-family proxies ------------------------------------------

    def _only(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                f"use .labels(...)")
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    @property
    def value(self) -> float:
        return self._only().value

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())


class Registry:
    """Create-or-get metric families and render snapshots."""

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, help: str, type: str,
                labels: Iterable[str] = (),
                buckets: Optional[Tuple[float, ...]] = None
                ) -> MetricFamily:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type or fam.label_names != label_names or (
                        type == "histogram" and buckets is not None
                        and fam.buckets != tuple(buckets)):
                    raise ValueError(
                        f"metric {name!r} re-registered as {type}"
                        f"{label_names} (existing: {fam.type}"
                        f"{fam.label_names})")
                return fam
            fam = MetricFamily(name, help, type, label_names,
                               tuple(buckets) if buckets else None)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> MetricFamily:
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be sorted non-empty: {buckets}")
        return self._family(name, help, "histogram", labels, tuple(buckets))

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    # -- exposition ---------------------------------------------------------

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for child in fam.children():
                base = _labelstr(child.labels)
                if fam.type == "histogram":
                    cum = child.cumulative()
                    edges = list(child.buckets) + [float("inf")]
                    for le, c in zip(edges, cum):
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_labelstr(child.labels + (('le', _fmt(le)),))}"
                            f" {c}")
                    lines.append(f"{fam.name}_sum{base} {repr(child.sum)}")
                    lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    lines.append(f"{fam.name}{base} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict[str, dict]:
        """JSON-ready snapshot: ``{name: {type, help, samples: [...]}}``."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            samples = []
            for child in fam.children():
                labels = dict(child.labels)
                if fam.type == "histogram":
                    samples.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": {
                            _fmt(le): c for le, c in zip(
                                list(child.buckets) + [float("inf")],
                                child.cumulative())},
                    })
                else:
                    samples.append({"labels": labels,
                                    "value": child.value})
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "samples": samples}
        return out


def _labelstr(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


def parse_prometheus_text(text: str) -> Dict[str, Dict[Tuple, float]]:
    """Minimal exposition-format parser — enough to round-trip
    :meth:`Registry.to_prometheus_text` in tests and quick operator
    scripts: ``{sample_name: {((label, value), ...): float}}``. Ignores
    comments; histogram series appear under their ``_bucket`` /
    ``_sum`` / ``_count`` sample names exactly as scraped."""
    out: Dict[str, Dict[Tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$", line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labelstr, value = m.groups()
        labels = []
        if labelstr:
            for part in re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]'
                                   r'|\\.)*)"', labelstr):
                k, v = part
                # decode escapes left-to-right in one scan — ordered
                # global replaces corrupt values like a literal
                # backslash followed by 'n'
                v = re.sub(r"\\(.)",
                           lambda m: {"n": "\n"}.get(m.group(1),
                                                     m.group(1)), v)
                labels.append((k, v))
        out.setdefault(name, {})[tuple(labels)] = float(value)
    return out
