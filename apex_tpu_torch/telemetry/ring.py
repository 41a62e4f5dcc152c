"""Fixed-capacity O(1)-append ring buffer — the one windowing helper.

A bounded window kept with ``list.pop(0)`` costs O(window) per append
once it fills, which on a per-token hot path is the difference between
"free" and "visible in the profile". :class:`apex_tpu_torch.profiler.
LatencyStats`, :class:`~apex_tpu_torch.profiler.MetricsLogger`, the span
recorder and the flight recorder share this one. Generic over item
type: floats for latency windows, dicts for metric history, tuples for
span events.
"""

from __future__ import annotations

from typing import Any, List


class Ring:
    """Keep the most recent ``capacity`` items with O(1) ``append``.

    ``total`` is the lifetime append count (so callers can report how
    many items were dropped); ``values()`` returns the retained window
    oldest-first.
    """

    __slots__ = ("_buf", "_cap", "_cursor", "_total")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf: List[Any] = []
        self._cap = capacity
        self._cursor = 0
        self._total = 0

    def append(self, item: Any) -> None:
        if len(self._buf) < self._cap:
            self._buf.append(item)
        else:
            self._buf[self._cursor] = item
        self._cursor = (self._cursor + 1) % self._cap
        self._total += 1

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total(self) -> int:
        """Lifetime append count (>= ``len(self)``)."""
        return self._total

    @property
    def dropped(self) -> int:
        return self._total - len(self._buf)

    def values(self) -> List[Any]:
        """The retained window, oldest first."""
        if len(self._buf) < self._cap:
            return list(self._buf)
        c = self._cursor
        return self._buf[c:] + self._buf[:c]

    def array(self):
        """The window as a float64 numpy array (for summary statistics —
        order-insensitive, so no rotation is needed)."""
        import numpy as np

        return np.asarray(self._buf, np.float64)

    def clear(self) -> None:
        self._buf.clear()
        self._cursor = 0
        self._total = 0
