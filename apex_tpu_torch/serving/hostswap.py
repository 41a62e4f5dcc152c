"""Host-RAM page tier under the device pool — swap policy.

The port's own copy of ``apex_tpu/serving/hostswap.py`` (standard library
only; the port imports nothing of the JAX package). The paged KV cache
(:mod:`.pages`) hard-caps conversations at the device page pool: an idle
conversation squats on its private pages until it finishes. This module
owns the host side of oversubscription: an LRU over PARKED
conversations whose pages were gathered out of the device pool
(``gpt.cache_gather_pages``, one ``index_select`` over all of a slot's
private pages) into host buffers, so a paused stream costs host RAM
while active streams keep every device page. Resume scatters the
payload back (``gpt.cache_insert_pages``) or, when the scheduler prices
replay cheaper, recomputes from the grow-only emitted-prefix snapshot
and the payload is simply dropped.

Three host-only pieces live here:

- :func:`swap_rungs` / :func:`plan_rungs` — the JAX engine's static
  swap-batch geometry (power-of-two rungs, ``5 -> 4 + 1``), which it
  needs because every compiled gather/scatter variant has a static page
  count. The port runs eagerly and moves a slot's pages in one gather
  and one scatter, so its engine does not split a swap; the two
  functions stay as the reference's public surface.
- :class:`LRUIndex` — a bare recency-ordered set. The page tier uses
  it for park-order eviction; the engine reuses the SAME mechanism for
  LoRA adapter residency (cold adapter rows spill to host, the static
  device pool stops capping ``register_adapter``).
- :class:`HostPageTier` — the parked-entry store: opaque payloads
  keyed by request id with page/byte accounting and optional capacity
  eviction. Payloads are whatever the engine gathered (storage-form
  page blocks + the slot's state row); the tier never inspects them.

Everything here is O(1)/O(k) host bookkeeping; the device round trip is
the engine's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Tuple


def swap_rungs(max_pages: int) -> Tuple[int, ...]:
    """The compiled swap-batch sizes for a pool whose slots hold at
    most ``max_pages`` private pages: every power of two up to
    ``max_pages`` — enough that :func:`plan_rungs` can decompose any
    count ``1 .. max_pages`` exactly (binary representation), so no
    padding pages ever travel."""
    if max_pages < 1:
        raise ValueError(f"max_pages {max_pages} must be >= 1")
    rungs: List[int] = []
    r = 1
    while r <= max_pages:
        rungs.append(r)
        r *= 2
    return tuple(rungs)


def plan_rungs(n: int) -> List[int]:
    """Split a swap of ``n`` pages into compiled-rung calls, largest
    first: ``5 -> [4, 1]``. Exact (sum equals ``n``), deterministic,
    and every element is in ``swap_rungs(m)`` for any ``m >= n``."""
    if n < 0:
        raise ValueError(f"cannot swap {n} pages")
    out: List[int] = []
    bit = 1 << max(n.bit_length() - 1, 0)
    while bit:
        if n & bit:
            out.append(bit)
        bit >>= 1
    return out


class LRUIndex:
    """A recency-ordered set of keys — the one LRU mechanism shared by
    the page tier (park-order eviction) and the engine's adapter
    paging (cold-row spill). ``touch`` inserts-or-refreshes at the
    most-recent end; ``pop_coldest`` evicts from the least-recent end,
    skipping pinned keys."""

    __slots__ = ("_order",)

    def __init__(self) -> None:
        self._order: "OrderedDict[Any, None]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, key: Any) -> bool:
        return key in self._order

    def __iter__(self) -> Iterator[Any]:
        """Coldest (least recently touched) first."""
        return iter(self._order)

    def touch(self, key: Any) -> None:
        self._order[key] = None
        self._order.move_to_end(key)

    def discard(self, key: Any) -> None:
        self._order.pop(key, None)

    def pop_coldest(self, pinned=()) -> Optional[Any]:
        """Remove and return the least-recently-touched key not in
        ``pinned``; ``None`` when every key is pinned (caller decides
        whether that is a hard error — it is for adapter paging when
        every resident row is bound to a live slot)."""
        for key in self._order:
            if key not in pinned:
                del self._order[key]
                return key
        return None


class ParkedEntry:
    """One parked conversation's host-side payload: whatever the
    engine gathered (storage-form page block(s) plus the slot's state
    row), with the page/byte accounting the gauges read."""

    __slots__ = ("payload", "n_pages", "nbytes")

    def __init__(self, payload: Any, n_pages: int, nbytes: int):
        self.payload = payload
        self.n_pages = n_pages
        self.nbytes = nbytes


class HostPageTier:
    """LRU store of parked conversations. ``capacity_pages`` bounds
    the host-RAM footprint in PAGES (0 = unbounded): parking past the
    bound evicts the coldest entries — eviction only drops the swap
    payload, never the conversation, because the scheduler always
    keeps the grow-only emitted-prefix snapshot and falls back to
    recompute-resume when ``take`` misses."""

    __slots__ = ("capacity_pages", "_entries", "_lru", "pages",
                 "bytes", "parks_total", "takes_total", "drops_total")

    def __init__(self, capacity_pages: int = 0):
        if capacity_pages < 0:
            raise ValueError(
                f"capacity_pages {capacity_pages} must be >= 0")
        self.capacity_pages = capacity_pages
        self._entries: Dict[Any, ParkedEntry] = {}
        self._lru = LRUIndex()
        self.pages = 0
        self.bytes = 0
        self.parks_total = 0
        self.takes_total = 0
        self.drops_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Any) -> bool:
        return key in self._entries

    def park(self, key: Any, payload: Any, n_pages: int,
             nbytes: int) -> List[Tuple[Any, ParkedEntry]]:
        """Store ``payload`` under ``key`` at the most-recent end and
        return the ``(key, entry)`` pairs evicted to stay under
        ``capacity_pages`` (possibly including the new entry itself
        when it alone exceeds the bound — the caller downgrades those
        to recompute-resume). Re-parking an existing key is a bug
        (the conversation would have to be resumed first)."""
        if key in self._entries:
            raise ValueError(f"{key!r} is already parked")
        self._entries[key] = ParkedEntry(payload, n_pages, nbytes)
        self._lru.touch(key)
        self.pages += n_pages
        self.bytes += nbytes
        self.parks_total += 1
        evicted: List[Tuple[Any, ParkedEntry]] = []
        while self.capacity_pages and self.pages > self.capacity_pages:
            cold = self._lru.pop_coldest()
            if cold is None:  # pragma: no cover - entries imply keys
                break
            ent = self._entries.pop(cold)
            self.pages -= ent.n_pages
            self.bytes -= ent.nbytes
            self.drops_total += 1
            evicted.append((cold, ent))
        return evicted

    def take(self, key: Any) -> Optional[ParkedEntry]:
        """Remove and return ``key``'s entry, or ``None`` when it was
        capacity-evicted (or never swap-parked) — the recompute
        fallback signal."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return None
        self._lru.discard(key)
        self.pages -= ent.n_pages
        self.bytes -= ent.nbytes
        self.takes_total += 1
        return ent

    def touch(self, key: Any) -> None:
        """Refresh ``key``'s recency (a parked conversation the router
        expects to resume soon)."""
        if key in self._entries:
            self._lru.touch(key)

    def stats(self) -> Dict[str, float]:
        return {
            "parked_entries": float(len(self._entries)),
            "pages": float(self.pages),
            "bytes": float(self.bytes),
            "capacity_pages": float(self.capacity_pages),
            "parks_total": float(self.parks_total),
            "takes_total": float(self.takes_total),
            "drops_total": float(self.drops_total),
        }
