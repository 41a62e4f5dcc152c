"""Refcounted page allocator for the paged KV cache — host policy.

The port's own copy of ``apex_tpu/serving/pages.py`` (the port imports
nothing of the JAX package). The paged cache layout (``gpt.decode_step(...,
table=...)``) stores a GLOBAL pool of fixed-size pages ``[num_pages,
heads, P, head_dim]`` plus one block-table row ``[max_pages] int32`` per
slot mapping the slot's logical horizon chunks onto physical pages. This
module owns the host side of that indirection: which pages are free,
which are pinned by how many holders (copy-on-write prefix sharing
refcounts), and when an admission must be refused for lack of pages (the
scheduler's backpressure signal).

Layout contract:

- page ``SINK`` (0) is the shared garbage page: never allocated, the
  redirect target of every released slot's table row. Done-but-live
  decode lanes keep writing their frozen column each step
  (``gpt.decode_steps`` freezes ``pos``, not the write), so a released
  slot's row must keep pointing at writable memory — the sink absorbs
  those writes, and nothing ever reads it through an unmasked column.
- allocatable pages are ``1 .. num_pages - 1``; ``capacity`` is their
  count.
- a page with ``refcount > 1`` is SHARED (a prefix pinned by its
  registration plus every slot mapping it). Shared pages are read-only
  by construction: every write a slot issues lands at logical columns
  past the prefix, in private pages.

Everything here is host arithmetic; the allocator never touches the
device, and tables travel to the device as data.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: the reserved garbage/sink page index — never allocated, always the
#: redirect target of freed table rows (see module docstring)
SINK = 0


class PagesExhausted(RuntimeError):
    """Allocation refused: fewer free pages than requested. Carries
    the shortfall so the scheduler's backpressure path can report how
    far over capacity the admission was (and an ingress layer can turn
    it into a 429 with a meaningful hint)."""

    def __init__(self, requested: int, free: int):
        super().__init__(
            f"page pool exhausted: requested {requested} pages, "
            f"{free} free")
        self.requested = requested
        self.free = free


class PageAllocator:
    """Free-list + refcount accounting over ``num_pages`` pages of
    ``page_size`` tokens each (page 0 reserved as the sink).

    >>> alloc = PageAllocator(num_pages=9, page_size=8)
    >>> pages = alloc.alloc(3)          # 3 private pages, refcount 1
    >>> alloc.share(pages[:1])          # pin page (a prefix mapping)
    >>> alloc.free(pages)               # refcounts drop; page 0 of the
    ...                                 # three stays alive (still shared)

    ``used_tokens`` tracks the live-token occupancy the fragmentation
    gauge is computed from: internal fragmentation is the gap between
    the tokens a slot's pages COULD hold and the tokens they DO hold —
    ``1 - used_tokens / (pages_in_use * page_size)``.
    """

    __slots__ = ("num_pages", "page_size", "_free", "_ref",
                 "used_tokens", "allocs_total", "frees_total",
                 "shares_total", "host_pages", "host_bytes",
                 "swap_outs_total", "swap_ins_total")

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages {num_pages} must be >= 2 (page 0 is the "
                f"reserved sink)")
        if page_size < 1:
            raise ValueError(f"page_size {page_size} must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list, ascending pop order for determinism (tests
        # and fault replay see the same page ids for the same sequence
        # of alloc/free calls)
        self._free: List[int] = list(range(num_pages - 1, SINK, -1))
        self._ref = [0] * num_pages
        #: live tokens currently mapped onto allocated pages (the
        #: occupancy numerator; the engine adds/removes per admission/
        #: release)
        self.used_tokens = 0
        self.allocs_total = 0
        self.frees_total = 0
        self.shares_total = 0
        #: host-tier occupancy (the swap tier under this pool): pages
        #: currently parked in host RAM and their byte footprint, plus
        #: cumulative swap traffic, so ``stats()`` is the one snapshot.
        #: Survives ``reset()``: a rebuild wipes the DEVICE pool, but
        #: parked host payloads stay valid (they were copied out).
        self.host_pages = 0
        self.host_bytes = 0
        self.swap_outs_total = 0
        self.swap_ins_total = 0

    # -- core ----------------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (``num_pages - 1`` — the sink is not)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages pinned by more than one holder (CoW prefix pages with
        at least one live mapping beyond the registration pin)."""
        return sum(1 for r in self._ref if r > 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` pages (refcount 1 each); raises
        :class:`PagesExhausted` without side effects when fewer are
        free — the all-or-nothing contract admission needs."""
        if n > len(self._free):
            raise PagesExhausted(n, len(self._free))
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        self.allocs_total += n
        return out

    def share(self, pages: Sequence[int]) -> None:
        """Pin already-allocated pages one more time (a slot mapping a
        registered prefix's pages, or a second registration pin)."""
        for p in pages:
            if p == SINK or self._ref[p] < 1:
                raise ValueError(
                    f"share of page {p} which is not allocated")
            self._ref[p] += 1
        self.shares_total += len(pages)

    def free(self, pages: Sequence[int]) -> int:
        """Drop one pin from each page; pages reaching refcount 0
        return to the free list. Returns how many were actually
        released. ``SINK`` entries are ignored (a table row's redirect
        padding)."""
        released = 0
        for p in pages:
            if p == SINK:
                continue
            if self._ref[p] < 1:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                released += 1
        self.frees_total += released
        return released

    def reset(self) -> None:
        """Every page free (a fault rebuild — the scheduler replays
        interrupted requests, which re-allocate deterministically)."""
        self._free = list(range(self.num_pages - 1, SINK, -1))
        self._ref = [0] * self.num_pages
        self.used_tokens = 0

    # -- host tier -----------------------------------------------------------

    def note_swap_out(self, n_pages: int, nbytes: int) -> None:
        """Record ``n_pages`` leaving the device pool for host RAM
        (``nbytes`` of storage-form payload). Pure accounting — the
        actual gather/free is the engine's."""
        self.host_pages += n_pages
        self.host_bytes += nbytes
        self.swap_outs_total += n_pages

    def note_swap_in(self, n_pages: int, nbytes: int) -> None:
        """Record ``n_pages`` returning from host RAM to the device
        pool (or being dropped after a recompute-resume — either way
        the host tier no longer holds them)."""
        self.host_pages -= n_pages
        self.host_bytes -= nbytes
        self.swap_ins_total += n_pages

    def note_swap_drop(self, n_pages: int, nbytes: int) -> None:
        """Record a parked payload discarded without a device scatter
        (capacity eviction or a recompute-resume) — it leaves the host
        tier but is not a swap-in."""
        self.host_pages -= n_pages
        self.host_bytes -= nbytes

    # -- observability -------------------------------------------------------

    def fragmentation(self) -> float:
        """Internal fragmentation of the pages in use: ``1 -
        used_tokens / (pages_in_use * page_size)`` — 0.0 when every
        allocated page is full (or none is allocated). The contiguous
        layout's analogue of this number is what the paged cache
        exists to crush: there, every slot strands ``S - len`` tokens."""
        cap = self.pages_in_use * self.page_size
        if cap <= 0:
            return 0.0
        return max(0.0, 1.0 - self.used_tokens / cap)

    def stats(self) -> Dict[str, float]:
        """The page-occupancy snapshot the scheduler gauges/flight-
        records: pool geometry, live usage, sharing, fragmentation."""
        return {
            "pages_total": float(self.capacity),
            "pages_free": float(self.free_pages),
            "pages_in_use": float(self.pages_in_use),
            "pages_shared": float(self.shared_pages),
            "used_tokens": float(self.used_tokens),
            "fragmentation": self.fragmentation(),
            "allocs_total": float(self.allocs_total),
            "frees_total": float(self.frees_total),
            "shares_total": float(self.shares_total),
            "pages_swapped": float(self.host_pages),
            "swap_bytes": float(self.host_bytes),
            "swap_outs_total": float(self.swap_outs_total),
            "swap_ins_total": float(self.swap_ins_total),
        }
