"""Multi-tenant serving policy: weighted-fair queueing and rate limits.

The port's own copy of ``apex_tpu/serving/tenancy.py`` (standard library
only; the port imports nothing of the JAX package). Many tenants share
one engine, fairly under contention:

- :class:`TenancyConfig` — per-tenant weights, token-budget rate limits
  and the priority-aging slope.
- :class:`TenantBook` — the scheduler's per-tenant bookkeeping:

  * **Weighted-fair queueing with deficit counters.** Each tenant
    carries a normalised-service counter (served tokens over its
    weight; the LOWEST counter is the tenant most behind its share).
    Admission picks the backlogged tenant with the smallest counter, so
    under contention the served-token shares converge to the weight
    ratio — charged on tokens actually streamed, so long and short
    streams settle to the same shares.
  * **Priority aging.** The selection key subtracts ``aging_per_s x
    head-of-line wait``: a starved tenant gains priority linearly with
    its queue time and is served eventually, whatever its weight.
  * **Token-budget rate limits.** Per-tenant token buckets (capacity
    ``rate x burst_s``, refilled continuously) charged the request's
    ``max_tokens`` at submit; an empty bucket rejects with
    :class:`TenantThrottled` carrying ``retry_after_s``, the time the
    bucket needs to refill the charge — the HTTP front end's 429 and
    ``Retry-After``.
  * **Accounting.** Per-tenant submitted / admitted / shed / throttled
    / token counts (``summary()``).

The book is queue-agnostic: the scheduler keeps its one arrival-order
deque and only the pop order consults :meth:`TenantBook.pick`, so a
single-tenant workload pops strict FIFO, as before tenancy.
:meth:`TenantBook.pick_victim` is the host-swap tier's preemption hook,
which has no caller in the port until that tier is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional


class TenantThrottled(RuntimeError):
    """Per-tenant rate-limit rejection at submit. Deliberately NOT a
    :class:`~apex_tpu_torch.serving.scheduler.QueueFull`: queue pressure is
    replica-local (a fleet router may retry elsewhere), a tenant's
    token budget is not — the rejection must propagate to the client
    as a 429 + ``Retry-After`` without another replica being tried.
    ``retry_after_s`` is when the tenant's bucket will have refilled
    this request's charge."""

    def __init__(self, message: str, *, tenant: str,
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


#: the tenant every request without an identity belongs to — one
#: spelling shared by Request, the scheduler, and the API layer
DEFAULT_TENANT = "default"

#: the shared identity unseen tenants fold into once the book is
#: tracking ``TenancyConfig.max_tenants`` distinct ids — caps host
#: state against unauthenticated per-request-unique tenant strings
OVERFLOW_TENANT = "overflow"


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """Per-tenant serving policy (static, host-only).

    ``weights`` maps tenant id → fair-share weight (unlisted tenants
    get ``default_weight``); under contention served-token shares
    converge to the weight ratio. ``rates`` maps tenant id → sustained
    token budget (generated tokens per second; unlisted tenants get
    ``default_rate``, ``None`` = unlimited); a submit whose
    ``max_tokens`` charge exceeds the tenant's bucket raises
    :class:`TenantThrottled`. ``burst_s`` sizes the bucket
    (``rate × burst_s``, floored at one worst-case request so a legal
    request can always eventually pass). ``aging_per_s`` is the
    priority-aging slope: normalized-service units of credit per
    second a tenant's head request waits — 0 disables aging (pure
    WFQ; a zero-weight-ish tenant could then starve)."""

    weights: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    default_weight: float = 1.0
    rates: Mapping[str, Optional[float]] = dataclasses.field(
        default_factory=dict)
    default_rate: Optional[float] = None
    burst_s: float = 2.0
    aging_per_s: float = 1.0

    #: distinct tenant identities the book tracks before folding new
    #: ones into the shared overflow tenant — tenant ids arrive from
    #: UNAUTHENTICATED request fields (the X-Tenant-Id header, the
    #: OpenAI ``user`` string), and unbounded ids would grow
    #: per-tenant state and labeled metric children without limit in
    #: a long-running server. Configured tenants (weights/rates keys)
    #: always get their own identity.
    max_tenants: int = 4096

    def __post_init__(self):
        if self.max_tenants < 1:
            raise ValueError(
                f"max_tenants {self.max_tenants} must be >= 1")
        for t, w in dict(self.weights).items():
            if not w > 0.0:
                raise ValueError(
                    f"tenant {t!r} weight {w} must be > 0 (a zero "
                    f"weight is an infinite deficit — use a rate "
                    f"limit to cap a tenant instead)")
        if not self.default_weight > 0.0:
            raise ValueError(
                f"default_weight {self.default_weight} must be > 0")
        for t, r in dict(self.rates).items():
            if r is not None and not r > 0.0:
                raise ValueError(
                    f"tenant {t!r} rate {r} must be > 0 or None "
                    f"(unlimited)")
        if self.default_rate is not None and not self.default_rate > 0.0:
            raise ValueError(
                f"default_rate {self.default_rate} must be > 0 or None")
        if self.burst_s <= 0.0:
            raise ValueError(f"burst_s {self.burst_s} must be > 0")
        if self.aging_per_s < 0.0:
            raise ValueError(
                f"aging_per_s {self.aging_per_s} must be >= 0")


class _TenantStats:
    __slots__ = ("submitted", "admitted", "shed", "throttled", "tokens")

    def __init__(self):
        self.submitted = 0
        self.admitted = 0
        self.shed = 0
        self.throttled = 0
        self.tokens = 0


class TenantBook:
    """Per-tenant WFQ state + rate buckets + accounting (see module
    docstring). Host-only and deterministic in (clock, call sequence),
    so fault replay and the post-mortem bundle see the same decisions
    a live run made."""

    def __init__(self, cfg: Optional[TenancyConfig], clock):
        self.cfg = cfg or TenancyConfig()
        self.clock = clock
        #: normalized-service deficit counters: served tokens / weight
        #: per tenant — the WFQ selection key (lowest = most behind)
        self._service: Dict[str, float] = {}
        #: rate buckets: tenant -> [level_tokens, last_refill_ts]
        self._bucket: Dict[str, list] = {}
        self._stats: Dict[str, _TenantStats] = {}

    # -- config lookups ------------------------------------------------------

    def admit_tenant(self, tenant: str) -> str:
        """Resolve a request's tenant identity to the one the book
        tracks: known ids and configured ids (weights/rates keys) keep
        their identity; a NEW id past ``max_tenants`` distinct tracked
        tenants folds into :data:`OVERFLOW_TENANT` — per-tenant state
        and labeled metrics stay bounded whatever strings an
        unauthenticated client invents. The scheduler rewrites
        ``Request.tenant`` with the result so accounting, WFQ, and
        rate buckets all see one consistent identity."""
        if tenant in self._stats or tenant in self.cfg.weights \
                or tenant in self.cfg.rates:
            return tenant
        if len(self._stats) >= self.cfg.max_tenants:
            return OVERFLOW_TENANT
        return tenant

    def weight(self, tenant: str) -> float:
        return float(self.cfg.weights.get(tenant,
                                          self.cfg.default_weight))

    def rate(self, tenant: str) -> Optional[float]:
        r = self.cfg.rates.get(tenant, self.cfg.default_rate)
        return None if r is None else float(r)

    def stats(self, tenant: str) -> _TenantStats:
        st = self._stats.get(tenant)
        if st is None:
            st = self._stats[tenant] = _TenantStats()
        return st

    @property
    def tenants_seen(self):
        return sorted(self._stats)

    # -- weighted-fair queueing ----------------------------------------------

    def note_backlogged(self, tenant: str) -> None:
        """First sight of a tenant in the backlog: start its deficit
        counter at the MINIMUM of the live counters (the virtual-clock
        clamp) — a newcomer competes from "now", it does not get
        credit for every token served before it existed."""
        if tenant not in self._service:
            floor = min(self._service.values(), default=0.0)
            self._service[tenant] = floor

    def rejoin(self, tenant: str, floor: float) -> None:
        """A tenant RE-ENTERING the backlog after going idle clamps up
        to ``floor`` (the minimum counter among currently-backlogged
        tenants — the scheduler computes it, since only it knows who
        is backlogged): idle time is not banked service credit, so a
        returning tenant competes from "now" instead of monopolizing
        the engine until its stale counter catches up on everything
        served while it was away."""
        self._service[tenant] = max(self._service.get(tenant, floor),
                                    floor)

    def on_tokens(self, tenant: str, n: int) -> None:
        """Charge ``n`` served tokens to ``tenant``'s deficit counter
        (normalized by weight) — called per emitted token batch, so
        fairness settles on ACTUAL service, not on admission-time
        estimates."""
        if n <= 0:
            return
        self.note_backlogged(tenant)
        self._service[tenant] = (self._service.get(tenant, 0.0)
                                 + n / self.weight(tenant))
        self.stats(tenant).tokens += n

    def pick(self, head_wait: Mapping[str, float]) -> str:
        """The WFQ decision: among backlogged tenants (``head_wait``
        maps tenant → seconds its head-of-line request has queued),
        pick the one most behind its fair share — smallest
        ``deficit - aging_per_s × wait``. Aging makes the key strictly
        decrease with queue time, so every tenant is eventually
        chosen: no starvation. Deterministic tie-break on (wait desc,
        name) so replays reproduce the order."""
        if not head_wait:
            raise ValueError("pick() needs at least one tenant")
        aging = self.cfg.aging_per_s
        for t in head_wait:
            self.note_backlogged(t)
        return min(
            head_wait,
            key=lambda t: (self._service[t] - aging * head_wait[t],
                           -head_wait[t], t))

    def service_of(self, tenant: str) -> float:
        return self._service.get(tenant, 0.0)

    def pick_victim(self, service: Mapping[str, float]) -> str:
        """:meth:`pick` mirrored for preemption: among tenants holding
        active slots (``service`` maps tenant → its deficit counter,
        snapshotted by the caller), evict from the one furthest AHEAD
        of its fair share — the largest counter. Deterministic
        tie-break on name, so the same candidates always give the same
        victim."""
        if not service:
            raise ValueError("pick_victim() needs at least one tenant")
        return max(sorted(service), key=lambda t: service[t])

    # -- token-budget rate limits --------------------------------------------

    def _refill(self, tenant: str, rate: float, now: float) -> list:
        cap = rate * self.cfg.burst_s
        b = self._bucket.get(tenant)
        if b is None:
            b = self._bucket[tenant] = [cap, now]
        level, last = b
        b[0] = min(cap, level + rate * max(now - last, 0.0))
        b[1] = now
        return b

    def throttle(self, tenant: str, max_tokens: int,
                 now: Optional[float] = None) -> Optional[float]:
        """Charge ``max_tokens`` to ``tenant``'s bucket. Returns None
        when the charge fits (bucket debited); else the seconds until
        it would (the 429's ``Retry-After``), leaving the bucket
        untouched. The effective charge is clamped to the bucket
        capacity so a single over-burst request is gated, not
        permanently unservable."""
        rate = self.rate(tenant)
        if rate is None:
            return None
        now = self.clock() if now is None else now
        b = self._refill(tenant, rate, now)
        need = min(float(max_tokens), rate * self.cfg.burst_s)
        if b[0] >= need:
            b[0] -= need
            return None
        return (need - b[0]) / rate

    def bucket_level(self, tenant: str) -> Optional[float]:
        """Current bucket level (refreshed; None = unlimited)."""
        rate = self.rate(tenant)
        if rate is None:
            return None
        return self._refill(tenant, rate, self.clock())[0]

    # -- reporting -----------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting snapshot: submitted/admitted/shed/
        throttled/tokens plus the live deficit counter and weight."""
        out: Dict[str, Dict[str, float]] = {}
        for t in sorted(self._stats):
            st = self._stats[t]
            out[t] = {
                "weight": self.weight(t),
                "submitted": float(st.submitted),
                "admitted": float(st.admitted),
                "shed": float(st.shed),
                "throttled": float(st.throttled),
                "tokens": float(st.tokens),
                "deficit": self.service_of(t),
            }
        return out
