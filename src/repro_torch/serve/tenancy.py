"""Tenant QoS runtime: token buckets, weighted-fair scheduling, quotas.

The paper's "isolate first, then share" applied to *users* instead of
cells: every tenant named by a tenant spec (``name``, ``weight``,
``rate``, ``burst``, ``page_quota``, ``share_public``, ``slo``) gets
bulkheaded resources by default —

* a **token bucket** (``rate``/``burst``) bounds how much work the
  tenant may inject per unit time, so a burst is absorbed by the
  tenant's own bucket instead of the shared queue;
* a **deficit-round-robin** scheduler shares decode slots / prefill
  batches by ``weight``, so a backlogged tenant can never take more than
  its weighted share while another tenant waits (bounded by one quantum
  — see :class:`TenantScheduler`);
* a **page-quota pocket** inside :class:`~repro_torch.serve.kvpool.KVPool`
  partitions the physical KV arena (computed here by
  :meth:`TenantRegistry.page_quotas`); a tenant can exhaust its pocket
  but never the pool.

The only cross-tenant sharing surface is the pool's **public prefix
namespace** (``PUBLIC``) — read-only mappings granted through the spec
(``share_public``), the analogue of the paper's supervisor-mediated
inter-subOS memory grant.  Everything else is private by construction.

Requests from tenants no spec names fall into the ``COMMONS`` pocket
(the unreserved remainder of the pool) with weight 1 and no bucket — the
safe default that keeps a single-tenant deployment byte-identical to the
pre-tenancy stack.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

#: namespace owner of publicly shared prefixes (readable by any granted
#: tenant; pages charged to the commons pocket)
PUBLIC = "__public__"
#: the shared leftover pocket: unknown / quota-less tenants and public
#: pages draw from here
COMMONS = "__shared__"
#: tenant of a Request that never named one
DEFAULT_TENANT = "default"


def request_cost(req) -> int:
    """Scheduling/bucket cost of one request, in token positions: the
    prompt it will prefill plus the decode budget it may spend."""
    return int(len(req.prompt) + max(int(req.max_new_tokens), 1))


@dataclasses.dataclass
class TokenBucket:
    """Classic token bucket: ``burst`` capacity refilled at ``rate``/s.

    ``rate=None`` disables throttling (always admits).  ``now`` is
    injectable everywhere for simulated-time tests."""

    rate: Optional[float]
    burst: float
    tokens: float = 0.0
    last: Optional[float] = None

    def __post_init__(self):
        self.tokens = self.burst

    def _refill(self, now: float):
        if self.last is not None and self.rate is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
        self.last = now

    def peek(self, cost: float, now: Optional[float] = None) -> bool:
        """Would ``take`` succeed right now (refills, does not consume)?"""
        if self.rate is None:
            return True
        self._refill(time.monotonic() if now is None else now)
        return self.tokens >= cost

    def take(self, cost: float, now: Optional[float] = None) -> bool:
        if self.rate is None:
            return True
        self._refill(time.monotonic() if now is None else now)
        if self.tokens < cost:
            return False
        self.tokens -= cost
        return True


class TenantRegistry:
    """Resolved per-tenant QoS state for one serving surface.

    Built from the tenant specs a serving cell declares (the spec types
    come with the control-plane port).  Unknown tenants
    resolve to commons defaults (weight 1, no bucket, commons pocket),
    so tagging requests is never mandatory.
    """

    def __init__(self, specs: Sequence = (), *, buckets: bool = True):
        self.specs = {t.name: t for t in specs}
        self.buckets: Dict[str, TokenBucket] = {}
        if buckets:
            for t in specs:
                if t.rate is not None:
                    self.buckets[t.name] = TokenBucket(
                        rate=t.rate,
                        burst=t.burst if t.burst is not None else t.rate)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def weight(self, tenant: str) -> float:
        spec = self.specs.get(tenant)
        return spec.weight if spec is not None else 1.0

    def bucket(self, tenant: str) -> Optional[TokenBucket]:
        return self.buckets.get(tenant)

    def share_public(self, tenant: str) -> bool:
        spec = self.specs.get(tenant)
        return spec.share_public if spec is not None else True

    def slo(self, tenant: str):
        spec = self.specs.get(tenant)
        return spec.slo if spec is not None else None

    def page_quotas(self, num_pages: int) -> Dict[str, int]:
        """Partition ``num_pages`` into per-tenant pockets.

        Explicit ``page_quota`` fractions floor to whole pages; whatever
        the fractions do not reserve is the :data:`COMMONS` pocket,
        shared by quota-less tenants, unknown tenants, and the public
        namespace's interned pages.  Pockets always sum to exactly
        ``num_pages`` — the bulkhead invariant the pool enforces.
        """
        out: Dict[str, int] = {}
        reserved = 0
        for t in self.specs.values():
            if t.page_quota is not None:
                q = int(t.page_quota * num_pages)
                out[t.name] = q
                reserved += q
        out[COMMONS] = num_pages - reserved
        return out


class TenantScheduler:
    """Deficit-round-robin admission over a shared FIFO queue.

    One scheduler instance persists across ticks (deficits carry over).
    :meth:`select` walks the queue as per-tenant FIFOs in round-robin
    order; each round a tenant's deficit grows by ``quantum * weight``
    and it may admit queued requests while the deficit covers their
    :func:`request_cost`.  The classic DRR bound holds: between two
    continuously-backlogged tenants the weighted served-work difference
    never exceeds one quantum plus one maximal request cost.

    Admission is three-gated, in order:

    1. **token bucket** — a drained bucket blocks the tenant's whole
       FIFO (rate limiting is per tenant and order-preserving) but
       never anyone else's;
    2. **deficit** — out of deficit ends the tenant's round;
    3. **``try_admit(req)``** — the caller's resource gate (free slot +
       KV-page admission).  A ``False`` skips *that request only* and
       scanning continues with the tenant's next one: a huge prompt
       blocked on pool pages must not head-of-line-block a small prompt
       (same tenant or any other) whose pages would fit.

    Admitted requests are removed from ``queue``; everything else keeps
    its relative order.
    """

    def __init__(self, registry: TenantRegistry, *, quantum: int = 256):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.registry = registry
        self.quantum = quantum
        self.deficit: Dict[str, float] = {}
        self._order: List[str] = []     # persistent round-robin rotation
        # tenant whose round a budget cut interrupted mid-service: the
        # next select() resumes it with its REMAINING deficit (no fresh
        # quantum) — otherwise slot-bound ticks degenerate to unweighted
        # tenant alternation and weights stop mattering
        self._resume: Optional[str] = None
        self.served_cost: Dict[str, float] = {}
        self.throttled: Dict[str, int] = {}

    def _rotation(self, tenants: List[str]) -> List[str]:
        """Stable rotation: keep known tenants' relative order, append
        newcomers; start each select() where the last one left off."""
        for t in tenants:
            if t not in self._order:
                self._order.append(t)
        return [t for t in self._order if t in tenants]

    def select(self, queue: Deque, try_admit: Callable[[object], bool],
               *, budget: Optional[int] = None,
               now: Optional[float] = None) -> List:
        """Admit up to ``budget`` requests from ``queue`` fairly.

        Returns the admitted requests (already handed to ``try_admit``
        and removed from ``queue``)."""
        if not queue or budget == 0:
            return []
        per: Dict[str, List] = {}       # tenant -> FIFO of queued reqs
        for req in queue:
            per.setdefault(getattr(req, "tenant", DEFAULT_TENANT),
                           []).append(req)
        admitted: List = []
        active = self._rotation(list(per.keys()))
        resuming = self._resume if self._resume in active else None
        self._resume = None
        if resuming is not None:
            k = active.index(resuming)
            active = active[k:] + active[:k]
        while active and (budget is None or len(admitted) < budget):
            progressed = False
            deficit_limited = False     # a bigger deficit next round could
            for tenant in list(active):  # still unblock someone
                if budget is not None and len(admitted) >= budget:
                    break
                cands = per.get(tenant)
                if not cands:
                    active.remove(tenant)
                    self.deficit[tenant] = 0.0   # empty FIFO: no credit banks
                    continue
                quantum = self.quantum * self.registry.weight(tenant)
                if tenant == resuming:
                    # continuing the round a budget cut interrupted: the
                    # quantum was already granted, spend what is left
                    resuming = None
                else:
                    # banked credit is capped at one quantum past the
                    # costliest pending request: a tenant blocked on
                    # resources for many ticks must not save up an unfair
                    # burst for later.  The cap is ADDITIVE (cost + quantum)
                    # so it can never clip the normal serving path's
                    # leftover (always < one request) — clipping legitimate
                    # leftover would break the DRR fairness bound
                    cap = max(request_cost(r) for r in cands) + quantum
                    self.deficit[tenant] = min(
                        self.deficit.get(tenant, 0.0) + quantum, cap)
                bucket = self.registry.bucket(tenant)
                i = 0
                while i < len(cands):
                    if budget is not None and len(admitted) >= budget:
                        # round cut short with deficit and work left:
                        # this tenant, not the next, goes first next time
                        if self.deficit[tenant] >= request_cost(cands[i]):
                            self._resume = tenant
                        break
                    req = cands[i]
                    cost = request_cost(req)
                    if self.deficit[tenant] < cost:
                        deficit_limited = True
                        break
                    if bucket is not None and not bucket.peek(cost, now):
                        # rate-limited: the tenant's OWN queue waits, in
                        # order; other tenants are unaffected
                        self.throttled[tenant] = (
                            self.throttled.get(tenant, 0) + 1)
                        break
                    if not try_admit(req):
                        i += 1          # blocked on a resource: scan past
                        continue
                    if bucket is not None:
                        bucket.take(cost, now)
                    self.deficit[tenant] -= cost
                    self.served_cost[tenant] = (
                        self.served_cost.get(tenant, 0.0) + cost)
                    admitted.append(req)
                    cands.pop(i)
                    progressed = True
                if not cands:
                    per.pop(tenant, None)
                    active.remove(tenant)
                    self.deficit[tenant] = 0.0
            # keep rotating while deficits are the only binding gate (a
            # request costlier than one quantum earns credit each round);
            # anything else blocking (bucket, resources, empty) ends the
            # tick — those won't change until the caller's state does
            if not progressed and not deficit_limited:
                break
        if admitted:
            taken = {id(r) for r in admitted}
            kept = [r for r in queue if id(r) not in taken]
            queue.clear()
            queue.extend(kept)
            if self._resume is not None and self._resume in self._order:
                # an interrupted round resumes exactly where it stopped
                k = self._order.index(self._resume)
                self._order = self._order[k:] + self._order[:k]
            else:
                # resume the rotation after the last tenant that admitted
                last = getattr(admitted[-1], "tenant", DEFAULT_TENANT)
                if last in self._order:
                    k = self._order.index(last)
                    self._order = self._order[k + 1:] + self._order[:k + 1]
        return admitted

    def shed_victims(self, queue: Sequence, excess: int) -> List:
        """Pick ``excess`` requests to shed under overload: lowest
        ``weight`` tier first, newest-first within a tier — the paying
        tenant's queue survives a flood from the free tier."""
        if excess <= 0:
            return []
        ordered = sorted(
            enumerate(queue),
            key=lambda kv: (self.registry.weight(
                getattr(kv[1], "tenant", DEFAULT_TENANT)), -kv[0]))
        return [req for _, req in ordered[:excess]]
