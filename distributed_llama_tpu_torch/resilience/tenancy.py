"""Multi-tenant serving policy: a copy of the JAX package's resilience/tenancy.py.

The policy layer the port's BatchEngine scheduler shares with a fleet router:

- **TokenBucket / TenantRegistry** — per-tenant token-bucket quotas (rate/burst).
  Exhaustion raises `QuotaExceeded`, which the HTTP layer maps to 429 + Retry-After from
  the bucket's own refill arithmetic. Unknown tenant ids resolve to the `default` policy
  (shared bucket and weight), so what clients put in `X-Tenant` cannot grow the quota
  table.
- **WeightedFairQueue** — two-class (interactive > batch) start-time fair queueing over
  tenants: each item carries a virtual finish tag `max(V, F_tenant) + cost/weight`;
  dequeue serves the head with the minimum tag, interactive strictly before batch, so
  backlogged tenants get service in proportion to their weights and none starves another.
- **DrainRate** — a decayed-count EMA of completions/s: `retry_after(depth) = depth /
  rate`, floored and capped — the backoff hint every shed carries.
- **FairGate** — a capacity gate whose waiters are admitted in WeightedFairQueue order.

Standard library only, like the original.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .errors import QuotaExceeded

__all__ = ["TokenBucket", "TenantPolicy", "TenantRegistry",
           "WeightedFairQueue", "DrainRate", "FairGate", "CLASSES",
           "DEFAULT_TENANT", "sanitize_tenant"]

CLASSES = ("interactive", "batch")  # strict dequeue priority, left first
DEFAULT_TENANT = "default"

# X-Tenant values are client input: bound the charset/length BEFORE they
# reach flight records, journals, and log lines (metric labels are bounded
# separately by TenantRegistry.canonical)
_TENANT_RE = re.compile(r"[A-Za-z0-9._:-]{1,64}$")


def sanitize_tenant(raw: str | None) -> str:
    """Map a client-supplied tenant id (X-Tenant header) to the
    serving-local tenant id; unlabeled or garbage-labeled traffic is the
    default tenant."""
    raw = (raw or "").strip()
    return raw if raw and _TENANT_RE.match(raw) else DEFAULT_TENANT


class TokenBucket:
    """Classic token bucket on the monotonic clock. `rate` tokens/second
    refill up to `burst` capacity; `try_acquire(cost)` either debits and
    returns (True, 0.0) or returns (False, seconds-until-serviceable) for
    the Retry-After header. A cost above `burst` is clamped to it — a
    request larger than the bucket can ever hold still passes when the
    bucket is full (and drains it), instead of being unserviceable
    forever."""

    def __init__(self, rate: float, burst: float | None = None):
        assert rate > 0.0, "use no bucket at all for an unlimited tenant"
        self.rate = float(rate)
        self.burst = float(burst) if burst and burst > 0 else 2.0 * self.rate
        self._lock = threading.Lock()  # guards: _tokens, _t
        self._tokens = self.burst
        self._t = time.monotonic()

    def _refill(self, now: float) -> None:  # holds: self._lock
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, cost: float = 1.0) -> tuple[bool, float]:
        cost = min(max(float(cost), 0.0), self.burst)
        with self._lock:
            now = time.monotonic()
            self._refill(now)
            if self._tokens >= cost:
                self._tokens -= cost
                return True, 0.0
            return False, (cost - self._tokens) / self.rate

    def refund(self, cost: float) -> None:
        """Return a debit for work that received zero service (the request
        was shed after the quota check) — capped at burst, same clamp as
        the acquire side."""
        with self._lock:
            self._refill(time.monotonic())
            self._tokens = min(self.burst,
                               self._tokens + min(max(cost, 0.0),
                                                  self.burst))

    def available(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens


@dataclass
class TenantPolicy:
    """One tenant's configured policy. `weight` drives fair-share service;
    `rate`/`burst` (tokens/sec of prompt+decode work, 0 = unlimited) drive
    the admission quota."""

    name: str
    weight: float = 1.0
    rate: float = 0.0
    burst: float = 0.0
    bucket: TokenBucket | None = field(default=None, repr=False)
    # lifetime accounting (mutated only under the registry lock)
    admitted: int = 0
    throttled: int = 0

    def __post_init__(self):
        assert self.weight > 0.0, f"tenant {self.name!r}: weight must be > 0"
        if self.rate > 0.0 and self.bucket is None:
            self.bucket = TokenBucket(self.rate, self.burst or None)


class TenantRegistry:
    """The configured tenant set plus the `default` policy every unknown
    tenant id shares. Resolution never creates entries — arbitrary client
    `X-Tenant` values cannot grow the registry, the metric label space, or
    the quota table."""

    def __init__(self, policies: list[TenantPolicy] | None = None):
        self._policies: dict[str, TenantPolicy] = {}
        for p in (policies or []):
            self._policies[p.name] = p
        if DEFAULT_TENANT not in self._policies:
            self._policies[DEFAULT_TENANT] = TenantPolicy(DEFAULT_TENANT)
        self._lock = threading.Lock()  # guards: admitted/throttled counters

    @classmethod
    def parse(cls, spec: str) -> "TenantRegistry":
        """`"gold:weight=3,rate=200,burst=400;bronze:weight=1;default:rate=50"`
        — `;`-separated tenants, each `name[:k=v,...]` with keys weight /
        rate / burst. Malformed entries raise ValueError (configuration is
        operator input: fail loudly at startup, never guess)."""
        policies = []
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            name, _, kvs = part.partition(":")
            name = name.strip()
            if not name:
                raise ValueError(f"tenant entry without a name: {part!r}")
            kw: dict[str, float] = {}
            for kv in filter(None, (s.strip() for s in kvs.split(","))):
                k, eq, v = kv.partition("=")
                if not eq or k.strip() not in ("weight", "rate", "burst"):
                    raise ValueError(f"bad tenant option {kv!r} in {part!r} "
                                     "(want weight=/rate=/burst=)")
                kw[k.strip()] = float(v)
            policies.append(TenantPolicy(name, **kw))
        return cls(policies)

    def tenants(self) -> list[str]:
        return sorted(self._policies)

    def resolve(self, name: str | None) -> TenantPolicy:
        return self._policies.get(name or DEFAULT_TENANT,
                                  self._policies[DEFAULT_TENANT])

    def canonical(self, name: str | None) -> str:
        """The bounded metric-label identity: a configured tenant's own
        name, everything else collapsed to `default`."""
        n = name or DEFAULT_TENANT
        return n if n in self._policies else DEFAULT_TENANT

    def weight(self, name: str | None) -> float:
        return self.resolve(name).weight

    def set_quota(self, name: str, rate: float, burst: float = 0.0) -> None:
        """(Re)arm a tenant's token bucket at runtime: operators tune
        quotas live; the trace-driven load bench calibrates them against
        measured capacity. `rate <= 0` removes the quota."""
        pol = self.resolve(name)
        pol.rate = float(rate)
        pol.burst = float(burst)
        pol.bucket = (TokenBucket(pol.rate, pol.burst or None)
                      if rate > 0 else None)

    def acquire(self, name: str | None, cost: float = 1.0) -> TenantPolicy:
        """Debit `cost` from the tenant's quota bucket; raises QuotaExceeded
        (HTTP 429) with the bucket-derived Retry-After when exhausted."""
        pol = self.resolve(name)
        if pol.bucket is not None:
            ok, wait = pol.bucket.try_acquire(cost)
            if not ok:
                with self._lock:
                    pol.throttled += 1
                raise QuotaExceeded(
                    f"tenant {pol.name!r} quota exhausted "
                    f"({pol.rate:g} tokens/s, burst {pol.bucket.burst:g}); "
                    f"retry in {wait:.2f}s",
                    retry_after=max(wait, 0.05), tenant=pol.name)
        with self._lock:
            pol.admitted += 1
        return pol

    def refund(self, name: str | None, cost: float = 1.0) -> None:
        """Return a quota debit for a request shed with zero service."""
        pol = self.resolve(name)
        if pol.bucket is not None:
            pol.bucket.refund(cost)

    def stats(self) -> dict:
        with self._lock:
            return {p.name: {"weight": p.weight, "rate": p.rate,
                             "admitted": p.admitted, "throttled": p.throttled,
                             **({"bucket_tokens":
                                 round(p.bucket.available(), 1)}
                                if p.bucket is not None else {})}
                    for p in self._policies.values()}


class WeightedFairQueue:
    """Two-class start-time-fair queue over tenants (SFQ virtual time).

    NOT internally locked: the owner serializes access (the BatchEngine
    guards its instance with `_plock`; FairGate with its condition lock).
    Items are pushed with an explicit (tenant, klass, cost) or, via
    `append()`, with those read off the item's `tenant`/`klass`/`wfq_cost`
    attributes — the list-compatible surface the scheduler's drain/abort
    paths use. Per (tenant, class) FIFO order is preserved; across tenants
    the head with the minimum virtual finish tag is served; the interactive
    class is strictly served before batch (the documented shed/starve
    order: batch may wait behind interactive, tenants within a class may
    not starve each other)."""

    def __init__(self, registry: TenantRegistry | None = None):
        self._reg = registry
        # (tenant, klass) -> deque[(finish_tag, cost/weight, item)]
        self._q: dict[tuple[str, str], deque] = {}
        self._ftag: dict[tuple[str, str], float] = {}
        self._vt = {k: 0.0 for k in CLASSES}
        self._n = 0

    def _weight(self, tenant: str) -> float:
        return self._reg.weight(tenant) if self._reg is not None else 1.0

    @staticmethod
    def _item_key(item) -> tuple[str, str, float]:
        return (getattr(item, "tenant", DEFAULT_TENANT) or DEFAULT_TENANT,
                getattr(item, "klass", "interactive") or "interactive",
                float(getattr(item, "wfq_cost", 1.0) or 1.0))

    def push(self, item, tenant: str | None = None, klass: str | None = None,
             cost: float | None = None) -> None:
        dt, dk, dc = self._item_key(item)
        tenant = tenant if tenant is not None else dt
        klass = klass if klass is not None else dk
        cost = float(cost) if cost is not None else dc
        if klass not in CLASSES:
            klass = "interactive"
        key = (tenant, klass)
        cw = max(cost, 1e-9) / self._weight(tenant)
        tag = max(self._vt[klass], self._ftag.get(key, 0.0)) + cw
        self._ftag[key] = tag
        self._q.setdefault(key, deque()).append((tag, cw, item))
        self._n += 1

    def append(self, item) -> None:
        self.push(item)

    def _head_key(self) -> tuple[str, str] | None:
        for klass in CLASSES:
            best_key, best_tag = None, None
            for key, dq in self._q.items():
                if key[1] != klass or not dq:
                    continue
                if best_tag is None or dq[0][0] < best_tag:
                    best_key, best_tag = key, dq[0][0]
            if best_key is not None:
                return best_key
        return None

    def peek_next(self):
        key = self._head_key()
        return self._q[key][0][2] if key is not None else None

    def pop_next(self):
        key = self._head_key()
        if key is None:
            return None
        tag, _cw, item = self._q[key].popleft()
        self._vt[key[1]] = max(self._vt[key[1]], tag)
        self._n -= 1
        return item

    def entry_tag(self, tenant: str, klass: str, cost: float) -> float:
        """The virtual finish tag a push would receive, WITHOUT pushing —
        the weighted-shed comparison key: an arrival more entitled than
        the queue's worst resident (smaller tag) displaces it instead of
        being shed itself."""
        key = (tenant, klass)
        cw = max(cost, 1e-9) / self._weight(tenant)
        return max(self._vt[klass], self._ftag.get(key, 0.0)) + cw

    def last_tag(self, klass: str) -> float | None:
        """The maximum queued finish tag of `klass` (the least-entitled
        resident — what evict_last would remove), or None when empty."""
        tags = [dq[-1][0] for key, dq in self._q.items()
                if key[1] == klass and dq]
        return max(tags) if tags else None

    def evict_last(self, klass: str):
        """Remove and return the LEAST-entitled queued item of `klass` (the
        maximum finish tag — the newest arrival of the most-backlogged
        tenant), or None. The shed-batch-before-interactive lever: an
        interactive admission displacing queued batch work evicts the item
        fair queueing would have served last. The tenant's finish tag is
        rolled back so its next push is not charged for service it never
        received."""
        best_key, best_tag = None, None
        for key, dq in self._q.items():
            if key[1] != klass or not dq:
                continue
            if best_tag is None or dq[-1][0] > best_tag:
                best_key, best_tag = key, dq[-1][0]
        if best_key is None:
            return None
        tag, cw, item = self._q[best_key].pop()
        self._ftag[best_key] = tag - cw
        self._n -= 1
        return item

    def remove(self, item) -> bool:
        """Drop one specific queued item (cancel/expiry reaping)."""
        for key, dq in self._q.items():
            for entry in dq:
                if entry[2] is item:
                    dq.remove(entry)
                    self._n -= 1
                    if not dq:
                        # a mid-queue gap leaves later tags unchanged (they
                        # already embed this item's virtual service; the
                        # error is one item's cost, bounded and transient)
                        self._ftag[key] = max(self._ftag.get(key, 0.0),
                                              self._vt[key[1]])
                    return True
        return False

    def clear(self) -> None:
        """Abort-path reset (engine close / fail-all / wedge recovery):
        drops the items AND the per-tenant tags — after a recovery every
        request was failed, so carrying a tenant's pre-wedge virtual
        service forward would starve it against tenants that happened to
        be idle when the engine wedged."""
        self._q.clear()
        self._ftag.clear()
        self._vt = {k: 0.0 for k in CLASSES}
        self._n = 0

    def __iter__(self):
        for dq in self._q.values():
            for _tag, _cw, item in dq:
                yield item

    def __len__(self) -> int:
        return self._n

    def class_depth(self, klass: str) -> int:
        return sum(len(dq) for key, dq in self._q.items() if key[1] == klass)


class DrainRate:
    """Decayed-count EMA of service completions/sec → honest backoff hints.

    `note()` records one completion; the count decays with time constant
    `tau`, so `rate() ≈ completions/sec` over roughly the last `tau`
    seconds. `retry_after(depth)` is the measured time for the queue to
    drain `depth` items, floored (clients must not busy-spin on a fast
    queue) and capped (a stall must not quote an hour). Before any
    completion has been observed, `rate()` is 0 and `queue_wait()` returns
    0.0 — cold-start must never shed on a fabricated estimate — while
    `retry_after()` returns the floor."""

    def __init__(self, floor: float = 1.0, cap: float = 60.0,
                 tau: float = 10.0):
        self.floor = floor
        self.cap = cap
        self.tau = tau
        self._lock = threading.Lock()  # guards: _c, _t
        self._c = 0.0
        self._t: float | None = None

    def note(self, n: float = 1.0) -> None:
        with self._lock:
            now = time.monotonic()
            if self._t is not None:
                self._c *= math.exp(-(now - self._t) / self.tau)
            self._t = now
            self._c += n

    def rate(self) -> float:
        with self._lock:
            if self._t is None:
                return 0.0
            c = self._c * math.exp(-(time.monotonic() - self._t) / self.tau)
            return c / self.tau

    def queue_wait(self, depth: float) -> float:
        r = self.rate()
        return depth / r if r > 0.0 else 0.0

    def retry_after(self, depth: float) -> float:
        r = self.rate()
        if r <= 0.0:
            return self.floor
        return min(max(depth / r, self.floor), self.cap)


class FairGate:
    """Bounded concurrency gate admitting waiters in weighted-fair order.

    A plain semaphore hands capacity to whichever thread the OS wakes; under
    fleet saturation that lets one flooding tenant's handler threads take
    every slot. `acquire(tenant, klass, cost, timeout)` instead parks the
    caller in a WeightedFairQueue and admits strictly in its order —
    interactive before batch, tenants by weight — as `release()` frees
    capacity. `capacity <= 0` disables the gate (acquire always succeeds
    immediately). Returns False on timeout (the caller sheds with
    Retry-After)."""

    def __init__(self, capacity: int, registry: TenantRegistry | None = None):
        self.capacity = int(capacity)
        self._wfq = WeightedFairQueue(registry)
        self._cond = threading.Condition()  # guards: _active, _wfq
        self._active = 0

    def acquire(self, tenant: str = DEFAULT_TENANT,
                klass: str = "interactive", cost: float = 1.0,
                timeout: float | None = None) -> bool:
        if self.capacity <= 0:
            return True
        ticket = object()
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            if self._active < self.capacity and not len(self._wfq):
                self._active += 1
                return True
            self._wfq.push(ticket, tenant, klass, cost)
            while True:
                if (self._active < self.capacity
                        and self._wfq.peek_next() is ticket):
                    self._wfq.pop_next()
                    self._active += 1
                    return True
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0:
                        self._wfq.remove(ticket)
                        # a departing head must hand the evaluation to the
                        # next waiter, or free capacity could sit idle
                        self._cond.notify_all()
                        return False
                self._cond.wait(timeout=remaining)

    def release(self) -> None:
        if self.capacity <= 0:
            return
        with self._cond:
            self._active = max(self._active - 1, 0)
            self._cond.notify_all()

    def waiting(self) -> int:
        with self._cond:
            return len(self._wfq)
