"""Service-rate estimation for honest backoff hints: a copy of `DrainRate` from the JAX
package's resilience/tenancy.py (the rest of that module — tenants, weighted-fair
queueing, SLO shedding — is not part of the port yet)."""

from __future__ import annotations

import math
import threading
import time

__all__ = ["DrainRate"]


class DrainRate:
    """Decayed-count EMA of completions per second.

    `note()` records one completion; the count decays with time constant `tau`, so
    `rate()` ~ completions/s over roughly the last `tau` seconds. `retry_after(depth)`
    is the measured time for the queue to drain `depth` items, floored (clients must not
    busy-spin on a fast queue) and capped (a stall must not quote an hour). Before any
    completion `rate()` is 0, `queue_wait()` 0.0 and `retry_after()` the floor."""

    def __init__(self, floor: float = 1.0, cap: float = 60.0, tau: float = 10.0):
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
