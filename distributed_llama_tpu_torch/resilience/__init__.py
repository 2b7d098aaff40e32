"""Request control and recovery for the port's serving stack: a copy of what the JAX
package's resilience/ gives its engines, with its metric families and flight hooks.

- `errors.py` — the typed errors the engines raise and the HTTP layer maps to status
  codes, `classify()` (the scheduler's blast-radius switch: transient / request /
  engine) and `retriable()` (the durable router's mid-stream failover switch);
- `faults.py` — named, seeded fault-injection points (`faults.fire`), `DLLAMA_FAULTS`;
- `tenancy.py` — tenants: quotas (`TenantRegistry`, `TokenBucket`), the two-class
  weighted-fair wait queue (`WeightedFairQueue`, `FairGate`) and `DrainRate`, the
  completion-rate estimate behind `Retry-After`;
- `supervisor.py` — `EngineSupervisor`: a dispatch that hangs past a threshold fails the
  in-flight requests (retriable) and re-initializes the engine.
- `quiet_http.py` — `QuietServer`, the api_server's ThreadingHTTPServer that prints no
  traceback for a routine peer disconnect.
"""

from . import faults
from .errors import (DeadlineExceeded, EngineClosed, EngineDraining, EngineSaturated,
                     EngineWedged, FaultInjected, InvalidRequest, QuotaExceeded,
                     TransientDispatchError, classify, retriable)

__all__ = ["faults", "DeadlineExceeded", "EngineClosed", "EngineDraining",
           "EngineSaturated", "EngineWedged", "FaultInjected", "InvalidRequest",
           "QuotaExceeded", "TransientDispatchError", "classify", "retriable"]
