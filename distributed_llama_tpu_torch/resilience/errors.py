"""Typed serving errors: a copy of the JAX package's resilience/errors.py.

    EngineClosed / EngineDraining  -> 503 (server going away)
    EngineSaturated                -> 503 + Retry-After (load shed)
    EngineWedged                   -> 503 server_wedged (retriable elsewhere)
    QuotaExceeded                  -> 429 + Retry-After (tenant quota)
    DeadlineExceeded               -> 408 (queue TTL / generation deadline)
    InvalidRequest                 -> 400 (caller error, not server error)
    TransientDispatchError         -> retried by the scheduler, surfaced only when
                                      the retries are exhausted

`classify()` is the BatchEngine scheduler's blast-radius switch: every exception out of
a dispatch is `transient` (retry in place, before anything reached the device),
`request` (fail only the attributable request; the other co-batched rows keep decoding)
or `engine` (fail every in-flight request, survive, back off). An exception may carry
an explicit `fault_scope`: the fault injector (faults.py) and the KV pool's
KVPoolExhausted ("request") use it.
"""

from __future__ import annotations

__all__ = ["EngineClosed", "EngineDraining", "EngineSaturated", "QuotaExceeded",
           "DeadlineExceeded", "InvalidRequest", "TransientDispatchError",
           "EngineWedged", "FaultInjected", "classify", "retriable"]


class EngineClosed(RuntimeError):
    """The engine is shut down; queued/in-flight requests were aborted."""


class EngineDraining(EngineClosed):
    """The engine is draining (SIGTERM): in-flight requests finish, new admissions are
    refused. A subclass of EngineClosed, so `except EngineClosed` covers both."""


class EngineSaturated(RuntimeError):
    """Admission refused: the wait queue is at max_queue. `retry_after` (seconds,
    advisory) comes from the measured queue drain rate (tenancy.DrainRate), for the HTTP
    503 Retry-After header."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class QuotaExceeded(RuntimeError):
    """A tenant's token-bucket quota is exhausted: HTTP 429 + Retry-After. Not
    retriable on another replica: the quota is the tenant's, not the replica's."""

    def __init__(self, msg: str, retry_after: float = 1.0, tenant: str = ""):
        super().__init__(msg)
        self.retry_after = retry_after
        self.tenant = tenant


class DeadlineExceeded(RuntimeError):
    """The request's queue TTL or wall-clock generation deadline expired before its
    first token (finish reason "deadline")."""


class InvalidRequest(ValueError):
    """The request itself is malformed (prompt exceeds seq_len, bad max_tokens): a 400,
    never a 500 or a stall."""


class TransientDispatchError(RuntimeError):
    """A dispatch failure expected to succeed on retry. The scheduler retries these with
    capped exponential backoff before treating them as engine scope."""

    fault_scope = "transient"


class EngineWedged(RuntimeError):
    """The supervisor saw the engine make no dispatch progress past its threshold and
    failed this in-flight request while it re-initializes the engine
    (supervisor.py). Retriable: the request is innocent, and a fleet router resumes it
    on another replica."""


class FaultInjected(RuntimeError):
    """Raised by the fault injector at a named point. `scope` declares the blast radius
    the scheduler may assume: "request" faults are attributable to one request (the
    injection fired before any shared state changed), "engine" faults are not."""

    def __init__(self, msg: str, scope: str = "request"):
        super().__init__(msg)
        assert scope in ("request", "engine"), scope
        self.fault_scope = scope


def classify(exc: BaseException) -> str:
    """Blast radius of an exception: 'transient' | 'request' | 'engine'. An explicit
    `fault_scope` attribute wins; anything else is 'engine' — an unattributed dispatch
    failure may have left the shared caches indeterminate."""
    scope = getattr(exc, "fault_scope", None)
    if scope in ("transient", "request", "engine"):
        return scope
    return "engine"


def retriable(exc: BaseException) -> bool:
    """Whether a request that failed with `exc` may be resumed on another replica
    without changing what the client sees (the durable router's failover switch):
    caller errors, expired deadlines, load sheds and quota refusals are not; a
    request-scope injected fault is not (a resume could loop on a deterministic
    trigger); everything else — a wedged or closed engine, exhausted transient retries,
    engine-scope faults, unclassified server errors — is."""
    if isinstance(exc, (DeadlineExceeded, ValueError, EngineSaturated, QuotaExceeded)):
        return False
    if isinstance(exc, FaultInjected):
        return exc.fault_scope == "engine"
    return True
