"""Typed serving errors: a copy of what the batched engine needs of the JAX package's
resilience/errors.py.

`classify()` is the blast-radius switch of the BatchEngine scheduler: an exception that
carries `fault_scope = "request"` (the pool's KVPoolExhausted) fails only the request it
is attributed to; anything else is "engine" scope and fails every in-flight request
while the scheduler thread survives.
"""

from __future__ import annotations

__all__ = ["EngineClosed", "InvalidRequest", "classify"]


class EngineClosed(RuntimeError):
    """The engine is shut down; queued/in-flight requests were aborted."""


class InvalidRequest(ValueError):
    """The request itself is malformed (prompt exceeds seq_len, bad max_tokens): an
    HTTP 400, never a 500 or a stall."""


def classify(exc: BaseException) -> str:
    """Blast radius of an exception: 'request' when it carries fault_scope = "request",
    else 'engine' — an unattributed dispatch failure may have left the shared caches
    indeterminate."""
    return "request" if getattr(exc, "fault_scope", None) == "request" else "engine"
