"""Request-scoped trace context: W3C trace-context propagation for the fleet (the port's
copy of the JAX package's obs/reqctx.py).

Before this module existed, no request identity existed anywhere in the
serving stack: the fleet router proxied anonymous bodies, api_server handled
anonymous completions, and the BatchEngine scheduler batched anonymous rows —
a slow or failed request could not be followed from router proxy → replica
HTTP handler → BatchEngine queue → super-step. This module is that identity:

- **TraceContext** — a 128-bit trace id + 64-bit span id (+ sampled flags and
  a serving-local request id), serialized on the wire as the W3C
  `traceparent` header (`00-<32 hex trace>-<16 hex span>-<2 hex flags>`).
  The fleet router ORIGINATES a context per request (or adopts an inbound
  header from an upstream caller), stamps a fresh child span id on every
  proxied hop, and the replica's api_server adopts the header again — so one
  trace id spans the whole fleet path.
- **contextvars carrier** — `use(ctx)` binds the context to the current
  thread's execution context; `current()` reads it. Within one thread
  (api_server handler running the sequential engine) propagation is free.
  The BatchEngine scheduler is a DIFFERENT thread serving many requests per
  super-step, so there is no ambient context to inherit: the scheduler
  re-enters each request's captured context explicitly (`use(req.ctx)`)
  around per-request work — admission, prefill, per-row block delivery — and
  the tracer (obs/trace.py) stamps `trace_id` onto any span/instant recorded
  while a context is active. That is how engine-side events carry the owning
  request's trace id even though one dispatch serves many requests.

Cost discipline matches the rest of obs/: a dataclass + one contextvar
set/reset per scoped region; reading `current()` happens only behind the
"tracer installed" / "flight recorder installed" checks, so the disabled
hot path stays inside the <1% gate of chip_smoke.py's obs phase.
"""

from __future__ import annotations

import contextvars
import os
import re
from dataclasses import dataclass

__all__ = ["TraceContext", "new_context", "parse_traceparent", "adopt",
           "current", "use"]

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.*)?$")


def _rand_hex(nbytes: int) -> str:
    """Non-zero random hex id (the W3C spec reserves the all-zero id as
    invalid; os.urandom returning all zeros is astronomically unlikely but
    the retry costs nothing)."""
    while True:
        h = os.urandom(nbytes).hex()
        if any(c != "0" for c in h):
            return h


@dataclass(frozen=True)
class TraceContext:
    """One request's position in a distributed trace. `trace_id` is shared
    by every hop; `span_id` identifies THIS hop's work; `request_id` is the
    serving-local id (`chatcmpl-...`) the flight recorder keys on — it never
    goes on the wire (traceparent carries only trace/span/flags).
    `tenant` is the serving-local tenant id the HTTP layer mapped from
    `X-Tenant` (docs/SERVING.md "Multi-tenant serving") — like request_id it
    rides the context, not the wire (the router relays the header itself),
    so engine-side flight events and slow-log exemplars attribute work to
    the owning tenant."""

    trace_id: str        # 32 lowercase hex chars (128-bit)
    span_id: str         # 16 lowercase hex chars (64-bit)
    flags: int = 1       # W3C trace-flags; 01 = sampled
    request_id: str = ""
    tenant: str = ""

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def child(self, request_id: str | None = None) -> "TraceContext":
        """Same trace, fresh span id — one per proxied hop / work unit."""
        return TraceContext(self.trace_id, _rand_hex(8), self.flags,
                            self.request_id if request_id is None
                            else request_id, self.tenant)


def new_context(request_id: str = "", tenant: str = "") -> TraceContext:
    """Originate a trace (the fleet router's job for header-less clients)."""
    return TraceContext(_rand_hex(16), _rand_hex(8), 1, request_id, tenant)


def parse_traceparent(header: str | None) -> TraceContext | None:
    """W3C parse; None on anything malformed (an unparseable header must
    start a fresh trace, never crash the request). Per spec: version 0xff
    and all-zero trace/span ids are invalid; version 00 defines EXACTLY
    four fields; a future version (> 00) parses by its first four fields
    with any trailing `-...` ignored — forward compatibility, so a trace
    from a newer upstream proxy still joins instead of silently forking."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags, rest = m.groups()
    if version == "ff" or (version == "00" and rest):
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


def adopt(header: str | None, request_id: str = "",
          tenant: str = "") -> TraceContext:
    """Continue an inbound trace (fresh child span id) or originate one:
    the single call a server entry point needs. `tenant` stamps the
    serving-local tenant id either way (the wire header carries only
    trace/span/flags)."""
    parent = parse_traceparent(header)
    if parent is None:
        return new_context(request_id, tenant)
    ctx = parent.child(request_id=request_id)
    if tenant:
        import dataclasses

        ctx = dataclasses.replace(ctx, tenant=tenant)
    return ctx


_var: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "dllama_reqctx", default=None)


def current() -> TraceContext | None:
    return _var.get()


class use:
    """`with use(ctx):` — bind `ctx` for the block (None explicitly clears:
    a scheduler loop between per-request regions must not leak the previous
    request's identity onto engine-scope events). A slotted class, not
    @contextmanager: this sits on per-token scheduler paths and the plain
    set/reset pair is ~3x cheaper than a generator frame
    (chip_smoke.py's obs phase includes it in the gated bundle)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx

    def __enter__(self) -> TraceContext | None:
        self._token = _var.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _var.reset(self._token)
        return False
