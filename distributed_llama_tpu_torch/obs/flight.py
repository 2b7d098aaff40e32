"""Per-request flight recorder: the last N completed request timelines (the port's copy
of the JAX package's obs/flight.py).

Aggregate histograms answer "how slow are requests"; they cannot answer "why
was THIS request slow". The flight recorder keeps one bounded timeline per
request — admission and queue wait, prefix-cache seed tokens, prefill
chunks, super-steps joined, parks/rollbacks/pipeline flushes, injected
faults (via the resilience/faults.py fire → `note_fault` hook), finish
reason, TTFT/TPOT/E2E — in a ring of the most recent completions, served by
api_server as JSON:

    GET /v1/requests            → recent completed + live summaries
    GET /v1/requests?slowest=K  → the K worst completed requests by E2E
    GET /v1/requests/<id>       → one request's full timeline
                                  (id = the chatcmpl-... request id, or its
                                  32-hex trace id from the merged trace)

plus a structured **slow log** (`--slow-log out.jsonl`): every completion
over `--slow-threshold` seconds appends its full record as one JSON line —
durable exemplars for offline analysis after the ring has rotated.

Discipline (same as obs/trace.py):

- **Zero-cost when disabled**: hot paths call module-level `event()`
  unconditionally; with no recorder installed that is one global None check.
- **Bounded everywhere**: completed records live in a ring of `capacity`
  (oldest evicted, counted); live records are capped (a leak of unfinished
  ids must not grow without bound — evicted-live is its own counter); each
  record holds at most `max_events` timeline entries (overflow counted on
  the record itself, so a truncated timeline is honest about it).
- **Thread-safe**: HTTP handler threads and the scheduler thread write
  concurrently; one lock guards both tables.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict

from . import reqctx

__all__ = ["FlightRecorder", "install", "uninstall", "current",
           "event", "start", "annotate", "finish", "note_fault"]


class FlightRecorder:
    def __init__(self, capacity: int = 256, *, live_capacity: int = 1024,
                 max_events: int = 512, slow_log: str | None = None,
                 slow_threshold: float = 1.0):
        assert capacity > 0 and live_capacity > 0 and max_events > 0
        self.capacity = capacity
        self.live_capacity = live_capacity
        self.max_events = max_events
        self.slow_log = slow_log
        self.slow_threshold_ms = slow_threshold * 1000.0
        self._live: "OrderedDict[str, dict]" = OrderedDict()
        self._done: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()  # guards: _live, _done, evicted_done, evicted_live
        # separate lock for the slow-log file: writes happen OUTSIDE the
        # table lock (file I/O must not stall the scheduler's event path)
        # but concurrent finishes must not interleave lines or double-open
        self._log_lock = threading.Lock()  # guards: _slow_fh
        self._slow_fh = None
        self.evicted_done = 0   # completed records rotated out of the ring
        self.evicted_live = 0   # live records dropped at live_capacity

    # -- recording ------------------------------------------------------

    def _new(self, rid: str, trace_id: str = "") -> dict:
        return {"id": rid, "trace_id": trace_id,
                "start_unix": time.time(), "_t0": time.perf_counter(),
                "events": [], "events_dropped": 0, "finish": None}

    def start(self, rid: str, trace_id: str = "", **meta) -> None:
        """Open (or enrich) a live record. Idempotent: the api layer and the
        engine both call it with whatever identity/meta they know."""
        if not rid:
            return
        with self._lock:
            rec = self._live.get(rid)
            if rec is None:
                rec = self._new(rid, trace_id)
                self._live[rid] = rec
                while len(self._live) > self.live_capacity:
                    self._live.popitem(last=False)
                    self.evicted_live += 1
            elif trace_id and not rec["trace_id"]:
                rec["trace_id"] = trace_id
            rec.update(meta)

    def event(self, rid: str, name: str, **attrs) -> None:
        """Append one timeline entry: {t_ms since record start, name, attrs}.
        Auto-opens the record so engine-side events never depend on the api
        layer having called start() first."""
        if not rid:
            return
        with self._lock:
            rec = self._live.get(rid)
            if rec is None:
                if rid in self._done:  # late event (post-done harvest etc.)
                    rec = self._done[rid]
                else:
                    rec = self._new(rid)
                    self._live[rid] = rec
                    while len(self._live) > self.live_capacity:
                        self._live.popitem(last=False)
                        self.evicted_live += 1
            if len(rec["events"]) >= self.max_events:
                rec["events_dropped"] += 1
                return
            ev = {"t_ms": round((time.perf_counter() - rec["_t0"]) * 1e3, 3),
                  "event": name}
            if attrs:
                ev.update(attrs)
            rec["events"].append(ev)

    def annotate(self, rid: str, **meta) -> None:
        if not rid:
            return
        with self._lock:
            rec = self._live.get(rid) or self._done.get(rid)
            if rec is not None:
                rec.update(meta)

    def drop(self, rid: str) -> None:
        """Discard a live record WITHOUT completing it — for requests shed
        before any engine work (admission-control 503s). A saturation burst
        produces rejects at shed rate; finishing each one would flood the
        slow log and churn every real completion out of the ring exactly
        during the incident the recorder exists to debug."""
        if rid:
            with self._lock:
                self._live.pop(rid, None)

    def finish(self, rid: str, finish: str | None = None, **meta) -> None:
        """Complete a record: move live → ring (or update an already-completed
        one — the engine finishes first, the api layer adds TTFT/E2E after),
        rotate the ring, and append the slow-log exemplar when over
        threshold. The exemplar is written AT MOST once per record, only by
        a finish carrying request-level numbers (`e2e_ms` from the api
        layer, or an `error`) — the engine-side completion alone would log
        a line missing exactly the latency fields the slow log exists for —
        and an ERRORED request is an exemplar regardless of latency (a
        200 ms fault-killed request is the primary debugging target)."""
        if not rid:
            return
        line = None
        with self._lock:
            rec = self._live.pop(rid, None)
            if rec is None:
                rec = self._done.get(rid)
                if rec is None:
                    return
                self._done.move_to_end(rid)
            else:
                rec["e2e_ms"] = round(
                    (time.perf_counter() - rec["_t0"]) * 1e3, 3)
                self._done[rid] = rec
            if finish is not None:
                rec["finish"] = finish
            rec.update(meta)
            while len(self._done) > self.capacity:
                self._done.popitem(last=False)
                self.evicted_done += 1
            if (self.slow_log and not rec.get("_slow_logged")
                    and ("e2e_ms" in meta or meta.get("error") is not None)
                    and (rec.get("e2e_ms", 0.0) >= self.slow_threshold_ms
                         or rec.get("error") is not None)):
                rec["_slow_logged"] = True
                # snapshot only: serialization of a 512-event record takes
                # ~ms and must not happen under the table lock the
                # scheduler's event() path contends on
                line = dict(rec)
                line["events"] = list(rec["events"])
        if line is not None:
            self._write_slow(json.dumps(self._export(line)))

    def _write_slow(self, line: str) -> None:
        try:
            with self._log_lock:
                if self._slow_fh is None:
                    self._slow_fh = open(self.slow_log, "a")  # dlint: ignore[lock-blocking] -- the log lock EXISTS to serialize this fd; only finish() paths contend, never the event() hot path
                self._slow_fh.write(line + "\n")
                self._slow_fh.flush()
        except OSError:
            pass  # an unwritable slow log must never fail a request

    # -- export ---------------------------------------------------------

    @staticmethod
    def _export(rec: dict) -> dict:
        return {k: v for k, v in rec.items() if not k.startswith("_")}

    def get(self, key: str) -> dict | None:
        """Lookup by request id, falling back to trace id (the merged fleet
        trace shows trace ids; the operator pastes one here)."""
        if not key:
            return None  # "" would trace-id-match any auto-started record
        with self._lock:
            rec = self._live.get(key) or self._done.get(key)
            if rec is None:
                for table in (self._done, self._live):
                    for r in reversed(table.values()):
                        if r["trace_id"] == key:
                            rec = r
                            break
                    if rec is not None:
                        break
            return self._export(rec) if rec is not None else None

    def _summary(self, rec: dict, live: bool) -> dict:
        return {"id": rec["id"], "trace_id": rec["trace_id"],
                "start_unix": rec["start_unix"], "live": live,
                "finish": rec["finish"], "e2e_ms": rec.get("e2e_ms"),
                "ttft_ms": rec.get("ttft_ms"), "events": len(rec["events"]),
                "tenant": rec.get("tenant"), "class": rec.get("class")}

    def requests(self, slowest: int = 0, tenant: str | None = None) -> dict:
        """Summary listing; `slowest=K` returns the K worst completed
        requests by E2E instead of recency order; `tenant=` keeps only the
        named tenant's records (the per-tenant debugging entry point —
        "show me THIS tenant's recent requests" during a fairness
        incident)."""
        with self._lock:
            done = [self._summary(r, False) for r in self._done.values()
                    if tenant is None or r.get("tenant") == tenant]
            live = [self._summary(r, True) for r in self._live.values()
                    if tenant is None or r.get("tenant") == tenant]
            # eviction counters snapshotted in the SAME critical section as
            # the tables: reading them after releasing the lock could pair
            # a pre-eviction listing with a post-eviction count (or a torn
            # counter) whenever a finish races the listing — found by the
            # lock-guard pass (docs/ANALYSIS.md)
            evicted, evicted_live = self.evicted_done, self.evicted_live
        if slowest > 0:
            done = sorted(done, key=lambda r: r.get("e2e_ms") or 0.0,
                          reverse=True)[:slowest]
            live = []
        else:
            done.reverse()  # newest first
        return {"completed": done, "live": live,
                "capacity": self.capacity, "evicted": evicted,
                "evicted_live": evicted_live}

    def close(self) -> None:
        with self._log_lock:
            if self._slow_fh is not None:
                try:
                    self._slow_fh.close()
                except OSError:
                    pass
                self._slow_fh = None


# ----------------------------------------------------------------------
# module-level switch (the instrumented hot paths call these directly)
# ----------------------------------------------------------------------

_recorder: FlightRecorder | None = None


def install(capacity: int = 256, **kw) -> FlightRecorder:
    """Enable flight recording process-wide (api_server does this at serve()
    time); a second install replaces the first — closing the predecessor's
    slow-log handle so a reinstall never leaks the fd or an unflushed
    tail line."""
    global _recorder
    if _recorder is not None:
        _recorder.close()
    _recorder = FlightRecorder(capacity, **kw)
    return _recorder


def uninstall() -> None:
    global _recorder
    if _recorder is not None:
        _recorder.close()
    _recorder = None


def current() -> FlightRecorder | None:
    return _recorder


def _resolve_rid(rid: str | None) -> str:
    if rid is not None:
        return rid
    ctx = reqctx.current()
    return ctx.request_id if ctx is not None else ""


def start(rid: str | None, trace_id: str = "", **meta) -> None:
    r = _recorder
    if r is not None:
        r.start(_resolve_rid(rid), trace_id, **meta)


def event(rid: str | None, name: str, **attrs) -> None:
    """Hot-path hook: one global None check when disabled. `rid=None` means
    "the current trace context's request" — call sites that have no request
    handle (sequential engine internals) resolve through reqctx."""
    r = _recorder
    if r is not None:
        r.event(_resolve_rid(rid), name, **attrs)


def annotate(rid: str | None, **meta) -> None:
    r = _recorder
    if r is not None:
        r.annotate(_resolve_rid(rid), **meta)


def finish(rid: str | None, finish: str | None = None, **meta) -> None:
    r = _recorder
    if r is not None:
        r.finish(_resolve_rid(rid), finish, **meta)


def drop(rid: str | None) -> None:
    r = _recorder
    if r is not None:
        r.drop(_resolve_rid(rid))


def note_fault(point: str, kind: str) -> None:
    """resilience/faults.py fire() → timeline hook: attribute an injected
    fault to the request whose context is active at the injection point
    (points that fire outside any request scope record nothing)."""
    r = _recorder
    if r is not None:
        ctx = reqctx.current()
        if ctx is not None and ctx.request_id:
            r.event(ctx.request_id, "fault_injected", point=point, kind=kind)
