"""Structured span tracing with Chrome trace-event export: the port's copy of the JAX
package's obs/trace.py, with a torch.profiler pass-through.

The reference engine's only timeline is the per-token G/I/T printout
(dllama.cpp:76-93); one number per token, averaged, gone when the process
exits. This tracer records *spans* — named wall-clock intervals with nesting
(prefill chunks inside a prefill, super-steps inside a request) — into a
bounded in-memory ring buffer and exports them as Chrome trace-event JSON,
loadable in Perfetto (ui.perfetto.dev) or chrome://tracing.

Design constraints, in priority order:

1. **Zero-cost when disabled.** Every hot path in the repo calls
   `obs.trace.span(...)` unconditionally; when no tracer is installed the
   call returns a shared no-op context manager (one global lookup + one
   function call, no allocation). chip_smoke.py's obs phase holds this under 1% of
   a one-token CUDA graph replay.
2. **Thread-safe.** The BatchEngine scheduler thread, HTTP handler threads,
   and the main thread all emit spans concurrently; the buffer is a
   lock-guarded deque and span timing state lives on the span object itself
   (never in shared state).
3. **Bounded.** The ring buffer drops the OLDEST events past `capacity` —
   a long-running server never grows without bound; `dropped_events` counts
   what was lost so an exported trace is honest about truncation.
4. **Monotonic clocks.** Timestamps come from time.perf_counter_ns()
   relative to tracer start; wall-clock (time.time) appears once in the
   export metadata, so NTP steps can never fold spans over each other.

Optional `torch.profiler` pass-through: with `annotate=True` each span also
enters `torch.profiler.record_function(name)`, so under torch.profiler the span
is a range that encloses the kernels it launched, under the same name. A
failure to annotate leaves the span recording.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import reqctx

__all__ = ["Tracer", "span", "instant", "install", "uninstall", "current",
           "set_process_name", "merge_chrome_traces"]


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args) -> None:  # parity with _Span.add
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: created by Tracer.span(), recorded at __exit__.

    `tracer=None` makes the span MODULE-RESOLVED: it records through
    whichever tracer is installed at exit time. Module-level span() uses
    this so a tracer replaced mid-span (install() while spans are in
    flight) receives the event instead of the orphaned predecessor's buffer
    silently swallowing it. A span that ENTERED before the new tracer's
    epoch records a negative ts — correct, not a bug: epochs and span
    clocks read the same monotonic counter, so wall_start_unix + ts still
    names the true absolute time (and merge_chrome_traces aligns on exactly
    that anchor). Spans created via a Tracer instance directly stay bound
    to that instance (tests own their tracer)."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_annot")

    def __init__(self, tracer: "Tracer | None", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._annot = None

    def add(self, **args) -> None:
        """Attach result metadata discovered mid-span (token counts, sizes)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)

    def __enter__(self):
        t = self._tracer if self._tracer is not None else _tracer
        if t is not None and t._annotate:
            try:
                import torch.profiler

                self._annot = torch.profiler.record_function(self.name)
                self._annot.__enter__()
            except Exception:
                self._annot = None  # profiler range unavailable: spans still record
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        t = self._tracer if self._tracer is not None else _tracer
        if t is not None:  # uninstalled mid-span: nowhere to record
            t._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    Spans are recorded AT EXIT as Chrome "X" (complete) events — start
    timestamp + duration — so nesting in the viewer is purely geometric:
    a child span's [ts, ts+dur] interval lies inside its parent's, because
    the child entered after and exited before on the same thread.
    """

    def __init__(self, capacity: int = 65536, *, annotate: bool = False,
                 pid: int | None = None, process_name: str | None = None):
        assert capacity > 0
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()  # guards: _events, _thread_names, dropped_events
        self._annotate = annotate
        self._epoch_ns = time.perf_counter_ns()
        self._wall_start = time.time()
        self.dropped_events = 0
        self._thread_names: dict[int, str] = {}
        # real process identity: every event used to hardcode pid 1, which
        # made multi-process merge (fleet router + N replicas into one
        # Perfetto file) impossible — identical pids folded every process
        # onto one track. process_name labels the pid track in the viewer;
        # servers set it once their bound address is known.
        self.pid = os.getpid() if pid is None else pid
        self.process_name = process_name

    # -- recording ------------------------------------------------------

    def span(self, name: str, args: dict | None = None) -> _Span:
        return _Span(self, name, args)

    @staticmethod
    def _stamp_trace(args: dict | None) -> dict | None:
        """Stamp the active request context's trace id onto event args —
        the engine-side half of distributed tracing: any span/instant
        recorded while reqctx is bound carries the owning request's trace
        id (searchable in Perfetto, joinable with the router's spans).
        Runs only when a tracer IS installed, so the disabled path never
        touches the contextvar."""
        ctx = reqctx.current()
        if ctx is None:
            return args
        args = dict(args) if args else {}
        args.setdefault("trace_id", ctx.trace_id)
        return args

    def instant(self, name: str, args: dict | None = None) -> None:
        """Point-in-time marker (Chrome "i" event)."""
        ts = (time.perf_counter_ns() - self._epoch_ns) / 1e3
        args = self._stamp_trace(args)
        self._append({"name": name, "ph": "i", "ts": ts, "s": "t",
                      "pid": self.pid, "tid": threading.get_ident(),
                      **({"args": args} if args else {})})

    def _record(self, name: str, t0_ns: int, t1_ns: int,
                args: dict | None) -> None:
        args = self._stamp_trace(args)
        ev = {"name": name, "ph": "X",
              "ts": (t0_ns - self._epoch_ns) / 1e3,  # Chrome wants microseconds
              "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, ev: dict) -> None:
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if len(self._events) == self.capacity:
                self.dropped_events += 1
            self._events.append(ev)

    # -- export ---------------------------------------------------------

    def _snapshot(self) -> tuple[list[dict], dict, int]:
        """(events, thread names, dropped count) taken in ONE critical
        section, so an export can never pair a pre-drop event list with a
        post-drop counter (the torn-pair class the lock-guard pass flags)."""
        with self._lock:
            return (list(self._events), dict(self._thread_names),
                    self.dropped_events)

    def _meta_events(self, names: dict) -> list[dict]:
        meta = []
        if self.process_name:
            meta.append({"name": "process_name", "ph": "M", "pid": self.pid,
                         "args": {"name": self.process_name}})
        meta.extend({"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid, "args": {"name": tname}}
                    for tid, tname in sorted(names.items()))
        return meta

    def events(self) -> list[dict]:
        """Snapshot of buffered events (oldest first), plus process/thread
        metadata."""
        evs, names, _dropped = self._snapshot()
        return self._meta_events(names) + evs

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (load in Perfetto as-is).
        `wall_start_unix` is the wall clock at the tracer's monotonic epoch —
        the alignment anchor merge_chrome_traces() shifts each process's
        timestamps by, so a fleet's traces share one timeline."""
        evs, names, dropped = self._snapshot()  # ONE critical section
        return {
            "traceEvents": self._meta_events(names) + evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_start_unix": self._wall_start,
                "dropped_events": dropped,
                "pid": self.pid,
                "process_name": self.process_name,
            },
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped_events = 0


# ----------------------------------------------------------------------
# module-level switch: the instrumented hot paths call these directly
# ----------------------------------------------------------------------

_tracer: Tracer | None = None


def install(capacity: int = 65536, *, annotate: bool = False,
            process_name: str | None = None) -> Tracer:
    """Enable tracing process-wide; returns the tracer. A second install
    replaces the first; module-level spans already in flight record through
    the NEW tracer at exit (they resolve the installed tracer at record
    time), so a replace can no longer strand events in an orphaned buffer."""
    global _tracer
    _tracer = Tracer(capacity, annotate=annotate, process_name=process_name)
    return _tracer


def uninstall() -> None:
    global _tracer
    _tracer = None


def current() -> Tracer | None:
    return _tracer


def set_process_name(name: str) -> None:
    """Label the installed tracer's process track (servers call this once
    the bound host:port is known); no-op while tracing is disabled."""
    t = _tracer
    if t is not None:
        t.process_name = name


def span(name: str, args: dict | None = None):
    """`with span("engine.decode", {"t": 1}):` — no-op unless install()ed.

    Args are passed as an optional dict (not **kwargs) so the disabled path
    does not even build a dict per call site when the caller pre-builds
    nothing; callers that want rich args construct the dict inline, paying
    for it only at sites they chose to annotate."""
    if _tracer is None:
        return _NULL_SPAN
    # tracer=None: module-resolved — records through whichever tracer is
    # installed when the span exits (see _Span docstring)
    return _Span(None, name, args)


def instant(name: str, args: dict | None = None) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, args)


# ----------------------------------------------------------------------
# fleet merge
# ----------------------------------------------------------------------

def merge_chrome_traces(sources: list[tuple[str, dict]]) -> dict:
    """Merge per-process Chrome traces into ONE Perfetto-loadable document.

    `sources` is [(process label, to_chrome_trace() dict)] — e.g. the fleet
    router's own trace plus every replica's `GET /v1/trace` body. Each
    source gets a distinct pid (its index, so traces from different HOSTS
    with colliding OS pids still separate) labeled with a process_name
    metadata event, and its timestamps are shifted by the difference of the
    sources' `wall_start_unix` anchors onto the EARLIEST process's timeline
    — per-process clocks are monotonic, so after the one wall-clock
    alignment a request's router span and its replica spans sit in true
    temporal order (NTP skew between hosts bounds the residual error).
    `dropped_events` is summed; per-source drop counts are preserved in
    `otherData.processes`."""
    docs = [(label, doc) for label, doc in sources if doc]
    walls = [float((doc.get("otherData") or {}).get("wall_start_unix") or 0.0)
             for _label, doc in docs]
    base = min((w for w in walls if w), default=0.0)
    events: list[dict] = []
    processes = []
    dropped = 0
    for idx, ((label, doc), wall) in enumerate(zip(docs, walls), start=1):
        off_us = ((wall - base) * 1e6) if wall and base else 0.0
        events.append({"name": "process_name", "ph": "M", "pid": idx,
                       "args": {"name": label}})
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the merge's own label above
            ev = dict(ev)
            ev["pid"] = idx
            if "ts" in ev:
                ev["ts"] = ev["ts"] + off_us
            events.append(ev)
        src_dropped = int((doc.get("otherData") or {}).get("dropped_events")
                          or 0)
        dropped += src_dropped
        processes.append({"pid": idx, "name": label,
                          # the source process's real OS pid (the one its
                          # /metrics dllama_process_pid reports) — merged
                          # events carry the index pid, this is the join key
                          "os_pid": (doc.get("otherData") or {}).get("pid"),
                          "wall_start_unix": wall or None,
                          "dropped_events": src_dropped})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "wall_start_unix": base or None,
            "dropped_events": dropped,
            "processes": processes,
        },
    }
