"""Process self-telemetry: the serving process's own health on /metrics (the port's copy
of the JAX package's obs/process.py; the build-info gauge names torch where the JAX
package names jax).

A replica exposed rich request metrics but nothing about ITSELF — no uptime
(restart loops invisible), no RSS (a leaking prefix-cache pool looked like
healthy traffic), no thread count (handler-thread leaks invisible), and the
tracer's `dropped_events` truncation counter lived only inside `--trace`
dumps. `install_process_metrics()` registers callback gauges for all of
these plus a Prometheus info-style `dllama_build_info{python,torch}` gauge
(constant 1; the labels are the data) so a fleet scrape can tell which
interpreter/torch build each replica runs — version skew during a rolling
upgrade is exactly when per-replica attribution matters.

Dependency discipline: versions come from importlib.metadata, not from
importing torch, so this module stays stdlib-only.
Idempotent: callers re-invoke freely (api_server serve(), router serve,
tests); gauges are get-or-create and the callbacks are stateless reads.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from . import metrics, trace

__all__ = ["install_process_metrics"]

_START_T = time.monotonic()  # import time ~ process start for our entrypoints


def _rss_bytes() -> float:
    """Resident set size via resource.getrusage. Linux reports ru_maxrss in
    KiB (macOS in bytes) — and it is the PEAK, which for a long-lived server
    is the honest capacity-planning number anyway."""
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return float(rss if sys.platform == "darwin" else rss * 1024)


_VERSIONS: dict[str, str] = {}


def _dist_version(name: str) -> str:
    # memoized: importlib.metadata scans dist-info on every call, and
    # install_process_metrics runs once per serve() (tests spin many)
    if name not in _VERSIONS:
        try:
            from importlib.metadata import version

            _VERSIONS[name] = version(name)
        except Exception:
            _VERSIONS[name] = "unavailable"
    return _VERSIONS[name]


def install_process_metrics() -> None:
    metrics.gauge(
        "dllama_uptime_seconds",
        "Seconds since this serving process started",
    ).set_function(lambda: time.monotonic() - _START_T)
    metrics.gauge(
        "dllama_process_rss_bytes",
        "Peak resident set size (resource.getrusage ru_maxrss)",
    ).set_function(_rss_bytes)
    metrics.gauge(
        "dllama_threads",
        "Live Python threads (threading.active_count)",
    ).set_function(threading.active_count)
    metrics.gauge(
        "dllama_tracer_dropped_events",
        "Span events the bounded trace ring has dropped (0 when tracing "
        "is disabled) — a truncated --trace//v1/trace export is visible "
        "on /metrics before anyone opens the file",
    ).set_function(
        lambda: (trace.current().dropped_events
                 if trace.current() is not None else 0))
    info = metrics.gauge(
        "dllama_build_info",
        "Build/runtime identity (constant 1; the labels are the data)",
        labelnames=("python", "torch"))
    info.labels(
        python="%d.%d.%d" % sys.version_info[:3],
        torch=_dist_version("torch"),
    ).set(1)
    # set once at install, not a callback: the value is the identity of THIS
    # process (it matches the pid stamped into trace exports); a supervisor
    # restart replaces the whole series along with the process
    metrics.gauge(
        "dllama_process_pid",
        "OS pid of this serving process (matches a single-process --trace "
        "export's pid and the os_pid field of otherData.processes in a "
        "fleet-merged trace, whose events carry remapped index pids)",
    ).set(os.getpid())
