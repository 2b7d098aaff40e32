"""Observability for the port: span tracing, metrics, trace context, flight recorder.

Copies of the JAX package's obs/ modules, stdlib-only and safe to import from any layer
(the port keeps its own copies rather than importing the JAX package). Every metric
family, span name and flight event keeps the JAX package's name and meaning, so a
dashboard, the fleet router's merge and a test read both packages alike.

- `obs.trace` — thread-safe span tracer with Chrome trace-event JSON export
  (Perfetto-loadable); a process-wide no-op until `trace.install()` runs
  (`dllama --trace out.json`, `api_server --trace`). `install(annotate=True)` also
  enters `torch.profiler.record_function(name)` for each span, so a span encloses its
  kernels in a torch.profiler trace. `merge_chrome_traces` folds a fleet's per-process
  traces into one aligned file.
- `obs.metrics` — counters / gauges / histograms with Prometheus text exposition,
  served by `api_server` at `GET /metrics` (and as a JSON snapshot at `GET /v1/stats`).
- `obs.reqctx` — W3C trace-context (traceparent) propagation: one 128-bit trace id
  follows a request from a fleet router through the replica's HTTP handler into the
  BatchEngine scheduler's per-row work.
- `obs.flight` — per-request flight recorder: a bounded ring of the last N completed
  request timelines, served at `GET /v1/requests`, with a `--slow-log` JSONL stream.
- `obs.process` — process self-telemetry gauges (uptime, RSS, threads, tracer drops,
  build info) for /metrics.

Every metric is observed on the host paths (admission, dispatch, delivery, finish),
never inside a step a CUDA graph captures (there it would run at the capture only), and
no gauge callback or stats block reads the device: a scrape runs on an HTTP thread and
must not wait on the scheduler's stream.
"""

from . import flight, metrics, process, reqctx, trace

__all__ = ["flight", "metrics", "process", "reqctx", "trace"]
