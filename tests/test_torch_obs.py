"""The port's obs/ copies held against the JAX package's originals: every case of
tests/test_obs.py runs once on each package (parametrized, so each counts twice) — the
Prometheus exposition golden byte for byte, histogram buckets, label isolation,
concurrent writers, the Chrome schema and nesting, the bounded ring, the no-op disabled
tracer, instants, W3C traceparent round trips, adopt/use, trace-id stamping,
replace-mid-span, the fleet merge and the flight recorder's bounds — plus the cases that
only the port's copies have: the exposition of the two registries compared directly,
a JAX trace and a port trace merged into one document, the torch build-info label and
the torch.profiler annotation."""

import json
import threading
from types import SimpleNamespace

import pytest

from distributed_llama_tpu import obs as jax_obs
from distributed_llama_tpu_torch import obs as port_obs


def _ns(pkg):
    return SimpleNamespace(metrics=pkg.metrics, trace=pkg.trace, reqctx=pkg.reqctx,
                           flight=pkg.flight, process=pkg.process)


@pytest.fixture(params=["jax", "torch"])
def obs(request):
    """The JAX package's obs modules or the port's copies; each test leaves no tracer
    or recorder installed."""
    pkg = jax_obs if request.param == "jax" else port_obs
    yield _ns(pkg)
    pkg.trace.uninstall()
    pkg.flight.uninstall()


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def test_prometheus_exposition_golden(obs):
    """Exact text-format golden: HELP/TYPE lines, label rendering, histogram
    bucket/sum/count suffixes, +Inf, trailing newline. Pinned so any format
    drift is a conscious change (Prometheus parsers are strict)."""
    reg = obs.metrics.Registry()
    c = reg.counter("dlt_tokens_total", "Tokens served")
    c.inc(3)
    g = reg.gauge("dlt_slots", "Slot state", labelnames=("state",))
    g.labels(state="used").set(2)
    g.labels(state="free").set(6)
    h = reg.histogram("dlt_wait_seconds", "Queue wait", buckets=(0.01, 0.1, 1))
    h.observe(0.05)
    h.observe(0.05)
    h.observe(5.0)  # overflow -> +Inf only
    expected = (
        "# HELP dlt_slots Slot state\n"
        "# TYPE dlt_slots gauge\n"
        'dlt_slots{state="free"} 6\n'
        'dlt_slots{state="used"} 2\n'
        "# HELP dlt_tokens_total Tokens served\n"
        "# TYPE dlt_tokens_total counter\n"
        "dlt_tokens_total 3\n"
        "# HELP dlt_wait_seconds Queue wait\n"
        "# TYPE dlt_wait_seconds histogram\n"
        'dlt_wait_seconds_bucket{le="0.01"} 0\n'
        'dlt_wait_seconds_bucket{le="0.1"} 2\n'
        'dlt_wait_seconds_bucket{le="1"} 2\n'
        'dlt_wait_seconds_bucket{le="+Inf"} 3\n'
        "dlt_wait_seconds_sum 5.1\n"
        "dlt_wait_seconds_count 3\n"
    )
    assert reg.render() == expected


def test_histogram_bucket_boundaries(obs):
    """A value exactly on a bucket bound lands IN that bucket (Prometheus
    `le` semantics: cumulative count of observations <= bound)."""
    reg = obs.metrics.Registry()
    h = reg.histogram("b_seconds", "x", buckets=(1.0, 10.0))
    h.observe(1.0)   # == first bound -> le="1" bucket
    h.observe(1.0001)  # just past -> le="10" only
    h.observe(10.0)  # == second bound
    h.observe(11.0)  # overflow
    snap = h.snapshot()
    assert snap["buckets"] == {"1": 1, "10": 2}
    assert snap["overflow"] == 1
    assert snap["count"] == 4
    text = h.render()
    assert 'b_seconds_bucket{le="1"} 1' in text
    assert 'b_seconds_bucket{le="10"} 3' in text  # cumulative
    assert 'b_seconds_bucket{le="+Inf"} 4' in text


def test_log_buckets_shape(obs):
    """Fixed log-scale layout: exact decade anchors, monotone, covers hi."""
    b = obs.metrics.log_buckets(1e-3, 10.0, per_decade=4)
    assert b[0] == 1e-3 and b[-1] >= 10.0
    assert all(x < y for x, y in zip(b, b[1:]))
    for anchor in (1e-3, 1e-2, 1e-1, 1.0, 10.0):
        assert anchor in b
    # the default latency buckets span 100 µs .. 100 s
    assert obs.metrics.DEFAULT_TIME_BUCKETS[0] == 1e-4 and obs.metrics.DEFAULT_TIME_BUCKETS[-1] == 100


def test_labels_idempotent_and_isolated(obs):
    reg = obs.metrics.Registry()
    c = reg.counter("r_total", "x", labelnames=("route",))
    c.labels(route="/a").inc()
    c.labels(route="/a").inc()
    c.labels(route="/b").inc(5)
    assert c.labels(route="/a").value == 2
    assert c.labels(route="/b").value == 5
    # get-or-create returns the same family
    assert reg.counter("r_total", "x", labelnames=("route",)) is c


def test_concurrent_writers_metrics(obs):
    """8 threads hammering one counter + one histogram: no lost updates, no
    torn histogram state (count == sum of bucket counts incl. overflow)."""
    reg = obs.metrics.Registry()
    c = reg.counter("stress_total", "x")
    h = reg.histogram("stress_seconds", "x", buckets=(0.5,))
    N, T = 2000, 8

    def work(i):
        for j in range(N):
            c.inc()
            h.observe(0.25 if (i + j) % 2 else 0.75)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == N * T
    snap = h.snapshot()
    assert snap["count"] == N * T
    assert snap["buckets"]["0.5"] + snap["overflow"] == N * T
    assert abs(snap["sum"] - N * T * 0.5) < 1e-6


# ----------------------------------------------------------------------
# trace
# ----------------------------------------------------------------------

def test_chrome_trace_schema_and_nesting(obs):
    """Exported JSON is Chrome trace-event format: every span is a complete
    ("X") event with µs ts/dur, and a child span's interval nests strictly
    inside its parent's."""
    tr = obs.trace.Tracer(capacity=128)
    with tr.span("parent", {"req": 1}):
        with tr.span("child_a"):
            pass
        with tr.span("child_b"):
            pass
    doc = json.loads(json.dumps(tr.to_chrome_trace()))  # round-trips json
    evs = doc["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(spans) == {"parent", "child_a", "child_b"}
    for e in spans.values():
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["dur"] >= 0
    p, a, b = spans["parent"], spans["child_a"], spans["child_b"]
    assert p["args"] == {"req": 1}
    # nesting: children inside the parent, in order
    assert p["ts"] <= a["ts"] and a["ts"] + a["dur"] <= p["ts"] + p["dur"]
    assert p["ts"] <= b["ts"] and b["ts"] + b["dur"] <= p["ts"] + p["dur"]
    assert a["ts"] + a["dur"] <= b["ts"]
    # thread metadata present for the emitting thread
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)


def test_trace_ring_buffer_bounded(obs):
    tr = obs.trace.Tracer(capacity=10)
    for i in range(25):
        with tr.span(f"s{i}"):
            pass
    evs = [e for e in tr.events() if e["ph"] == "X"]
    assert len(evs) == 10
    assert evs[0]["name"] == "s15" and evs[-1]["name"] == "s24"  # oldest dropped
    assert tr.dropped_events == 15
    assert tr.to_chrome_trace()["otherData"]["dropped_events"] == 15


def test_disabled_tracer_is_noop(obs):
    """Module-level span() with no tracer installed returns the shared no-op
    and records nothing once one IS installed later."""
    obs.trace.uninstall()
    s1 = obs.trace.span("x")
    s2 = obs.trace.span("y", {"a": 1})
    assert s1 is s2  # the shared singleton: no per-call allocation
    with s1:
        pass
    tr = obs.trace.install(capacity=8)
    try:
        with obs.trace.span("real"):
            pass
        assert [e["name"] for e in tr.events() if e["ph"] == "X"] == ["real"]
    finally:
        obs.trace.uninstall()


def test_concurrent_writer_spans(obs):
    """Spans from many threads interleave without loss (buffer big enough)
    and each carries its own thread id."""
    tr = obs.trace.Tracer(capacity=10000)
    N, T = 200, 8

    def work(i):
        for j in range(N):
            with tr.span(f"t{i}"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = [e for e in tr.events() if e["ph"] == "X"]
    assert len(evs) == N * T
    by_thread = {}
    for e in evs:
        by_thread.setdefault(e["name"], set()).add(e["tid"])
    assert len(by_thread) == T
    for tids in by_thread.values():
        assert len(tids) == 1  # each logical thread kept one tid

    doc = tr.to_chrome_trace()
    json.loads(json.dumps(doc))  # schema survives a full round-trip
    # one thread_name metadata event per DISTINCT tid seen (the OS may reuse
    # idents of already-joined threads, so distinct tids can be < T)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(meta) == len({e["tid"] for e in evs})


def test_instant_events(obs):
    tr = obs.trace.Tracer(capacity=8)
    tr.instant("marker", {"k": "v"})
    evs = tr.events()
    inst = [e for e in evs if e["ph"] == "i"]
    assert len(inst) == 1 and inst[0]["name"] == "marker"
    assert inst[0]["args"] == {"k": "v"}


# ----------------------------------------------------------------------
# reqctx: W3C trace-context
# ----------------------------------------------------------------------

def test_traceparent_roundtrip(obs):
    ctx = obs.reqctx.new_context("req-1")
    hdr = ctx.to_traceparent()
    assert len(hdr) == 55 and hdr.startswith("00-")
    parsed = obs.reqctx.parse_traceparent(hdr)
    assert parsed.trace_id == ctx.trace_id
    assert parsed.span_id == ctx.span_id
    assert parsed.flags == ctx.flags
    assert parsed.request_id == ""  # request id is serving-local, not wire


def test_traceparent_rejects_malformed(obs):
    bad = [None, "", "garbage", "00-abc-def-01",
           "00-" + "0" * 32 + "-" + "1" * 16 + "-01",   # all-zero trace id
           "00-" + "1" * 32 + "-" + "0" * 16 + "-01",   # all-zero span id
           "ff-" + "1" * 32 + "-" + "2" * 16 + "-01",   # reserved version
           "00-" + "1" * 32 + "-" + "2" * 16 + "-01-x",  # v00: exactly 4 fields
           "00-" + "g" * 32 + "-" + "2" * 16 + "-01"]   # non-hex
    for h in bad:
        assert obs.reqctx.parse_traceparent(h) is None, h


def test_traceparent_future_version_forward_compat(obs):
    """W3C forward compat: a version > 00 header parses by its first four
    fields, trailing fields ignored — upstream traces join, never fork."""
    tid, sid = "a1" * 16, "b2" * 8
    got = obs.reqctx.parse_traceparent(f"01-{tid}-{sid}-01-future-fields")
    assert got is not None and got.trace_id == tid and got.span_id == sid
    assert obs.reqctx.parse_traceparent(f"42-{tid}-{sid}-00").trace_id == tid


def test_child_and_adopt_keep_trace_id(obs):
    ctx = obs.reqctx.new_context()
    child = ctx.child(request_id="req-9")
    assert child.trace_id == ctx.trace_id
    assert child.span_id != ctx.span_id
    assert child.request_id == "req-9"
    adopted = obs.reqctx.adopt(ctx.to_traceparent(), request_id="req-a")
    assert adopted.trace_id == ctx.trace_id
    assert adopted.span_id != ctx.span_id  # a fresh hop, not the parent's
    fresh = obs.reqctx.adopt("not a header")
    assert fresh.trace_id != ctx.trace_id  # malformed -> originate


def test_use_binds_and_restores(obs):
    assert obs.reqctx.current() is None
    c1, c2 = obs.reqctx.new_context("a"), obs.reqctx.new_context("b")
    with obs.reqctx.use(c1):
        assert obs.reqctx.current() is c1
        with obs.reqctx.use(c2):
            assert obs.reqctx.current() is c2
        with obs.reqctx.use(None):  # explicit clear between per-request regions
            assert obs.reqctx.current() is None
        assert obs.reqctx.current() is c1
    assert obs.reqctx.current() is None


def test_spans_stamp_active_trace_id(obs):
    """Any span/instant recorded while a context is bound carries its trace
    id — the mechanism that attributes scheduler-thread events per request."""
    tr = obs.trace.Tracer(capacity=32)
    ctx = obs.reqctx.new_context("req-x")
    with obs.reqctx.use(ctx):
        with tr.span("batch.prefill", {"chunk": 8}):
            pass
        tr.instant("batch.row_delivered", {"slot": 0})
    with tr.span("engine.idle"):  # outside any context: no stamp
        pass
    evs = {e["name"]: e for e in tr.events() if e["ph"] in ("X", "i")}
    assert evs["batch.prefill"]["args"]["trace_id"] == ctx.trace_id
    assert evs["batch.prefill"]["args"]["chunk"] == 8  # caller args intact
    assert evs["batch.row_delivered"]["args"]["trace_id"] == ctx.trace_id
    assert "trace_id" not in evs["engine.idle"].get("args", {})


# ----------------------------------------------------------------------
# trace: install() replace-mid-span + process identity + fleet merge
# ----------------------------------------------------------------------

def test_install_replace_mid_span_records_to_new_tracer(obs):
    """install() must not strand in-flight module-level spans in the orphaned
    predecessor's buffer: they record through the tracer installed at exit."""
    try:
        t1 = obs.trace.install(capacity=16)
        span = obs.trace.span("long_lived")
        span.__enter__()
        t2 = obs.trace.install(capacity=16)  # replaced mid-span
        span.__exit__(None, None, None)
        assert [e["name"] for e in t1.events() if e["ph"] == "X"] == []
        recorded = [e for e in t2.events() if e["ph"] == "X"]
        assert [e["name"] for e in recorded] == ["long_lived"]
        # the span entered BEFORE t2's epoch: its ts is negative relative to
        # t2 (same monotonic clock), so wall_start_unix + ts still names the
        # true absolute start — the merge-alignment invariant
        ev = recorded[0]
        assert ev["ts"] <= 0 and ev["ts"] + ev["dur"] >= 0
        # uninstalled mid-span: the event is dropped, never crashes
        span2 = obs.trace.span("dropped")
        span2.__enter__()
        obs.trace.uninstall()
        span2.__exit__(None, None, None)
    finally:
        obs.trace.uninstall()


def test_tracer_pid_and_process_name(obs):
    import os

    tr = obs.trace.Tracer(capacity=16, process_name="api_server 1.2.3.4:9990")
    with tr.span("s"):
        pass
    doc = tr.to_chrome_trace()
    assert doc["otherData"]["pid"] == os.getpid()
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all(e["pid"] == os.getpid() for e in spans)  # no hardcoded pid 1
    pname = [e for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert pname and pname[0]["args"]["name"] == "api_server 1.2.3.4:9990"


def test_merge_chrome_traces_aligns_and_separates_pids(obs):
    """Two processes with the same OS pid and skewed wall clocks merge into
    one doc with distinct pids and wall-aligned timestamps."""
    a = {"traceEvents": [
            {"name": "router.proxy", "ph": "X", "ts": 100.0, "dur": 5.0,
             "pid": 42, "tid": 1, "args": {"trace_id": "t1"}}],
         "otherData": {"wall_start_unix": 1000.0, "dropped_events": 2}}
    b = {"traceEvents": [
            {"name": "process_name", "ph": "M", "pid": 42,
             "args": {"name": "stale"}},
            {"name": "batch.super_step", "ph": "X", "ts": 50.0, "dur": 3.0,
             "pid": 42, "tid": 7, "args": {"trace_id": "t1"}}],
         "otherData": {"wall_start_unix": 1001.0, "dropped_events": 1}}
    doc = obs.trace.merge_chrome_traces([("router", a), ("replica h:1", b)])
    json.loads(json.dumps(doc))  # stays valid JSON
    evs = doc["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    # distinct pids per source despite the OS-pid collision
    assert spans["router.proxy"]["pid"] != spans["batch.super_step"]["pid"]
    # wall alignment: b started 1 s after a, so its ts shifts by 1e6 µs
    assert spans["router.proxy"]["ts"] == 100.0
    assert spans["batch.super_step"]["ts"] == 50.0 + 1e6
    # one process_name per source, the merge's own label (not the stale one)
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"router", "replica h:1"}
    assert doc["otherData"]["dropped_events"] == 3
    assert len(doc["otherData"]["processes"]) == 2


# ----------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------

def test_flight_ring_eviction_bound(obs):
    rec = obs.flight.FlightRecorder(capacity=10, live_capacity=8)
    for i in range(30):
        rec.start(f"r{i}", trace_id=f"t{i}")
        rec.event(f"r{i}", "admitted", slot=0)
        rec.finish(f"r{i}", "length")
    listing = rec.requests()
    assert len(listing["completed"]) == 10
    assert listing["evicted"] == 20
    assert listing["completed"][0]["id"] == "r29"  # newest first
    assert rec.get("r0") is None  # rotated out
    got = rec.get("r29")
    assert got["finish"] == "length"
    assert [e["event"] for e in got["events"]] == ["admitted"]
    # live-table bound: unfinished records cannot grow without limit
    for i in range(40):
        rec.event(f"live{i}", "x")
    assert len(rec.requests()["live"]) <= 8
    assert rec.evicted_live >= 32


def test_flight_lookup_by_trace_id_and_slowest(obs):
    rec = obs.flight.FlightRecorder(capacity=8)
    rec.start("req-a", trace_id="a" * 32)
    rec.finish("req-a", "stop", e2e_ms=50.0)
    rec.start("req-b", trace_id="b" * 32)
    rec.finish("req-b", "stop", e2e_ms=500.0)
    assert rec.get("a" * 32)["id"] == "req-a"  # trace-id fallback
    slow = rec.requests(slowest=1)["completed"]
    assert len(slow) == 1 and slow[0]["id"] == "req-b"


def test_flight_events_capped_per_record(obs):
    rec = obs.flight.FlightRecorder(capacity=4, max_events=5)
    for i in range(20):
        rec.event("r", "super_step", k=8)
    got = rec.get("r")
    assert len(got["events"]) == 5
    assert got["events_dropped"] == 15  # truncation is honest


def test_flight_concurrent_writers_stress(obs):
    """8 threads × 50 requests each, events + finish interleaved with reads:
    no lost records beyond the ring bound, no exceptions, consistent
    summaries."""
    rec = obs.flight.FlightRecorder(capacity=64, live_capacity=512)
    T, N = 8, 50
    errors = []

    def work(t):
        try:
            for i in range(N):
                rid = f"w{t}-{i}"
                rec.start(rid, trace_id=f"tid{t}-{i}")
                for j in range(4):
                    rec.event(rid, "super_step", k=8, delivered=j)
                rec.requests(slowest=3)  # concurrent reader
                rec.finish(rid, "length", e2e_ms=float(i))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    listing = rec.requests()
    assert len(listing["completed"]) == 64  # exactly the ring bound
    assert listing["evicted"] == T * N - 64
    for summary in listing["completed"]:
        full = rec.get(summary["id"])
        assert full["finish"] == "length" and len(full["events"]) == 4


def test_flight_slow_log_exemplars(obs, tmp_path):
    """Only completions over threshold land in the JSONL, once each, and
    only when the finish carries request-level numbers (e2e_ms/error)."""
    out = tmp_path / "slow.jsonl"
    rec = obs.flight.FlightRecorder(capacity=8, slow_log=str(out), slow_threshold=0.1)
    rec.start("fast")
    rec.finish("fast", "stop", e2e_ms=5.0)
    rec.start("slow")
    rec.event("slow", "admitted")
    rec.finish("slow", "length")            # engine-side: no api numbers yet
    rec.finish("slow", None, e2e_ms=450.0, ttft_ms=120.0)  # api completes
    rec.finish("slow", None, e2e_ms=450.0)  # double-finish: no second line
    rec.start("broken")
    rec.finish("broken", "error", error="boom", e2e_ms=200.0)
    # an errored request is an exemplar even BELOW the latency threshold —
    # a 200 ms fault-killed request is the primary debugging target
    rec.start("fast-broken")
    rec.finish("fast-broken", "error", error="crash", e2e_ms=5.0)
    rec.close()
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [ln["id"] for ln in lines] == ["slow", "broken", "fast-broken"]
    assert lines[0]["ttft_ms"] == 120.0
    assert [e["event"] for e in lines[0]["events"]] == ["admitted"]
    assert lines[2]["error"] == "crash" and lines[2]["e2e_ms"] == 5.0


def test_flight_drop_discards_shed_requests(obs, tmp_path):
    """Admission sheds (503 bursts) are dropped, not finished: they must
    not occupy the completed ring nor append slow-log exemplars."""
    out = tmp_path / "slow.jsonl"
    rec = obs.flight.FlightRecorder(capacity=4, slow_log=str(out), slow_threshold=0.1)
    rec.start("real")
    rec.finish("real", "stop", e2e_ms=500.0)
    for i in range(100):  # saturation burst
        rec.start(f"shed-{i}")
        rec.drop(f"shed-{i}")
    listing = rec.requests()
    assert [s["id"] for s in listing["completed"]] == ["real"]
    assert listing["live"] == [] and rec.get("shed-0") is None
    rec.close()
    lines = out.read_text().splitlines() if out.exists() else []
    assert len(lines) == 1  # only the real completion


def test_flight_module_level_noop_and_ctx_resolution(obs):
    """Module hooks are no-ops with no recorder installed; with one, a None
    rid resolves through the bound trace context (the engine call sites)."""
    obs.flight.uninstall()
    obs.flight.event("x", "e")   # no recorder: must not raise
    obs.flight.finish("x")
    rec = obs.flight.install(capacity=8)
    try:
        ctx = obs.reqctx.new_context("req-ctx")
        with obs.reqctx.use(ctx):
            obs.flight.event(None, "prefill", tokens=4)
            obs.flight.finish(None, "stop")
        got = rec.get("req-ctx")
        assert got["finish"] == "stop"
        assert got["events"][0]["event"] == "prefill"
        obs.flight.event(None, "orphan")  # no ctx: dropped, not crashed
        assert rec.get("") is None
    finally:
        obs.flight.uninstall()


def test_flight_eviction_counters_consistent_with_listing(obs):
    """requests() snapshots `evicted_done`/`evicted_live` in the same critical
    section as the tables: concurrent finishers against readers, and the final
    listing accounts for every completion exactly."""
    rec = obs.flight.FlightRecorder(capacity=4, live_capacity=64)
    n_threads, n_each = 6, 50
    barrier = threading.Barrier(n_threads + 1)
    stop = threading.Event()

    def finisher(k: int):
        barrier.wait()
        for i in range(n_each):
            rid = f"r{k}-{i}"
            rec.start(rid)
            rec.event(rid, "step")
            rec.finish(rid, "stop")

    violations: list[str] = []

    def reader():
        # violations collected into a list the MAIN thread asserts on —
        # an assert raised inside a daemon thread would be swallowed by
        # threading's excepthook and the test would pass vacuously
        barrier.wait()
        while not stop.is_set():
            r = rec.requests()
            # within one locked snapshot the ring bound always holds
            if len(r["completed"]) > rec.capacity:
                violations.append(f"ring over capacity: {len(r['completed'])}")
            if r["evicted"] < 0 or r["evicted_live"] < 0:
                violations.append(f"negative counter: {r['evicted']}, "
                                  f"{r['evicted_live']}")

    threads = [threading.Thread(target=finisher, args=(k,))
               for k in range(n_threads)]
    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    rt.join(timeout=5)
    assert not violations, violations[:3]
    final = rec.requests()
    total = n_threads * n_each
    assert len(final["completed"]) == rec.capacity
    # exact accounting: every finish either sits in the ring or was counted
    # out of it — the invariant the same-critical-section snapshot pins
    assert final["evicted"] == total - rec.capacity
    assert final["evicted_live"] == 0


# ----------------------------------------------------------------------
# the copies against each other, and what only the port's copies do
# ----------------------------------------------------------------------

def _register(reg):
    reg.counter("dlt_tokens_total", "Tokens served").inc(3)
    g = reg.gauge("dlt_slots", "Slot state", labelnames=("state",))
    g.labels(state="used").set(2)
    g.labels(state="free").set(6)
    h = reg.histogram("dlt_wait_seconds", "Queue wait",
                      buckets=jax_obs.metrics.log_buckets(1e-3, 10.0))
    for v in (0.0004, 0.05, 0.05, 1.0, 42.0):
        h.observe(v)
    s = reg.histogram("dlt_rows", "Rows", buckets=jax_obs.metrics.DEFAULT_SIZE_BUCKETS)
    s.observe(8)


def test_exposition_and_snapshot_identical_across_packages():
    """The same registrations render byte-identical Prometheus text and equal JSON
    snapshots in both registries (a fleet scrape cannot tell the packages apart)."""
    a, b = jax_obs.metrics.Registry(), port_obs.metrics.Registry()
    _register(a)
    _register(b)
    assert a.render() == b.render()
    assert a.snapshot() == b.snapshot()
    assert port_obs.metrics.DEFAULT_TIME_BUCKETS == jax_obs.metrics.DEFAULT_TIME_BUCKETS
    assert port_obs.metrics.DEFAULT_SIZE_BUCKETS == jax_obs.metrics.DEFAULT_SIZE_BUCKETS


def test_merge_jax_and_port_traces():
    """A JAX-package trace and a port trace of the same request merge into one
    document — by either package's merge_chrome_traces — with distinct pids, the
    shared trace id on both sides, and the same result from both merges."""
    tid = "cd" * 16
    jt, pt = jax_obs.trace.Tracer(capacity=16), port_obs.trace.Tracer(capacity=16)
    jctx = jax_obs.reqctx.parse_traceparent(f"00-{tid}-{'11' * 8}-01")
    pctx = port_obs.reqctx.adopt(jctx.to_traceparent(), request_id="chatcmpl-x")
    with jax_obs.reqctx.use(jctx), jt.span("router.proxy"):
        pass
    with port_obs.reqctx.use(pctx), pt.span("batch.prefill", {"chunk": 8}):
        pass
    sources = [("router", jt.to_chrome_trace()), ("replica", pt.to_chrome_trace())]
    doc = port_obs.trace.merge_chrome_traces(sources)
    assert doc == jax_obs.trace.merge_chrome_traces(sources)
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["router.proxy"]["pid"] != spans["batch.prefill"]["pid"]
    assert {e["args"]["trace_id"] for e in spans.values()} == {tid}
    assert [p["name"] for p in doc["otherData"]["processes"]] == ["router", "replica"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fault_lands_on_flight_timeline(pkg):
    """faults.fire inside a request's bound context puts a fault_injected event on that
    request's flight record and counts faults_injected_total{point,kind}."""
    if pkg == "jax":
        from distributed_llama_tpu.resilience import faults
        o = jax_obs
    else:
        from distributed_llama_tpu_torch.resilience import faults
        o = port_obs
    fam = o.metrics.REGISTRY.counter("faults_injected_total", "x",
                                     labelnames=("point", "kind"))
    before = fam.labels(point="batch.emit", kind="latency").value
    rec = o.flight.install(8)
    try:
        with faults.active(faults.FaultSpec("batch.emit", kind="latency", delay_ms=0.0)):
            with o.reqctx.use(o.reqctx.new_context("req-fault")):
                faults.fire("batch.emit", slot=0)
            faults.fire("batch.emit", slot=0)  # no context: counted, not recorded
        ev = rec.get("req-fault")["events"]
        assert [(e["event"], e["point"], e["kind"]) for e in ev] == [
            ("fault_injected", "batch.emit", "latency")]
        assert fam.labels(point="batch.emit", kind="latency").value == before + 2
    finally:
        o.flight.uninstall()


def test_build_info_names_torch():
    """The port's process telemetry labels the framework that runs: python and torch
    (the JAX package's: python and jax)."""
    port_obs.process.install_process_metrics()
    text = port_obs.metrics.render()
    line = [ln for ln in text.splitlines() if ln.startswith("dllama_build_info{")]
    assert len(line) == 1 and 'python="3.' in line[0] and 'torch="' in line[0]
    assert "jax=" not in line[0] and line[0].endswith(" 1")
    for name in ("dllama_uptime_seconds", "dllama_process_rss_bytes", "dllama_threads",
                 "dllama_tracer_dropped_events", "dllama_process_pid"):
        assert f"# TYPE {name} gauge" in text


def test_annotated_span_is_a_profiler_range(monkeypatch):
    """install(annotate=True): each span enters torch.profiler.record_function, so a
    torch.profiler trace shows the span's range around the work inside it; a failing
    annotation leaves the span recording."""
    import torch

    tr = port_obs.trace.install(capacity=16, annotate=True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with port_obs.trace.span("obs.annotated"):
                torch.ones(64).sum()
        names = {e.key for e in prof.key_averages()}
        assert "obs.annotated" in names, sorted(names)[:20]

        def broken(name):
            raise RuntimeError("no profiler here")
        monkeypatch.setattr(torch.profiler, "record_function", broken)
        with port_obs.trace.span("obs.unannotated"):
            pass
        got = [e["name"] for e in tr.events() if e["ph"] == "X"]
        assert got == ["obs.annotated", "obs.unannotated"]
    finally:
        port_obs.trace.uninstall()
