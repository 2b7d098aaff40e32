"""PyTorch port: observability on the port's engines and server against the JAX package.

- the port's batched server (--batch 2) under the cases of tests/test_obs_server.py:
  /metrics under concurrent requests (the strict exposition parser), /v1/stats blocks,
  OpenAI error bodies, /v1/requests and /v1/requests/<id> (by completion id and trace
  id), traceparent adoption and /v1/trace, process telemetry with torch in the build
  info, and super-step spans that never overlap (pipelined and not);
- the same family names as the JAX server over the same requests (constrained decoding
  and the drafter's proposer mux included), less the families of the modules the port
  does not have yet (the host KV spill, the collective-bytes counter) and the router's;
- the engines against the JAX package's: `dllama --trace` writes JAX's span names for
  the same run, and on the same weights and requests the BatchEngines' prefill- and
  decode-token counter deltas and flight event names are equal, as are the
  single-sequence engines' token counters;
- attribution: tenant and class in flight records (tests/test_tenancy.py), and the
  disagg and tenants blocks of /v1/stats on a prefill/decode pair
  (tests/test_disagg.py);
- the fleet: the JAX package's stdlib router in front of two port servers propagates
  the trace context under concurrency, merges their metrics with replica labels and
  merges both replicas' traces (tests/test_fleet.py);
- `BatchEngine.dispatch_ms` stays bounded however many dispatches run.

Each registry is process-wide, so the cases read deltas.
"""

import collections
import http.client
import importlib
import json
import re
import threading
import time

import pytest

from distributed_llama_tpu.apps import dllama as jdllama
from distributed_llama_tpu.apps.api_server import serve as jserve
from distributed_llama_tpu.fleet.router import close_router, serve_router
from distributed_llama_tpu.formats.mfile import (load_model, params_file_order,
                                                 write_model)
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.obs import flight as jflight
from distributed_llama_tpu.obs import metrics as jmetrics
from distributed_llama_tpu.obs import trace as jtrace
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu.tokenizer import TemplateType as JTemplateType
from distributed_llama_tpu.tokenizer.bpe import Tokenizer as JTokenizer
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.obs import flight, metrics, trace
from distributed_llama_tpu_torch.resilience.tenancy import TenantRegistry
from distributed_llama_tpu_torch.runtime import batch_engine as batch_engine_mod
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler
from distributed_llama_tpu_torch.tokenizer import TemplateType

V = 262
TENANTS = "gold:weight=4;free:weight=1"
# families the JAX server may show that the port does not have yet: the host KV spill
# (paged_* other than paged_kv_*) and the collective-bytes counter (ROADMAP Queue A item 8)
NOT_PORTED = re.compile(r"^(paged_(?!kv_)|collective_)")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_obs")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=V, seq_len=192).resolved()
    params = init_random_params(spec, FloatType.F32, seed=21)
    mpath = str(tmp / "m.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.F32)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [
        b"<|im_start|>", b"<|im_end|>", b" "]
    tpath = str(tmp / "t.t")
    write_tokenizer(tpath, TokenizerData(
        vocab=vocab, scores=[0.0] * 259 + [-1.0, -1.0, -1.5], bos_id=1, eos_id=2,
        chat_eos_id=260, max_token_length=12, chat_template="{{<|im_start|>}}"))
    return mpath, tpath


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv.server_address[1]


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def obs_server(files):
    """The port's batched server (--batch 2): scheduler metrics must show up on /metrics
    under concurrent requests."""
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be)
    yield _start(srv)
    _stop(srv)
    be.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    return conn.getresponse()


def _post(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    return conn.getresponse()


def _chat(content, n=8, **kw):
    return {"messages": [{"role": "user", "content": content}], "max_tokens": n,
            "temperature": 0, **kw}


_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*\})? '
    r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$")


def _parse_prometheus(text: str) -> dict:
    """tests/test_obs_server.py's strict parse: every non-comment line is a valid sample
    of a declared family; returns {sample name with labels: value}."""
    assert text.endswith("\n"), "exposition must end with a newline"
    samples = {}
    typed = set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if line.startswith("#"):
            continue
        assert _SAMPLE_RE.match(line), f"bad exposition line: {line!r}"
        name_lbl, val = line.rsplit(" ", 1)
        samples[name_lbl] = float(val.replace("+Inf", "inf"))
        base = name_lbl.split("{")[0]
        root = re.sub(r"_(bucket|sum|count)$", "", base)
        assert base in typed or root in typed, f"sample {base} missing # TYPE"
    return samples


def _families(text: str) -> dict:
    return dict(ln.split()[2:4] for ln in text.splitlines() if ln.startswith("# TYPE "))


# ----------------------------------------------------------------------
# the port's server: tests/test_obs_server.py's cases
# ----------------------------------------------------------------------

def test_metrics_under_concurrent_requests(obs_server):
    before = _parse_prometheus(_get(obs_server, "/metrics").read().decode())
    results = []

    def client(i):
        r = _post(obs_server, _chat(f"hi {i}", 12, seed=5))
        results.append(r.status)
        r.read()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert results == [200, 200, 200]
    r = _get(obs_server, "/metrics")
    assert r.status == 200
    assert r.getheader("Content-Type").startswith("text/plain")
    samples = _parse_prometheus(r.read().decode())

    def delta(key):
        return samples.get(key, 0.0) - before.get(key, 0.0)

    assert delta("api_request_ttft_seconds_count") == 3
    assert delta("api_request_e2e_seconds_count") == 3
    assert delta("api_request_tpot_seconds_count") == 3
    assert samples["api_request_e2e_seconds_sum"] > 0
    assert (samples['api_request_ttft_seconds_bucket{le="+Inf"}']
            == samples["api_request_ttft_seconds_count"])
    assert samples["batch_slots_total"] == 2
    assert "batch_slots_occupied" in samples and "batch_queue_depth" in samples
    assert delta("batch_queue_wait_seconds_count") == 3
    assert delta("batch_prefill_tokens_total") > 0
    assert delta("batch_decode_tokens_total") == 36
    assert delta('batch_requests_total{finish="length"}') == 3
    assert any(k.startswith('batch_dispatch_seconds_bucket{kind="super_step"')
               for k in samples)
    assert delta('api_http_requests_total{route="/v1/chat/completions",code="200"}') == 3
    assert samples['api_http_requests_total{route="/metrics",code="200"}'] >= 1


def test_v1_stats_snapshot(obs_server):
    r = _post(obs_server, _chat("stats", 4))
    assert r.status == 200
    r.read()
    r = _get(obs_server, "/v1/stats")
    assert r.status == 200
    data = json.loads(r.read())
    assert data["model"] == "distributed-llama-tpu"
    assert data["replica"]["slots"] == 2 and data["replica"]["batched"]
    be = data["batch_engine"]
    assert be["slots"] == 2 and be["superstep"] == 4 and be["prefilled_tokens"] > 0
    assert be["paged_kv"]["pool_blocks"] > 0 and "seed_bytes" in be["paged_kv"]
    assert "hits" in data["prefix_cache"]
    assert data["kernels"]["policy"] == "False"  # the CPU runs no kernel
    assert data["metrics"]["api_request_ttft_seconds"]["count"] >= 1
    assert "buckets" in data["metrics"]["api_request_ttft_seconds"]
    assert "speculative" not in data and "engine" not in data


def test_v1_stats_blocks_of_every_mode(files):
    """The blocks the configuration turns on: supervisor, tenants, disagg (the export
    side of any batched server), speculative; and the single-sequence engine's."""
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4, speculative=2,
                          tenants=TenantRegistry.parse(TENANTS))
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be,
                           speculative_k=2, supervisor_threshold=600.0)
    one = api_server.serve(Engine.load(*files, device="cpu"), "127.0.0.1", 0,
                           TemplateType.CHATML)
    try:
        port, port1 = _start(srv), _start(one)
        for p in (port, port1):
            r = _post(p, _chat("blocks blocks blocks blocks", 6), {"X-Tenant": "gold"})
            assert r.status == 200
            r.read()
        data = json.loads(_get(port, "/v1/stats").read())
        assert data["supervisor"]["state"] == "ok"
        assert {"gold", "free"} <= set(data["tenants"])
        assert data["tenants"]["gold"]["admitted"] >= 1
        assert data["disagg"] == {"role": "both", "kv_wire": "raw",
                                  "transfers": data["disagg"]["transfers"]}
        assert data["speculative"]["k"] == 2
        single = json.loads(_get(port1, "/v1/stats").read())
        assert single["engine"]["seq_len"] == 192 and single["engine"]["pos"] > 0
        assert single["replica"]["slots"] == 1 and "batch_engine" not in single
        assert "prefix_cache" in single and single["kernels"]["fused_matmul"] is False
    finally:
        srv.api_state.supervisor.stop()
        _stop(srv)
        _stop(one)
        be.close()


def test_openai_error_bodies(obs_server):
    for r in (_get(obs_server, "/v1/embeddings"), _post(obs_server, {"input": "x"})):
        assert r.status in (400, 404)
        err = json.loads(r.read())["error"]
        assert err["type"] == "invalid_request_error" and err["message"]
    conn = http.client.HTTPConnection("127.0.0.1", obs_server, timeout=30)
    conn.request("POST", "/v1/chat/completions", "{not json",
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 400
    assert json.loads(r.read())["error"]["type"] == "invalid_request_error"
    samples = _parse_prometheus(_get(obs_server, "/metrics").read().decode())
    assert samples['api_http_requests_total{route="other",code="404"}'] >= 1


def test_flight_recorder_endpoints(obs_server):
    r = _post(obs_server, _chat("flight check", 8))
    assert r.status == 200
    rid = r.getheader("X-Request-Id")
    body = json.loads(r.read())
    assert rid and body["id"] == rid  # the completion id is the flight key
    assert r.getheader("X-Replica").startswith("127.0.0.1:")
    r = _get(obs_server, f"/v1/requests/{rid}")
    assert r.status == 200
    rec = json.loads(r.read())
    assert rec["id"] == rid and len(rec["trace_id"]) == 32
    assert rec["finish"] in ("length", "stop")
    assert rec["e2e_ms"] > 0 and rec["ttft_ms"] is not None
    assert rec["tokens"] == rec["generated_tokens"] == 8
    assert rec["tenant"] == "default" and rec["class"] == "interactive"
    names = [e["event"] for e in rec["events"]]
    assert names[0] == "admitted" and "prefill_chunk" in names
    assert "super_step" in names, names
    admitted = rec["events"][0]
    assert admitted["queue_wait_ms"] >= 0 and admitted["slot"] in (0, 1)
    ts = [e["t_ms"] for e in rec["events"]]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)
    # by trace id, as the merged fleet trace shows it
    r = _get(obs_server, f"/v1/requests/{rec['trace_id']}")
    assert r.status == 200 and json.loads(r.read())["id"] == rid
    listing = json.loads(_get(obs_server, "/v1/requests").read())
    assert any(s["id"] == rid for s in listing["completed"])
    r = _get(obs_server, "/v1/requests?slowest=1")
    assert r.status == 200 and len(json.loads(r.read())["completed"]) == 1
    assert _get(obs_server, "/v1/requests?slowest=x").status == 400
    r = _get(obs_server, "/v1/requests/chatcmpl-nonexistent")
    assert r.status == 404
    assert json.loads(r.read())["error"]["type"] == "invalid_request_error"


def test_traceparent_adoption_and_trace_endpoint(obs_server):
    assert _get(obs_server, "/v1/trace").status == 404
    tr = trace.install(capacity=8192)
    try:
        tid = "ab" * 16
        r = _post(obs_server, _chat("traced request", 6),
                  {"traceparent": f"00-{tid}-{'12' * 8}-01"})
        assert r.status == 200
        rid = r.getheader("X-Request-Id")
        r.read()
        rec = json.loads(_get(obs_server, f"/v1/requests/{rid}").read())
        assert rec["trace_id"] == tid  # adopted, not originated
        r = _get(obs_server, "/v1/trace")
        assert r.status == 200
        doc = json.loads(r.read())
        assert doc["otherData"]["pid"] == tr.pid
        stamped = {e["name"] for e in doc["traceEvents"]
                   if (e.get("args") or {}).get("trace_id") == tid}
        # scheduler-thread work carries the request's trace id (cross-thread re-entry)
        assert {"batch.prefill", "batch.row_delivered"} <= stamped, stamped
    finally:
        trace.uninstall()


def test_process_self_telemetry(obs_server):
    samples = _parse_prometheus(_get(obs_server, "/metrics").read().decode())
    assert samples["dllama_uptime_seconds"] > 0
    assert samples["dllama_process_rss_bytes"] > 10 * 1024 * 1024
    assert samples["dllama_threads"] >= 2
    assert "dllama_tracer_dropped_events" in samples
    assert samples["dllama_process_pid"] > 0
    build = [k for k in samples if k.startswith("dllama_build_info{")]
    assert len(build) == 1 and samples[build[0]] == 1
    assert 'python="3.' in build[0] and "torch=" in build[0]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
def test_batch_trace_superstep_spans(files, pipeline):
    """Super-step spans never overlap on the scheduler thread, pipelined or not: a
    pipelined issue returns at once, and batch.super_step covers the wait for the block
    and its delivery."""
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4, pipeline=pipeline)
    tr = trace.install(capacity=4096)
    try:
        out, _ = be.generate([1, 5, 9, 13], 12, Sampler(V, 0.0, 0.9, 0))
        assert len(out) == 12
        evs = [e for e in tr.events() if e["ph"] == "X"]
        supers = sorted((e for e in evs if e["name"] == "batch.super_step"),
                        key=lambda e: e["ts"])
        issues = [e for e in evs if e["name"] == "batch.super_step_issue"]
        prefills = [e for e in evs if e["name"] in ("batch.prefill", "batch.mixed_step")]
        assert supers and prefills and len(issues) >= len(supers)
        assert supers[0]["args"]["k"] == 4
        assert any(e["args"]["chained"] for e in supers) == pipeline
        for a, b in zip(supers, supers[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 1e-3
        assert min(e["ts"] for e in prefills) <= supers[0]["ts"]
    finally:
        trace.uninstall()
        be.close()


def test_dispatch_ms_stays_bounded(files, monkeypatch):
    """More dispatches than DISPATCH_MS_KEEP keep only the newest times of each kind."""
    monkeypatch.setattr(batch_engine_mod, "DISPATCH_MS_KEEP", 5)
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=1)
    try:
        be.generate([1, 5, 9], 24, Sampler(V, 0.0, 0.9, 0))
        assert be.decode_steps > 5
        assert all(isinstance(d, collections.deque) and d.maxlen == 5
                   for d in be.dispatch_ms.values())
        assert len(be.dispatch_ms["decode"]) == 5
    finally:
        be.close()


# ----------------------------------------------------------------------
# the port's engines and server against the JAX package's
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(files):
    """A port and a JAX BatchEngine on the same weights (2 slots, super-steps of 4)."""
    lspec, lparams = load_model(files[0], 0)
    jbe = JBatchEngine(lspec, lparams, JTokenizer.load(files[1]), slots=2, tp=1,
                       superstep=4)
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
    yield be, jbe
    be.close()
    jbe.close()


def _counter(reg, name, **labels):
    fam = reg.REGISTRY.counter(name, "", labelnames=tuple(labels))
    return (fam.labels(**labels) if labels else fam).value


def test_engine_counters_and_flight_events_match_jax(pair):
    be, jbe = pair
    rec = flight.current() or flight.install()
    jrec = jflight.current() or jflight.install()
    prompts = [[1] + [(5 * i + j) % 250 + 3 for j in range(n)]
               for i, n in enumerate((20, 7, 33))]
    counts = {}
    for name, eng, reg, smp in (("port", be, metrics, Sampler),
                                ("jax", jbe, jmetrics, JSampler)):
        c0 = {k: _counter(reg, k) for k in ("batch_prefill_tokens_total",
                                            "batch_decode_tokens_total")}
        reqs = [eng.submit(p, 10, smp(V, 0.0, 0.9, 0), rid=f"{name}-{i}")
                for i, p in enumerate(prompts)]
        outs = [r.wait(timeout=300) for r in reqs]
        counts[name] = ({k: _counter(reg, k) - v for k, v in c0.items()}, outs)
    assert counts["port"] == counts["jax"]
    assert counts["port"][0]["batch_decode_tokens_total"] == 30
    # every prompt but the token a slot's rewind reused
    assert 0 < counts["port"][0]["batch_prefill_tokens_total"] <= sum(map(len, prompts))
    for i in range(len(prompts)):
        got, want = rec.get(f"port-{i}"), jrec.get(f"jax-{i}")
        assert [e["event"] for e in got["events"]] == [e["event"] for e in want["events"]]
        assert got["finish"] == want["finish"] == "length"
        assert got["prompt_tokens"] == want["prompt_tokens"]


def test_family_names_match_the_jax_server(pair):
    """The same requests through a port server and a JAX server: every port family is
    the JAX family of the same name and type, and the JAX families the port lacks are
    only the not-yet-ported modules' and the router's."""
    be, jbe = pair
    # a family is declared when its module is imported: import both packages' modules a
    # server imports only when asked for them (the supervisor, the model drafter)
    for mod in ("resilience.supervisor", "draft.drafter", "constrain.compiler"):
        importlib.import_module(f"distributed_llama_tpu.{mod}")
        importlib.import_module(f"distributed_llama_tpu_torch.{mod}")
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be)
    jsrv = jserve(None, host="127.0.0.1", port=0, template_type=JTemplateType.CHATML,
                  batch_engine=jbe)
    try:
        fams = []
        for p in (_start(srv), _start(jsrv)):
            for i in range(2):
                r = _post(p, _chat(f"names {i}", 4))
                assert r.status == 200
                r.read()
            fams.append(_families(_get(p, "/metrics").read().decode()))
        port_fams, jax_fams = fams
        assert {n: t for n, t in port_fams.items() if jax_fams.get(n) != t} == {}
        missing = {n for n in set(jax_fams) - set(port_fams)
                   if not NOT_PORTED.match(n) and not n.startswith("router_")}
        assert missing == set()
    finally:
        _stop(srv)
        _stop(jsrv)


def test_dllama_trace_names_and_engine_counters_match_jax(files, tmp_path, capsys):
    """`dllama --trace` on both packages, same run: the port's trace holds the JAX
    trace's span names (engine.dispatch nested in engine.prefill), and the
    single-sequence engine counters move alike."""
    mpath, tpath = files
    argv = ["inference", "--model", mpath, "--tokenizer", tpath, "--steps", "4",
            "--prompt", "ab ab ab ab ab", "--temperature", "0"]
    names, deltas = {}, {}
    for tag, main, reg, tr, extra in (("port", dllama.main, metrics, trace,
                                       ["--device", "cpu"]),
                                      ("jax", jdllama.main, jmetrics, jtrace,
                                       ["--tp", "1"])):
        out = str(tmp_path / f"{tag}.json")
        c0 = {k: _counter(reg, k) for k in ("engine_prefill_tokens_total",
                                            "engine_decode_tokens_total")}
        try:
            main(argv + extra + ["--trace", out])
        finally:
            tr.uninstall()
        deltas[tag] = {k: _counter(reg, k) - v for k, v in c0.items()}
        with open(out) as f:
            evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        names[tag] = {e["name"] for e in evs}
        if tag == "port":
            p = next(e for e in evs if e["name"] == "engine.prefill")
            assert any(p["ts"] <= d["ts"] and d["ts"] + d["dur"] <= p["ts"] + p["dur"]
                       for d in evs if d["name"] == "engine.dispatch")
            assert any(d["ts"] >= p["ts"] + p["dur"]
                       for d in evs if d["name"] == "engine.dispatch")
    assert names["port"] == {"engine.prefill", "engine.dispatch"}
    assert names["port"] <= names["jax"]
    assert deltas["port"] == deltas["jax"] and deltas["port"][
        "engine_decode_tokens_total"] > 0


def test_single_engine_device_loop_trace(files):
    """generate_chunked (`dllama --device-loop`) records engine.device_loop spans and
    counts every delivered token."""
    eng = Engine.load(*files, device="cpu")
    tr = trace.install(capacity=256)
    try:
        d0 = _counter(metrics, "engine_decode_tokens_total")
        out, _ = eng.generate_chunked([1, 5, 9, 13], 8, Sampler(V, 0.0, 0.9, 0), chunk=4)
        assert _counter(metrics, "engine_decode_tokens_total") - d0 == len(out) == 8
        names = [e["name"] for e in tr.events() if e["ph"] == "X"]
        assert names.count("engine.device_loop") == 2 and "engine.prefill" in names
    finally:
        trace.uninstall()


# ----------------------------------------------------------------------
# attribution
# ----------------------------------------------------------------------

def test_tenant_attribution_in_flight_records(files):
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4,
                          tenants=TenantRegistry.parse(TENANTS))
    rec = flight.current() or flight.install()
    try:
        r = be.submit([1, 5, 6], 4, Sampler(V, 0.0, 0.9, 0), tenant="alpha",
                      klass="batch", rid="tn-attr-1")
        r.wait(timeout=120)
        full = rec.get("tn-attr-1")
        assert full["tenant"] == "alpha" and full["class"] == "batch"
        listing = rec.requests(tenant="alpha")
        assert any(s["id"] == "tn-attr-1" for s in listing["completed"])
        assert all(s["tenant"] == "alpha" for s in listing["completed"])
        empty = rec.requests(tenant="nobody")
        assert empty["completed"] == [] and empty["live"] == []
        fam = metrics.snapshot()["batch_tenant_requests_total"]
        assert any('tenant="default"' in k and '"batch"' in k for k in fam), fam
    finally:
        be.close()


@pytest.fixture(scope="module")
def fleet(files):
    """The JAX package's stdlib router (disaggregation threshold 24 tokens) in front of
    two port servers with the roles prefill and decode, each with a tenant registry."""
    reps = []
    for role in ("prefill", "decode"):
        be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4,
                              tenants=TenantRegistry.parse(TENANTS))
        srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML,
                               batch_engine=be, role=role)
        port = _start(srv)
        reps.append({"role": role, "be": be, "srv": srv, "port": port,
                     "id": f"127.0.0.1:{port}"})
    router = serve_router([r["id"] for r in reps], host="127.0.0.1", port=0,
                          poll_interval=0.15, block_bytes=16, retries=2,
                          try_timeout=60.0, disagg_threshold=24)
    yield {"replicas": reps, "port": _start(router), "state": router.router_state}
    close_router(router)
    for r in reps:
        _stop(r["srv"])
        r["be"].close()


def test_api_tenant_attribution_end_to_end(fleet):
    port = fleet["replicas"][1]["port"]
    r = _post(port, _chat("hello", 4), {"X-Tenant": "gold"})
    assert r.status == 200
    rid = r.getheader("X-Request-Id")
    r.read()
    rec = json.loads(_get(port, f"/v1/requests/{rid}").read())
    assert rec["tenant"] == "gold" and rec["class"] == "interactive"
    listing = json.loads(_get(port, "/v1/requests?tenant=gold").read())
    assert any(s["id"] == rid for s in listing["completed"])
    empty = json.loads(_get(port, "/v1/requests?tenant=nonexistent").read())
    assert empty["completed"] == []


def test_disagg_and_tenants_stats_blocks(fleet):
    """The split path's import is counted on the decode replica, the export on the
    prefill replica; /v1/stats shows each replica's disagg and tenants blocks, and the
    router's /healthz the roles in rotation."""
    snap0 = metrics.snapshot()
    body = {"messages": [{"role": "system", "content": "stats" + "s" * 64},
                         {"role": "user", "content": "tell me something"}],
            "max_tokens": 6, "temperature": 0}
    r = _post(fleet["port"], body, {"X-Tenant": "gold"})
    assert r.status == 200
    r.read()
    snap1 = metrics.snapshot()

    def grew(name, key="{}"):
        def val(s):
            v = s.get(name, 0)
            return v.get(key, 0) if isinstance(v, dict) else v
        return val(snap1) - val(snap0)

    assert grew("disagg_import_requests_total", '{outcome="imported"}') == 1
    assert grew("disagg_prefill_requests_total", '{outcome="ok"}') == 1
    assert grew("disagg_import_tokens_total") >= 32
    assert grew("disagg_export_blocks_total") >= 2
    assert grew("disagg_reprefill_tokens_total") == 0
    assert grew("batch_tenant_requests_total", '{tenant="gold",class="interactive"}') == 2
    for rep in fleet["replicas"]:
        data = json.loads(_get(rep["port"], "/v1/stats").read())
        assert data["replica"]["role"] == data["disagg"]["role"] == rep["role"]
        assert data["disagg"]["kv_wire"] == "raw"
        assert data["tenants"]["gold"]["weight"] == 4
    roles = {r["role"] for r in json.loads(
        _get(fleet["port"], "/healthz").read())["replicas"].values()}
    assert roles == {"prefill", "decode"}


# ----------------------------------------------------------------------
# the fleet: the JAX router in front of two port servers
# ----------------------------------------------------------------------

def test_trace_context_propagates_through_fleet_concurrently(fleet):
    """Concurrent short requests through the router: every port-side span and flight
    record carries exactly the trace id its request entered with, the router relays
    /v1/requests lookups, and its /v1/trace merges the router's and both replicas'
    traces."""
    ptr = trace.install(capacity=65536)
    jtr = jtrace.install(capacity=65536)
    try:
        n = 6
        tids = [f"{i:02x}" * 16 for i in range(1, n + 1)]
        results = [None] * n

        def client(i):
            body = {"messages": [{"role": "system", "content": f"sys {i % 2}"},
                                 {"role": "user", "content": f"traced user {i}"}],
                    "max_tokens": 5, "temperature": 0}
            r = _post(fleet["port"], body, {"traceparent": f"00-{tids[i]}-{'77' * 8}-01"})
            results[i] = {"status": r.status, "rid": r.getheader("X-Request-Id"),
                          "replica": r.getheader("X-Replica")}
            r.read()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert all(r and r["status"] == 200 for r in results), results
        assert all(r["rid"] and r["replica"] for r in results), results
        rec = flight.current()
        for i, r in enumerate(results):
            full = rec.get(r["rid"])
            assert full["trace_id"] == tids[i]
            assert full["finish"] in ("length", "stop")
            assert "admitted" in [e["event"] for e in full["events"]]
        per_tid = {t: [] for t in tids}
        for e in ptr.events():
            t = (e.get("args") or {}).get("trace_id")
            if t in per_tid:
                per_tid[t].append(e["name"])
        for t in tids:
            assert any(nm.startswith("batch.") for nm in per_tid[t]), (t, per_tid[t])
        # the router closes a request's `router.proxy` span after relaying the body, so
        # the span can land just after its client has read the response
        deadline = time.monotonic() + 10.0
        while True:
            router_tids = {(e.get("args") or {}).get("trace_id") for e in jtr.events()
                           if e["name"] == "router.proxy"}
            if set(tids) <= router_tids or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        assert set(tids) <= router_tids
        via = json.loads(_get(fleet["port"], f"/v1/requests/{results[0]['rid']}").read())
        assert via["id"] == results[0]["rid"] and via["trace_id"] == tids[0]
        doc = json.loads(_get(fleet["port"], "/v1/trace").read())
        procs = doc["otherData"]["processes"]
        assert len(procs) == 3 and len({p["pid"] for p in procs}) == 3
        assert {p["name"] for p in procs} == {
            "router", *(f"replica {r['id']}" for r in fleet["replicas"])}
        stamped = {(e.get("args") or {}).get("trace_id") for e in doc["traceEvents"]}
        assert set(tids) <= stamped
    finally:
        trace.uninstall()
        jtrace.uninstall()


def test_router_metrics_merged_with_replica_labels(fleet):
    text = _get(fleet["port"], "/metrics").read().decode()
    assert text.count("# TYPE router_routes_total counter") == 1
    for r in fleet["replicas"]:
        assert f'replica="{r["id"]}"' in text
    assert 'api_http_requests_total{replica="' in text
    assert 'batch_decode_tokens_total{replica="' in text
    stats = json.loads(_get(fleet["port"], "/v1/stats").read())
    for r in fleet["replicas"]:
        assert stats["replicas"][r["id"]]["replica"]["model_hash"]
