"""PyTorch port: the OpenAI-compatible server (apps/api_server.py) at --batch 2 on the
CPU, against the JAX package's serve() over its BatchEngine in the same configuration
(superstep=1, no pipelining, no prefix cache) on the same `.m`/`.t` pair: /v1/models,
/health, and a non-streaming and a streaming (SSE) chat completion sent concurrently,
whose greedy content must equal the JAX server's."""

import json
import threading
import urllib.request

import pytest

from distributed_llama_tpu.apps.api_server import serve as jserve
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu.tokenizer import TemplateType as JTemplateType
from distributed_llama_tpu_torch.apps import api_server

from test_torch_batch_engine import V, model_files  # noqa: F401 — the shared fixture

BODY = {"messages": [{"role": "user", "content": "ab cd ab"}], "max_tokens": 8,
        "temperature": 0, "seed": 1}


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url + "/v1/chat/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _sse_content(raw: str):
    events = [ln[len("data: "):] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    return text, chunks[-1]["choices"][0]["finish_reason"]


def test_batched_server_matches_jax_server(model_files):  # noqa: F811
    mpath, tpath = model_files
    jbe = JBatchEngine.load(mpath, tpath, slots=2, tp=1, superstep=1, pipeline=False,
                            prefix_cache=False)
    jsrv = jserve(None, "127.0.0.1", 0, JTemplateType.LLAMA2, JSampler(V, 0.0, 0.9, 0),
                  batch_engine=jbe)
    args = api_server.build_parser().parse_args(
        ["--model", mpath, "--tokenizer", tpath, "--batch", "2", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2",
         "--temperature", "0"])
    srv = api_server.build_server(args)
    be = srv.api_state.batch_engine
    try:
        jurl, url = _start(jsrv), _start(srv)
        _, _, raw = _post(jurl, BODY)
        want = json.loads(raw)["choices"][0]
        with urllib.request.urlopen(url + "/v1/models", timeout=60) as r:
            assert json.loads(r.read())["data"][0]["object"] == "model"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        results = {}

        def call(name, body):
            results[name] = _post(url, body)
        threads = [threading.Thread(target=call, args=("json", BODY)),
                   threading.Thread(target=call, args=("sse", {**BODY, "stream": True}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        status, ctype, raw = results["json"]
        got = json.loads(raw)["choices"][0]
        assert status == 200 and ctype == "application/json"
        assert got["message"]["content"] == want["message"]["content"]
        assert got["finish_reason"] == want["finish_reason"]
        status, ctype, raw = results["sse"]
        assert status == 200 and ctype == "text/event-stream"
        assert _sse_content(raw) == (want["message"]["content"], want["finish_reason"])
        assert be.dispatches > 0
    finally:
        for s in (jsrv, srv):
            s.shutdown()
            s.server_close()
        jbe.close()
        be.close()


def test_invalid_requests_get_400(model_files):  # noqa: F811
    mpath, tpath = model_files
    args = api_server.build_parser().parse_args(
        ["--model", mpath, "--tokenizer", tpath, "--batch", "2", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2"])
    srv = api_server.build_server(args)
    try:
        url = _start(srv)
        for body in ({"messages": []}, {**BODY, "max_tokens": -1}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, body)
            assert e.value.code == 400
            assert "error" in json.loads(e.value.read())
    finally:
        srv.shutdown()
        srv.server_close()
        srv.api_state.batch_engine.close()


@pytest.mark.parametrize("argv,fused", [(["--batch", "2"], True), (["--batch", "1"], False),
                                        (["--batch", "1", "--fused-matmul"], True)])
def test_batched_serving_fuses(argv, fused):
    """Every batched dispatch has M > 1 rows: without the fused rung each would
    dequantize every weight, so --batch > 1 always asks for it."""
    args = api_server.build_parser().parse_args(["--model", "m", "--tokenizer", "t", *argv])
    assert api_server.engine_kwargs(args)["fused_matmul"] is fused


def test_serialized_server_serves_the_same_greedy_content(model_files):  # noqa: F811
    """--batch 1 runs the single-sequence Engine under the generation lock; its greedy
    completion equals the batched server's for the same request."""
    mpath, tpath = model_files
    contents = []
    for batch in ("1", "2"):
        args = api_server.build_parser().parse_args(
            ["--model", mpath, "--tokenizer", tpath, "--batch", batch, "--device", "cpu",
             "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2"])
        srv = api_server.build_server(args)
        assert (srv.api_state.batch_engine is None) == (batch == "1")
        try:
            _, _, raw = _post(_start(srv), BODY)
            contents.append(json.loads(raw)["choices"][0])
        finally:
            srv.shutdown()
            srv.server_close()
            if srv.api_state.batch_engine is not None:
                srv.api_state.batch_engine.close()
    assert contents[0] == contents[1]
