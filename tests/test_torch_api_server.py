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


def test_serialized_server_reuses_prefixes_as_the_jax_server(model_files):  # noqa: F811
    """--batch 1 serves through the single-slot prefix cache: conversation A, an
    unrelated B that displaces it, then A' (A, its reply and a new user turn), whose
    shared full blocks come from the pool — the JAX server's content and its
    prefix-cache hits."""
    from distributed_llama_tpu.runtime.engine import Engine as JEngine

    mpath, tpath = model_files
    system = {"role": "system", "content": "Be terse, ab cd."}
    a = {"messages": [system, {"role": "user", "content": "ab cd ab"}]}
    b = {"messages": [{"role": "user", "content": "cd cd"}]}
    jsrv = jserve(JEngine.load(mpath, tpath, tp=1), "127.0.0.1", 0, JTemplateType.LLAMA2,
                  JSampler(V, 0.0, 0.9, 0))
    srv = api_server.build_server(api_server.build_parser().parse_args(
        ["--model", mpath, "--tokenizer", tpath, "--batch", "1", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2",
         "--temperature", "0"]))
    urls = [_start(jsrv), _start(srv)]
    try:
        contents = []
        for url in urls:
            got = []
            for body in (a, b):
                _, _, raw = _post(url, {**BODY, **body})
                got.append(json.loads(raw)["choices"][0]["message"]["content"])
            a2 = {"messages": a["messages"] + [
                {"role": "assistant", "content": got[0]},
                {"role": "user", "content": "cd ab"}]}
            _, _, raw = _post(url, {**BODY, **a2})
            got.append(json.loads(raw)["choices"][0]["message"]["content"])
            contents.append(got)
        assert contents[0] == contents[1]
        st, jst = srv.api_state.cache.stats(), jsrv.api_state.cache.stats()
        assert st["hits"] == jst["hits"] >= 1 and st["hit_tokens"] == jst["hit_tokens"]
        assert srv.api_state.cache.cache.total_refs() == 0
    finally:
        for s in (jsrv, srv):
            s.shutdown()
            s.server_close()


@pytest.mark.parametrize("argv", [["--batch", "1"], ["--batch", "2"],
                                  ["--batch", "2", "--no-paged-kv"]])
@pytest.mark.parametrize("off", [False, True])
def test_prefix_cache_flags(model_files, argv, off):  # noqa: F811
    """--no-prefix-cache turns the cache off at --batch 1 and --batch N; --no-paged-kv
    serves dense caches with the host PrefixCache; the sizing flags reach the cache."""
    from distributed_llama_tpu_torch.cache import PagedPrefixCache, PrefixCache

    mpath, tpath = model_files
    flags = ["--no-prefix-cache"] if off else ["--prefix-cache-blocks", "7",
                                               "--prefix-cache-block-tokens", "8",
                                               "--prefix-cache-q80"]
    srv = api_server.build_server(api_server.build_parser().parse_args(
        ["--model", mpath, "--tokenizer", tpath, "--device", "cpu", "--host",
         "127.0.0.1", "--port", "0", "--chat-template", "llama2", *argv, *flags]))
    be = srv.api_state.batch_engine
    try:
        pc = be.prefix_cache if be is not None else srv.api_state.cache.cache
        if off:
            assert pc is None
            return
        paged = be is not None and "--no-paged-kv" not in argv
        assert isinstance(pc, PagedPrefixCache if paged else PrefixCache)
        assert (be is not None and be.kv_pool is not None) == paged
        pool = pc.cold if paged else pc.pool
        assert pool.max_blocks == 7 and pool.q80
        assert pc.block_tokens == (16 if paged else 8)  # paged: the kv block tokens
    finally:
        srv.server_close()
        if be is not None:
            be.close()


@pytest.mark.parametrize("batch", ["1", "2"])
def test_speculative_flag_serves_the_same_greedy_content(model_files, batch):  # noqa: F811
    """--speculative 4 builds BatchEngine(speculative=4) at --batch 2 and passes
    speculative_k (and the whole conversation for the proposer) to generate_with at
    --batch 1; the greedy content equals the server's without the flag. A batch engine
    built without speculation refuses speculative_k."""
    mpath, tpath = model_files
    body = {"messages": [{"role": "user", "content": "ab cd ab cd ab cd ab cd ab"}],
            "max_tokens": 12, "temperature": 0, "seed": 1}
    contents = []
    for flags in ([], ["--speculative", "4"]):
        args = api_server.build_parser().parse_args(
            ["--model", mpath, "--tokenizer", tpath, "--batch", batch, "--device", "cpu",
             "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2", *flags])
        srv = api_server.build_server(args)
        be = srv.api_state.batch_engine
        try:
            if be is not None:
                assert be.spec_k == (4 if flags else 0)
            else:
                assert srv.api_state.speculative_k == (4 if flags else 0)
            _, _, raw = _post(_start(srv), body)
            contents.append(json.loads(raw)["choices"][0])
            if be is not None and flags:
                assert be.verify_steps >= 1
            if be is not None and not flags:
                with pytest.raises(ValueError):
                    api_server.serve(None, "127.0.0.1", 0, batch_engine=be,
                                     speculative_k=4)
        finally:
            srv.shutdown()
            srv.server_close()
            if be is not None:
                be.close()
    assert contents[0] == contents[1]
