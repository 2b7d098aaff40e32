"""PyTorch port: durable resume and the durable fleet. The engine cases of
tests/test_resume.py against the port's BatchEngine (the uninterrupted runs held against
the JAX BatchEngine), the server's `resume` payload and `X-Dllama-Journal` mode, and
tests/test_durable.py's mid-stream wedge: the JAX package's stdlib fleet router in front
of two port servers, one of them recovered (`recover_wedged`) mid-stream, the client's
stream byte-identical to an uninterrupted one, greedy and seeded.
"""

import http.client
import json
import threading

import pytest

from distributed_llama_tpu.fleet.router import close_router, serve_router
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.resilience import faults
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler
from distributed_llama_tpu_torch.tokenizer import ChatItem, ChatTemplate, TemplateType

from test_torch_resilience import V, files  # noqa: F401 — the shared fixture

PROMPT = [1] + list(range(30, 49))  # 20 tokens: one full 16-token block in the directory
GEN = 20
FILLERS = ([1, 200, 201], [1, 210, 211])


@pytest.fixture(scope="module")
def engines(files):  # noqa: F811
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
    jbe = JBatchEngine.load(*files, slots=2, tp=1, superstep=4)
    yield be, jbe
    be.close()
    jbe.close()


def _run(be, prompt, n, temp, seed, ff=0, resume_tokens=0, cls=Sampler):
    s = cls(V, temp, 0.9, seed)
    s.fast_forward(ff)
    req = be.submit(list(prompt), n, s, resume_tokens=resume_tokens)
    return req.wait(timeout=300), req


def _displace(be):
    """Two fillers at once take both slots, so a resume finds the prompt in the prefix
    directory, not in a slot's own history."""
    reqs = [be.submit(list(p), 2, Sampler(V, 0.0, 0.9, 0)) for p in FILLERS]
    for r in reqs:
        r.wait(timeout=300)


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "seeded"])
def test_engine_resume_at_k_byte_identical(engines, temp):
    be, jbe = engines
    ref, _ = _run(be, PROMPT, GEN, temp, 99)
    assert ref == _run(jbe, PROMPT, GEN, temp, 99, cls=JSampler)[0]
    assert len(ref) == GEN
    for k in (1, 7, GEN - 1):
        _displace(be)
        r0 = be.remapped_blocks
        cont, req = _run(be, PROMPT + ref[:k], GEN - k, temp, 99, ff=k, resume_tokens=k)
        assert cont == ref[k:], (temp, k)
        assert req.resume_tokens == k
        # the prompt's full block came from the directory, zero bytes moved
        assert be.remapped_blocks > r0 and req.stats.reused_tokens >= 16


def test_engine_resume_mixed_rows_concurrent(engines):
    """A resumed stochastic request co-batched with a fresh greedy one: both finish
    identical to their solo runs (the fast-forwarded RNG survives super-steps and
    rollback)."""
    be, jbe = engines
    ref_s, _ = _run(be, PROMPT, GEN, 0.8, 7)
    ref_g, _ = _run(be, [1, 3, 3, 8], GEN, 0.0, 0)
    assert ref_s == _run(jbe, PROMPT, GEN, 0.8, 7, cls=JSampler)[0]
    assert ref_g == _run(jbe, [1, 3, 3, 8], GEN, 0.0, 0, cls=JSampler)[0]
    k = 6
    s1 = Sampler(V, 0.8, 0.9, 7)
    s1.fast_forward(k)
    r1 = be.submit(PROMPT + ref_s[:k], GEN - k, s1, resume_tokens=k)
    r2 = be.submit([1, 3, 3, 8], GEN, Sampler(V, 0.0, 0.9, 0))
    assert r1.wait(timeout=300) == ref_s[k:]
    assert r2.wait(timeout=300) == ref_g


def test_engine_resume_budget_exhausted(engines):
    be, _ = engines
    ref, _ = _run(be, PROMPT, GEN, 0.8, 42)
    cont, req = _run(be, PROMPT + ref, 0, 0.8, 42, ff=GEN, resume_tokens=GEN)
    assert cont == [] and req.finish == "length"


# ------------------------------------------------------------------
# the server: resume payload and journal mode
# ------------------------------------------------------------------

def _body(seed=None, temperature=0.8, stream=True, max_tokens=40, user="hello durable"):
    b = {"messages": [{"role": "system", "content": "durable shared system prompt"},
                      {"role": "user", "content": user}],
         "max_tokens": max_tokens, "temperature": temperature, "stream": stream}
    if seed is not None:
        b["seed"] = seed
    return b


def _stream(port, body, on_delta=None, headers=None):
    """POST and read an SSE stream: status, text, error event, finish reason and the
    journal fields of each chunk."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            return {"status": resp.status, "body": json.loads(resp.read() or b"{}")}
        text, err, finish, journal, n = [], None, None, [], 0
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            payload = json.loads(line[6:])
            if "error" in payload:
                err = payload["error"]
                break
            if "dllama" in payload:
                journal.append(payload["dllama"])
            d = payload["choices"][0]["delta"].get("content")
            finish = payload["choices"][0].get("finish_reason") or finish
            if d:
                text.append(d)
                n += 1
                if on_delta:
                    on_delta(n)
        return {"status": 200, "text": "".join(text), "error": err, "finish": finish,
                "journal": journal}
    finally:
        conn.close()


@pytest.fixture(scope="module")
def replicas(files):  # noqa: F811
    reps = []
    for _ in range(2):
        be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
        srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        reps.append((be, srv, srv.server_address[1]))
    yield reps
    for be, srv, _p in reps:
        srv.shutdown()
        srv.server_close()
        be.close()


def test_server_journal_and_resume_payload(replicas):
    """Journal mode stamps each chunk with its token ids and the delivered count; a
    resume with the first k of them gives the uninterrupted text (the delivered part
    emitted again, then the continuation) and one token more than the context holds
    is a 400, exactly the context a finish "length"."""
    be, _srv, port = replicas[0]
    body = _body(seed=5, temperature=0.8, max_tokens=24)
    ref = _stream(port, body, headers={"X-Dllama-Journal": "1"})
    assert ref["error"] is None and ref["finish"] == "length"
    toks = [t for j in ref["journal"] for t in j["toks"]]
    assert len(toks) == 24 and [j["n"] for j in ref["journal"]][-1] == 24
    assert all(b["n"] > a["n"] for a, b in zip(ref["journal"], ref["journal"][1:]))
    for k in (1, 9, 23):
        got = _stream(port, {**body, "resume": {"tokens": toks[:k]}})
        assert got["error"] is None and got["text"] == ref["text"], k
        assert got["finish"] == "length"
    tok = be.tokenizer
    tmpl = ChatTemplate(TemplateType.CHATML, tok.chat_template, tok.eos_piece())
    prompt = tok.encode(tmpl.generate([ChatItem(m["role"], m["content"])
                                       for m in body["messages"]]), add_bos=True)
    room = be.spec.seq_len - len(prompt)
    r = _stream(port, {**body, "resume": {"tokens": [5] * room}})
    assert r["status"] == 200 and r["error"] is None and r["finish"] == "length"
    assert _stream(port, {**body, "resume": {"tokens": [5] * (room + 1)}})["status"] == 400


# ------------------------------------------------------------------
# the durable fleet: the JAX package's router in front of two port servers
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(replicas):
    router = serve_router([f"127.0.0.1:{p}" for _, _, p in replicas], host="127.0.0.1",
                          port=0, poll_interval=0.15, block_bytes=16, retries=2,
                          try_timeout=60.0)
    threading.Thread(target=router.serve_forever, daemon=True).start()
    yield router.server_address[1]
    close_router(router)


def _wedge_busy_replica(reps, killed):
    for be, _srv, p in reps:
        with be._plock:
            busy = any(s.req is not None for s in be._slots)
        if busy:
            killed.append(p)
            assert be.recover_wedged()
            return


@pytest.mark.parametrize("temperature,seed", [(0.0, None), (0.8, 1234)],
                         ids=["greedy", "seeded"])
def test_midstream_wedge_failover_byte_identical(replicas, fleet, temperature, seed):
    """The replica serving a stream is recovered mid-stream (its request fails with the
    retriable EngineWedged); the router resumes the journal elsewhere and the client's
    text is the uninterrupted run's, with the journal field never reaching it."""
    body = _body(seed=seed, temperature=temperature)
    ref = _stream(fleet, dict(body))
    assert ref["status"] == 200 and ref["error"] is None and not ref["journal"]
    killed = []
    got = _stream(fleet, dict(body),
                  on_delta=lambda n: (n == 4 and not killed
                                      and _wedge_busy_replica(replicas, killed)))
    assert killed, "the wedge never engaged"
    assert got["error"] is None, got
    assert got["text"] == ref["text"] and got["finish"] == ref["finish"]
    assert not got["journal"]
    assert sum(be.wedge_recoveries for be, _s, _p in replicas) >= 1


def test_deadline_expired_is_408(fleet):
    r = _stream(fleet, _body(seed=1), headers={"X-Deadline-Ms": "0"})
    assert r["status"] == 408
    for bad in ("nan", "inf"):
        assert _stream(fleet, _body(seed=1), headers={"X-Deadline-Ms": bad})["status"] \
            == 400


def test_faults_installed_from_env_in_main(monkeypatch):
    """api_server.main and dllama.main read DLLAMA_FAULTS before they serve."""
    from distributed_llama_tpu_torch.apps import dllama

    seen = []
    monkeypatch.setattr(faults, "install_from_env", lambda *a: seen.append(1))
    monkeypatch.setattr(api_server, "build_server", lambda args: (_ for _ in ()).throw(
        SystemExit(3)))
    with pytest.raises(SystemExit):
        api_server.main(["--model", "m", "--tokenizer", "t"])
    monkeypatch.setattr(dllama, "mode_generate", lambda args: None)
    monkeypatch.setattr(dllama, "install_graceful_stop", lambda: None)
    dllama.main(["generate", "--model", "m", "--tokenizer", "t"])
    assert len(seen) == 2
