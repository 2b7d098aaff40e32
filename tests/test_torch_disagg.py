"""PyTorch port: disaggregated prefill (fleet/disagg.py, the BatchEngine's KV export and
import, the server's /v1/kv) against the JAX package on one tiny f32 `.m`/`.t` pair.

- the copies: the transfer table, the token hash and the wire bytes against the JAX
  package's, raw and Q80;
- the engine: the export of a prompt's full blocks against the JAX BatchEngine's
  (bit for bit where both caches hold the same rows — shipped blocks remapped at
  admission — and within the forward tests' KV tolerance where each prefilled them), and
  an import after which admission prefills only the tail with the monolithic run's
  tokens, paged and dense;
- the fleet: the JAX package's stdlib router with a disaggregation threshold in front of
  two port servers with the roles prefill and decode (the fixture and cases of
  tests/test_disagg.py): the split is byte-identical to the monolithic run with no
  shipped token prefilled again, greedy, seeded and streamed; a broken transfer falls
  back to a local prefill; the prefill leg carries the tenant and class; a client's own
  kv_source is stripped.
"""

import http.client
import json
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llama_tpu.cache.wire import encode_blocks as jencode
from distributed_llama_tpu.fleet import disagg as jdisagg
from distributed_llama_tpu.fleet.router import close_router, serve_router
from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.cache.wire import decode_blocks, encode_blocks
from distributed_llama_tpu_torch.fleet import disagg
from distributed_llama_tpu_torch.resilience import faults
from distributed_llama_tpu_torch.resilience.faults import FaultSpec
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler
from distributed_llama_tpu_torch.tokenizer import TemplateType

V = 262
BT = 16
PROMPT = [1] + [(7 * i + 3) % 250 + 5 for i in range(40)]  # 41 tokens: 2 full blocks
KV_ATOL = 1e-5  # the port's prefilled KV against the JAX package's (test_torch_forward)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_disagg")
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


def _blocks(seed: int, n: int, shape=(2, 2, BT, 16), dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape).astype(dtype), rng.standard_normal(shape)
             .astype(dtype)) for _ in range(n)]


# ------------------------------------------------------------------
# the copies against the JAX module
# ------------------------------------------------------------------

@pytest.mark.parametrize("q80", [False, True], ids=["raw", "q80"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_bytes_match_jax(q80, dtype):
    blocks = _blocks(4, 3, dtype=np.float32)
    if dtype == "bfloat16":
        jb = [(k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16))
              for k, v in blocks]
        tb = [(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16())
              for k, v in blocks]
    else:
        jb = blocks
        tb = [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in blocks]
    data = encode_blocks(tb, q80=q80)
    assert data == jencode(jb, q80=q80)
    if not q80:
        for (k, v), (gk, gv) in zip(tb, decode_blocks(data)):
            assert torch.equal(gk, k) and torch.equal(gv, v)


def test_tokens_hash_matches_jax():
    for toks in ([], [1], list(range(300)), [261, 0, 5] * 40):
        assert disagg.tokens_hash(toks) == jdisagg.tokens_hash(toks)


def test_transfer_table_ttl_cap_and_consumption():
    k = np.zeros((1, 1, 4, 2), np.float32)
    for mod in (disagg, jdisagg):
        table = mod.KVTransferTable(cap=2, ttl=1000.0)
        descs = [table.open([1, 2, 3, 4], [(k, k)], 4, "raw") for _ in range(3)]
        assert table.stats() == {"live": 2, "cap": 2, "ttl_s": 1000.0}
        assert table.get(descs[0]["xfer_id"]) is None  # the oldest, evicted by the cap
        d = descs[2]
        assert {key: d[key] for key in d if key != "xfer_id"} == {
            "n_tokens": 4, "n_blocks": 1, "block_tokens": 4,
            "tokens_hash": jdisagg.tokens_hash([1, 2, 3, 4]), "wire": "raw"}
        short = mod.KVTransferTable(cap=2, ttl=0.0)
        assert short.get(short.open([1, 2, 3, 4], [(k, k)], 4, "raw")["xfer_id"]) is None
        cons = mod.KVTransferTable(cap=2, ttl=1000.0, consumed_ttl=0.0)
        d = cons.open(list(range(8)), [(k, k), (k, k)], 4, "raw")
        t = cons.get(d["xfer_id"])
        cons.note_served(t, 0, 1)  # a partial range: still live
        assert cons.get(d["xfer_id"]) is not None
        cons.note_served(t, 1, 1)  # the final block served: consumed
        assert cons.get(d["xfer_id"]) is None


# ------------------------------------------------------------------
# the engine: export and import
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(files):
    """Port and JAX engines on the same weights, paged and dense."""
    got = {}
    for paged in (True, False):
        got[paged] = (BatchEngine.load(*files, slots=2, device="cpu", superstep=4,
                                       paged_kv=paged),
                      JBatchEngine.load(*files, slots=2, tp=1, superstep=4,
                                        paged_kv=paged))
    yield got
    for be, jbe in got.values():
        be.close()
        jbe.close()


def _export(be, prompt, cls):
    req = be.submit(list(prompt), 1, cls(V, 0.0, 0.9, 0), export_kv=True)
    req.wait(timeout=300)
    return req.kv_export


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_export_matches_jax(engines, paged):
    be, jbe = engines[paged]
    # prefilled by each engine: the same tokens and geometry, the rows within tolerance
    got, want = _export(be, PROMPT, Sampler), _export(jbe, PROMPT, JSampler)
    assert got[0] == want[0] == PROMPT[:2 * BT] and got[2] == want[2] == BT
    assert len(got[1]) == len(want[1]) == 2
    for (k, v), (jk, jv) in zip(got[1], want[1]):
        assert tuple(k.shape) == np.asarray(jk).shape == (2, 2, BT, 16)
        np.testing.assert_allclose(_as_np(k), np.asarray(jk), atol=KV_ATOL, rtol=0)
        np.testing.assert_allclose(_as_np(v), np.asarray(jv), atol=KV_ATOL, rtol=0)
    # the same rows in both caches (shipped blocks, remapped or seeded at admission):
    # the exports are the shipped rows, bit for bit. The prompt shares no first token
    # with a slot's history, so no row of it is a same-slot rewind of computed KV
    prompt = [(11 * i + 2) % 250 + 5 for i in range(2 * BT + 4)]
    blocks = _blocks(8 + paged, 2)
    assert be.import_kv_blocks(prompt, blocks) == 2 * BT
    assert jbe.import_kv_blocks(prompt, blocks) == 2 * BT
    got, want = _export(be, prompt, Sampler), _export(jbe, prompt, JSampler)
    assert got[0] == want[0] == prompt[:2 * BT]
    for (k, v), (jk, jv), (bk, bv) in zip(got[1], want[1], blocks):
        assert np.array_equal(_as_np(k), np.asarray(jk)) and np.array_equal(_as_np(k), bk)
        assert np.array_equal(_as_np(v), np.asarray(jv)) and np.array_equal(_as_np(v), bv)
    assert be.exported_blocks >= 4


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "seeded"])
def test_import_prefills_only_the_tail(files, paged, temp):
    """A prefill engine exports, the wire carries the blocks, a decode engine imports
    them: its admission prefills fewer tokens than one block and decodes the tokens of
    the monolithic run (which are the JAX BatchEngine's)."""
    kw = dict(slots=2, device="cpu", superstep=4, paged_kv=paged)
    pre, dec = BatchEngine.load(*files, **kw), BatchEngine.load(*files, **kw)
    jbe = JBatchEngine.load(*files, slots=2, tp=1, superstep=4, paged_kv=paged)
    try:
        ref = jbe.submit(list(PROMPT), 12, JSampler(V, temp, 0.9, 5)).wait(timeout=300)
        mono = dec.submit(list(PROMPT), 12, Sampler(V, temp, 0.9, 5)).wait(timeout=300)
        assert mono == ref
        tokens, blocks, bt = _export(pre, PROMPT, Sampler)
        shipped = decode_blocks(encode_blocks(blocks))
        # the decode engine's cache emptied, so only the import can serve the prompt
        dec.close()
        dec = BatchEngine.load(*files, **kw)
        assert dec.import_kv_blocks(tokens, shipped) == 2 * bt
        p0 = dec.prefilled_tokens
        req = dec.submit(list(PROMPT), 12, Sampler(V, temp, 0.9, 5))
        assert req.wait(timeout=300) == mono
        assert dec.prefilled_tokens - p0 == len(PROMPT) - 2 * bt < bt
        assert req.stats.reused_tokens == 2 * bt
        # blocks of another geometry are refused: nothing imported, nothing poisoned
        bad = _blocks(3, 2, shape=(2, 2, bt, 8))
        assert dec.import_kv_blocks([1] + list(range(60, 91)), bad) == 0
    finally:
        pre.close()
        dec.close()
        jbe.close()


# ------------------------------------------------------------------
# the fleet: the JAX router in front of a prefill and a decode port server
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(files):
    reps = []
    for role in ("prefill", "decode"):
        be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
        srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML,
                               batch_engine=be, role=role)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        reps.append({"role": role, "be": be, "srv": srv, "port": srv.server_address[1]})
    router = serve_router([f"127.0.0.1:{r['port']}" for r in reps], host="127.0.0.1",
                          port=0, poll_interval=0.15, block_bytes=16, retries=2,
                          try_timeout=60.0, disagg_threshold=24)
    threading.Thread(target=router.serve_forever, daemon=True).start()
    yield {"replicas": reps, "port": router.server_address[1],
           "state": router.router_state}
    close_router(router)
    for r in reps:
        r["srv"].shutdown()
        r["srv"].server_close()
        r["be"].close()


def _post(port, body, headers=None, path="/v1/chat/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _text(port, body):
    status, raw = _post(port, body)
    assert status == 200, raw
    if body.get("stream"):
        out = []
        for line in raw.decode().splitlines():
            if line.startswith("data: ") and line != "data: [DONE]":
                payload = json.loads(line[6:])
                assert "error" not in payload, payload
                out.append(payload["choices"][0]["delta"].get("content") or "")
        return "".join(out)
    return json.loads(raw)["choices"][0]["message"]["content"]


def _long_body(seed=None, stream=False, salt=""):
    # the salt leads the prompt: each case's affinity key is cold, so the router splits
    body = {"messages": [{"role": "system", "content": salt + "s" * 64},
                         {"role": "user", "content": "tell me something"}],
            "max_tokens": 10, "temperature": 0, "stream": stream}
    if seed is not None:
        body.update(temperature=0.9, seed=seed)
    return body


def _reference(fleet, body):
    """The monolithic output: the same fleet with the split turned off."""
    state = fleet["state"]
    thr = state.disagg.threshold
    state.disagg.threshold = 0
    try:
        return _text(fleet["port"], body)
    finally:
        state.disagg.threshold = thr


def _split(fleet, body):
    """A split request's text, the decode replica's import record and the prompt tokens
    it prefilled."""
    dec = fleet["replicas"][1]
    dec["srv"].api_state.last_import = None
    p0 = dec["be"].prefilled_tokens
    text = _text(fleet["port"], body)
    return text, dec["srv"].api_state.last_import, dec["be"].prefilled_tokens - p0


@pytest.mark.parametrize("kind", ["greedy", "seeded", "stream"])
def test_split_byte_identical_with_no_reprefill(fleet, kind):
    """The split request runs first (a cold affinity key: once a decode replica holds
    the prefix, the planner routes there and does not split)."""
    body = _long_body(seed=1234 if kind == "seeded" else None, stream=kind == "stream",
                      salt=kind)
    text, rec, prefilled = _split(fleet, body)
    assert rec is not None and rec["outcome"] == "imported", rec
    assert rec["bytes"] > 0 and rec["tokens"] >= 2 * BT
    # only the prompt's tail past the shipped blocks was prefilled on the decode side
    assert prefilled < BT
    assert text == _reference(fleet, {**body, "stream": False})


def test_broken_transfer_falls_back_to_local_prefill(fleet):
    body = _long_body(salt="broken")
    with faults.active(FaultSpec("disagg.fetch", kind="error", count=64)):
        text, rec, prefilled = _split(fleet, body)
    assert rec is not None and rec["outcome"] == "error"
    assert prefilled >= 2 * BT  # the whole prompt, locally
    assert text == _reference(fleet, body)


def test_export_endpoint_ranges_resumable_and_404(fleet):
    pre = fleet["replicas"][0]
    blocks = _blocks(5, 3)
    desc = pre["srv"].api_state.kv_transfers.open(list(range(48)), blocks, BT, "raw")
    xid = desc["xfer_id"]
    for _ in range(2):  # the same range twice: resumable by construction
        got = disagg.fetch_kv_blocks("127.0.0.1", pre["port"], xid, 1, 2)
        assert len(got) == 2 and np.array_equal(got[0][0].numpy(), blocks[1][0])
    for path, code in ((f"/v1/kv/{xid}?from=2&n=5", 400), (f"/v1/kv/{xid}?from=x", 400),
                       ("/v1/kv/kv-nonexistent?from=0&n=1", 404)):
        conn = http.client.HTTPConnection("127.0.0.1", pre["port"], timeout=30)
        conn.request("GET", path)
        assert conn.getresponse().status == code, path
        conn.close()


def test_prefill_leg_carries_tenant_and_class(fleet, monkeypatch):
    pre = fleet["replicas"][0]
    seen = []
    submit = pre["be"].submit

    def spy(*a, **kw):
        req = submit(*a, **kw)
        seen.append((req.tenant, req.klass, req.export_kv))
        return req
    monkeypatch.setattr(pre["be"], "submit", spy)
    status, raw = _post(pre["port"], {"messages": [{"role": "system", "content": "t" * 80},
                                                   {"role": "user", "content": "who"}]},
                        {"X-Tenant": "gold", "X-Class": "batch"}, path="/v1/kv")
    desc = json.loads(raw)
    assert status == 200 and desc["n_blocks"] > 0 and desc["wire"] == "raw"
    assert seen == [("gold", "batch", True)]
    assert _post(pre["port"], {"messages": []}, path="/v1/kv")[0] == 400


def test_router_strips_client_supplied_kv_source(fleet):
    for r in fleet["replicas"]:
        r["srv"].api_state.last_import = None
    body = {"messages": [{"role": "user", "content": "short q"}], "max_tokens": 4,
            "temperature": 0,
            "kv_source": {"replica": "127.0.0.1:9", "xfer_id": "kv-evil", "n_tokens": 16,
                          "n_blocks": 1, "block_tokens": 16, "tokens_hash": "0" * 16,
                          "wire": "raw"}}
    assert _post(fleet["port"], body)[0] == 200
    assert all(r["srv"].api_state.last_import is None for r in fleet["replicas"])


def test_healthz_role_and_kv_flags(fleet):
    for r in fleet["replicas"]:
        conn = http.client.HTTPConnection("127.0.0.1", r["port"], timeout=30)
        conn.request("GET", "/healthz")
        data = json.loads(conn.getresponse().read())
        conn.close()
        assert data["replica"]["role"] == r["role"]
    p = api_server.build_parser()
    args = p.parse_args(["--model", "m", "--tokenizer", "t", "--role", "prefill",
                         "--kv-wire-q80", "--kv-transfer-ttl", "30",
                         "--kv-transfer-cap", "4"])
    assert (args.role, args.kv_wire_q80, args.kv_transfer_ttl, args.kv_transfer_cap) == (
        "prefill", True, 30.0, 4)
    d = p.parse_args(["--model", "m", "--tokenizer", "t"])
    assert (d.role, d.kv_wire_q80, d.kv_transfer_ttl, d.kv_transfer_cap) == (
        "both", False, 120.0, 32)
    with pytest.raises(SystemExit):
        p.parse_args(["--model", "m", "--tokenizer", "t", "--role", "router"])


def test_q80_wire_split_ships_fewer_bytes(files):
    """A prefill server on the Q80 wire: the decode side imports (lossy rows, so no token
    identity is asked of it) from fewer bytes than the raw wire's."""
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
    dec = BatchEngine.load(*files, slots=2, device="cpu", superstep=4)
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be,
                           role="prefill", kv_wire_q80=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        status, raw = _post(port, {"messages": _long_body()["messages"]}, path="/v1/kv")
        desc = json.loads(raw)
        assert status == 200 and desc["wire"] == "q80" and desc["n_blocks"] >= 2
        state = srv.api_state
        tokens = state.kv_transfers.get(desc["xfer_id"]).tokens
        rec: dict = {}
        got = disagg.import_kv_source(dec, tokens + [5], {**desc, "replica":
                                                         f"127.0.0.1:{port}"}, record=rec)
        assert got == desc["n_tokens"] and rec["outcome"] == "imported"
        raw_bytes = len(encode_blocks(state.kv_transfers.get(desc["xfer_id"]).blocks))
        assert 0 < rec["bytes"] < raw_bytes
        # a descriptor for other tokens is refused before any fetch
        assert disagg.import_kv_source(dec, [9] * len(tokens), {
            **desc, "replica": f"127.0.0.1:{port}"}, record=rec) == 0
        assert rec["outcome"] == "hash_mismatch"
    finally:
        srv.shutdown()
        srv.server_close()
        be.close()
        dec.close()
