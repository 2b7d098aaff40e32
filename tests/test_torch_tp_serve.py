"""PyTorch port: serving over tensor parallelism (parallel/replay.py; the BatchEngine, the
Engine and api_server at tp = 2 over gloo) against the JAX package's BatchEngine(tp=2)
and Engine(tp=2) on conftest's 8-device CPU mesh, on one tiny `.m` file.

- BatchEngine(tp=2) in one world of 2 ranks (tests/torch_tp_serve_ranks.py), rank 0
  leading and rank 1 replaying its operations: the concurrent prompts of
  tests/test_batch_engine.py at superstep 1; staggered requests at superstep 4 with the
  pipeline on (greedy and seeded) and off (tests/test_superstep.py,
  tests/test_pipeline.py); a prefix hit with its remap, a copy-on-write, and a demotion
  and promotion under a small pool; dense caches seeded from the host PrefixCache;
  n-gram speculation, greedy and seeded, with a grammar-masked row; the Q80 wire.
  Tokens, sampler states and cache counters equal JAX's, rank 1's device-sampled token
  blocks equal rank 0's, the paged pool drains, and each dispatch kind's counted wire
  bytes equal collective_bytes_per_step.
- Engine(tp=2): the device loop greedy and seeded, a stop inside a chunk decided on rank
  0 alone, and generate_speculative against JAX Engine(tp=2) (tests/test_device_loop.py).
- What stays refused under tp names its ROADMAP item: dp, the drafter, KV export and
  import, recover_wedged and the server's --supervisor-threshold, --role and spill.
- `api_server --tp 2 --device cpu` in a subprocess: at --batch 2 its greedy completion is
  --tp 1's text and SIGTERM drains it and ends both ranks (exit 0); at --batch 1 likewise,
  and a follower killed with SIGKILL makes the server exit nonzero within
  DEAD_FOLLOWER_S.

The port's worlds run in threads, and the JAX references in two threads of this
process beside them, so the module's wall time is about the JAX side's halved."""

import concurrent.futures
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import torch_tp_serve_ranks as R
from distributed_llama_tpu import constrain as jcon
from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.parallel import launch
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine, collective_bytes_per_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a killed follower must end the server within this many seconds: the launcher sees the
# rank's exit within 0.05 s and stops rank 0 within 5 s
DEAD_FOLLOWER_S = 30.0

CASES = [
    ("concurrent", dict(slots=2, superstep=1, prefix_cache=False), [("concurrent", None)]),
    ("pipeline_on", dict(slots=2, superstep=4, pipeline=True, prefix_cache=False),
     [("staggered", (0.0,)), ("staggered", (0.8,))]),
    ("pipeline_off", dict(slots=2, superstep=4, pipeline=False, prefix_cache=False),
     [("staggered", (0.8,))]),
    ("prefix", dict(slots=2, superstep=4, kv_block_tokens=8, kv_pool_blocks=20),
     [("prefix", None)]),
    ("dense", dict(slots=2, superstep=4, paged_kv=False, prefix_block_tokens=8),
     [("dense", None)]),
    ("spec_grammar", dict(slots=2, superstep=8, speculative=8, prefix_cache=False),
     [("spec", None), ("grammar", None)]),
    ("q80_wire", dict(slots=2, superstep=4, pipeline=True, prefix_cache=False,
                      compress_collectives=True), [("staggered", (0.0,))]),
]
ENGINE_PROMPT = [1, 7, 23, 5]
ENGINE_REP = [1] + R.REP * 3


def _spec(vocab=R.V):
    return ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=vocab, seq_len=128).resolved()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    spec = _spec()
    path = str(tmp_path_factory.mktemp("torch_tp_serve") / "m128.m")
    write_model(path, spec, params_file_order(spec, init_random_params(spec, FloatType.Q40,
                                                                       seed=11)),
                FloatType.Q40)
    return path


class _World(threading.Thread):
    """A launch.run in a thread: the port's ranks work while this process runs the JAX
    side."""

    def __init__(self, target, args):
        super().__init__(daemon=True)
        self.target, self.args, self.out, self.err = target, args, None, None
        self.start()

    def run(self):
        try:
            self.out = launch.run(self.target, 2, "cpu", args=self.args, deadline=600)
        except BaseException as e:  # re-raised in the test that reads the world
            self.err = e

    def result(self):
        self.join(600)
        if self.err is not None:
            raise self.err
        return self.out


@pytest.fixture(scope="module")
def worlds(model):
    return {"batch": _World("torch_tp_serve_ranks:batch_cases", (model, CASES)),
            "engine": _World("torch_tp_serve_ranks:engine_cases",
                             (model, ENGINE_PROMPT, ENGINE_REP))}


def _jax_case(model, case):
    name, kw, scripts = CASES[case]
    jbe = JBatchEngine.load(model, tp=2, **kw)
    try:
        return [_jax_script(jbe, s, a) for s, a in scripts]
    finally:
        jbe.close()


def _jax_engine(model):
    eng = JEngine.load(model, tp=2)
    want = {}
    eng.reset()
    want["loop_greedy"] = eng.generate_chunked(list(ENGINE_PROMPT), 12, JSampler(R.V, 0.0),
                                               chunk=5)[0], eng.pos
    eng.reset()
    want["loop_sampled"] = eng.generate_chunked(
        list(ENGINE_PROMPT), 12, JSampler(R.V, 0.8, 0.9, 5), chunk=4)[0], eng.pos
    seen = []
    eng.reset()
    want["loop_stop"] = eng.generate_chunked(
        list(ENGINE_PROMPT), 12, JSampler(R.V, 0.0), chunk=5,
        stop_check=lambda t: (seen.append(t), len(seen) == 7)[1])[0], eng.pos
    eng.reset()
    want["spec"] = eng.generate_speculative(list(ENGINE_REP), 24, JSampler(R.V, 0.0),
                                            k=8)[0], eng.pos
    return want


@pytest.fixture(scope="module")
def jax_refs(model, worlds):
    """Every JAX reference, two at a time, the slowest first (beside the port's worlds,
    which the `worlds` fixture started)."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    order = sorted(range(len(CASES)), key=lambda i: CASES[i][0] not in (
        "spec_grammar", "dense", "pipeline_on"))
    refs = {i: pool.submit(_jax_case, model, i) for i in order}
    refs["engine"] = pool.submit(_jax_engine, model)
    yield refs
    pool.shutdown(wait=True)


def _jax_script(jbe, script, arg):
    if script == "concurrent":
        return R.concurrent(jbe, JSampler)
    if script == "staggered":
        return R.staggered(jbe, JSampler, *arg)
    if script == "prefix":
        return R.prefix_cycle(jbe, JSampler)
    if script == "dense":
        return R.dense_cycle(jbe, JSampler)
    if script == "spec":
        return R.spec_jobs(jbe, JSampler)
    return R.grammar_jobs(jbe, JSampler, jcon)


def _as_lists(x):
    """Tuples to lists, all the way down (a world's results crossed a pickle)."""
    if isinstance(x, (list, tuple)):
        return [_as_lists(v) for v in x]
    if isinstance(x, dict):
        return {k: _as_lists(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_batch_engine_tp2_matches_jax_tp2(worlds, jax_refs, case):
    name, kw, scripts = CASES[case]
    want = jax_refs[case].result(600)
    lead, follower = (rank[case] for rank in worlds["batch"].result())
    assert lead["name"] == follower["name"] == name
    assert _as_lists(lead["result"]) == _as_lists(want)
    # rank 1 replayed every operation and sampled every device token as rank 0 did
    assert follower["replayed"] > 0
    assert lead["blocks"] == follower["blocks"] and lead["blocks"]
    counts = lead["counts"]
    if kw["superstep"] > 1:
        assert counts["super_steps"] > 0
    if ("staggered", (0.0,)) in scripts:
        assert counts["mixed_steps"] > 0  # the later requests' prefills rode decode rows
    if "pipeline" in kw:
        assert (counts["chained"] > 0) == kw["pipeline"]
    if name == "spec_grammar":
        assert counts["verify_steps"] > 0 and lead["result"][0][2] > 0
    if name == "prefix":
        res = lead["result"][0][1]
        assert res["hits"] >= 2 and res["demoted_blocks"] and res["promoted_blocks"]
        assert lead["cow"] >= 1 and lead["remapped"] >= 4 and res["seed_bytes"] > 0
    if kw.get("paged_kv", True):
        assert lead["drained"]  # every block back but the scratch block


@pytest.mark.parametrize("case", ["pipeline_on", "q80_wire"])
def test_batched_wire_bytes_equal_the_model(worlds, case):
    """Each dispatch kind's counted collectives (rank 0's last of the kind, without the
    control channel's descriptors) equal collective_bytes_per_step at its shape."""
    i = [c[0] for c in CASES].index(case)
    compress = CASES[i][1].get("compress_collectives", False)
    stats = worlds["batch"].result()[0][i]["collectives"]
    assert stats["tp"] == 2 and stats["wire"] == ("q80" if compress else "f32")
    spec = _spec()
    assert {"prefill", "mixed", "super_step"} <= set(stats["last"])
    for kind, row in stats["last"].items():
        want = collective_bytes_per_step(spec, 2, compress, row["rows"], row["t"])
        assert row["sent_bytes_per_device"] == pytest.approx(want * row["steps"],
                                                             rel=1e-12), kind
        merges = 2 * spec.n_layers * row["steps"]
        assert row["counts"] == ({"all-to-all": merges, "all-gather": merges + row["steps"]}
                                 if compress else {"all-reduce": merges,
                                                   "all-gather": row["steps"]}), kind


def test_engine_tp2_device_loop_and_speculation_match_jax_tp2(worlds, jax_refs):
    want = jax_refs["engine"].result(600)
    lead, follower = worlds["engine"].result()
    assert _as_lists(lead) == _as_lists(want)
    assert follower == lead  # the follower stopped where rank 0's stop check did
    assert len(lead["loop_stop"][0]) == 7


def test_what_tp_refuses_names_its_roadmap_item(model, worlds):
    spec = _spec()
    with pytest.raises(ValueError, match=r"Queue A item 1 \(a\): dp"):
        BatchEngine(spec, {}, dp=2, device="cpu")
    with pytest.raises(ValueError, match=r"Queue A item 1 \(c\): the drafter"):
        BatchEngine(spec, {}, tp=2, draft_model=model, speculative=4, device="cpu")
    refused = worlds["batch"].result()[0][0]["refused"]
    assert [m.split("(ROADMAP ")[1] for m in refused] == [
        "Queue A item 1 (c): /v1/kv under tp)", "Queue A item 1 (c): /v1/kv under tp)",
        "Queue A item 1 (c): the hung-engine supervisor under tp)"]
    base = ["--model", model, "--tokenizer", "t.t", "--tp", "2", "--device", "cpu"]
    for flags, item in ((["--supervisor-threshold", "5", "--batch", "2"], "supervisor"),
                        (["--role", "prefill", "--batch", "2"], "/v1/kv"),
                        (["--draft-model", model, "--batch", "2"], "the drafter"),
                        (["--kv-cache-storage", "host"], "spill")):
        args = api_server.build_parser().parse_args(base + flags)
        with pytest.raises(ValueError, match=re.escape(item)):
            api_server.check_tp(args)
    with pytest.raises(ValueError, match="single-card"):
        Engine._refuse_under_tp(kv_cache_storage="disc")


# ---------------------------------------------------------------- the server

SV = 262  # the tokenizer's vocabulary: 3 specials, 256 bytes, " ", "ab", "cd"
HI = {"messages": [{"role": "user", "content": "ab cd ab"}], "max_tokens": 12,
      "temperature": 0}


@pytest.fixture(scope="module")
def server_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tp_server")
    spec = _spec(SV)
    mpath, tpath = str(d / "s.m"), str(d / "s.t")
    write_model(mpath, spec, params_file_order(spec, init_random_params(spec, FloatType.Q40,
                                                                        seed=11)),
                FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [
        b" ", b"ab", b"cd"]
    write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * 259 + [-1.0, -2.0,
                                                                            -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


def _flags(files, batch):
    return ["--model", files[0], "--tokenizer", files[1], "--device", "cpu",
            "--chat-template", "llama2", "--host", "127.0.0.1", "--port", "0",
            "--batch", str(batch), "--temperature", "0", "--seed", "1"]


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.read().decode()


def _tp1_text(files, batch):
    """The in-process --tp 1 server's answer to HI."""
    server = api_server.build_server(api_server.build_parser().parse_args(
        _flags(files, batch)))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        return _post(server.server_address[1], HI)["choices"][0]["message"]["content"]
    finally:
        server.shutdown()
        server.server_close()
        if server.api_state.batch_engine is not None:
            server.api_state.batch_engine.close()


class _TpServer:
    """`api_server --tp 2` in a subprocess: its port (rank 0's listening line) and the
    follower's pid (its stderr line)."""

    def __init__(self, files, batch):
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "distributed_llama_tpu_torch.apps.api_server",
             *_flags(files, batch), "--tp", "2", "--drain-timeout", "60"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                     + os.environ.get("PYTHONPATH", "")))
        self.port = self.follower = None
        found = threading.Event()

        def read_err():
            for line in self.proc.stderr:
                m = re.search(r"tp rank 1/2 replaying rank 0 \(pid (\d+)\)", line)
                if m:
                    self.follower = int(m.group(1))
                    found.set()
        threading.Thread(target=read_err, daemon=True).start()
        for line in self.proc.stdout:
            if "listening on" in line:
                self.port = int(line.rsplit(":", 1)[1])
                break
        threading.Thread(target=lambda: [None for _ in self.proc.stdout],
                         daemon=True).start()
        assert self.port is not None, "rank 0 never listened"
        assert found.wait(60), "the follower never announced itself"

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_api_server_tp2_batch_answers_the_tp1_text_and_drains(server_files):
    want = _tp1_text(server_files, 2)
    srv = _TpServer(server_files, 2)
    try:
        got = _post(srv.port, HI)
        assert got["choices"][0]["message"]["content"] == want
        stats = json.loads(_get(srv.port, "/v1/stats"))
        assert stats["collectives"]["tp"] == 2 and stats["collectives"]["wire"] == "q80"
        assert ('collective_sent_bytes_per_device{program="batch_super_step"}'
                in _get(srv.port, "/metrics"))
        srv.proc.send_signal(signal.SIGTERM)  # the launcher passes it on to rank 0
        assert srv.proc.wait(90) == 0
        t0 = time.time()
        while not _gone(srv.follower) and time.time() - t0 < 30:
            time.sleep(0.1)
        assert _gone(srv.follower)
    finally:
        srv.close()


def test_api_server_tp2_single_sequence_answers_and_a_dead_follower_ends_it(
        server_files):
    want = _tp1_text(server_files, 1)
    srv = _TpServer(server_files, 1)
    try:
        assert _post(srv.port, HI)["choices"][0]["message"]["content"] == want
        os.kill(srv.follower, signal.SIGKILL)
        t0 = time.time()
        code = srv.proc.wait(DEAD_FOLLOWER_S)
        assert code != 0 and time.time() - t0 < DEAD_FOLLOWER_S
    finally:
        srv.close()
