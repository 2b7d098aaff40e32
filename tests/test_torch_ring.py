"""PyTorch port: sequence parallelism (distributed_llama_tpu_torch/ops/ring_attention.py,
the (sp, tp) grid of parallel/mesh.py, Engine(sp=), dllama --sp) against the JAX
package's, on the CPU over gloo worlds of 2 and 4 ranks (parallel/launch.py), one
module-scoped world of each size; every (sp, tp) grid of a size is built over its world.

- The ring alone: ring_attention at sp in {2, 4} and T in {1, 5} against JAX's under
  shard_map and against gqa_attention on the full cache, at tests/test_ring.py's atol
  2e-5, rtol 1e-4; the striped layout with live_end, the chunk's register block and
  window_slots the same way; the counted shift bytes (sp - 1 rotations of K and V).
- The cache after the striped commit: a 12-token prefill, an 8-token chunk straddling
  the shard edge and one decode step on the 2 x 2 grid; each rank's stripe equals JAX's
  deferred sharded cache, and destriped the unsharded cache over [0, 21), at 1e-6.
- The forward: the chunk wider than a shard (sp = 4, seq_len 32), the windowed ring
  (attn_window 32, seq_len 64, 2 x 2) and the 2 x 2 sharded forward, each against JAX's
  make_sharded_forward and the unsharded forward at atol 2e-4, rtol 1e-3.
- The engine: Engine(tp=2, sp=2) on a tiny .m/.t pair gives greedy and seeded tokens
  identical to the JAX Engine(tp=2, sp=2) and to JAX tp = 1, through generate,
  generate_chunked(chunk=4), the device loop at chunk 5 and generate_speculative; the
  counted permute and all-reduce bytes of its decode step equal JAX's collective_stats();
  Engine(sp=2) on a world of 2 gives the same greedy tokens.
- The CLI: `dllama generate --sp 2 --device cpu` and `--sp 2 --tp 2` print --sp 1's
  text; `api_server --batch 1 --sp 2` (a subprocess, started beside the worlds) answers
  the in-process --sp 1 server's text, its /v1/stats counting the ring's permutes, and
  drains on SIGTERM. The refusals: the spill, the pool, batch > 1, the BatchEngine,
  api_server --batch 2 --sp 2 (JAX's text), the in-scan write, per-row positions, dp."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llama_tpu.compat import shard_map
from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models import forward as jfwd
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec, RopeType
from distributed_llama_tpu.ops.attention import gqa_attention
from distributed_llama_tpu.ops.ring_attention import ring_attention as jring
from distributed_llama_tpu.ops.rope import RopeTables as JRope
from distributed_llama_tpu.parallel import make_mesh as jmake_mesh
from distributed_llama_tpu.parallel import make_sharded_forward as jsharded
from distributed_llama_tpu.parallel import shard_params as jshard
from distributed_llama_tpu.parallel.tp import init_sharded_kv_cache as jinit_cache
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.quants import QTensor as JQTensor
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.parallel import launch
from distributed_llama_tpu_torch.parallel.mesh import make_mesh
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_spec(spec: ModelSpec) -> TSpec:
    return TSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(TSpec)})


def to_numpy_tree(tree):
    """The JAX params as numpy leaves (the QTensor fields as a dict)."""
    if isinstance(tree, JQTensor):
        return {"ftype": int(tree.ftype), "data": np.asarray(tree.data),
                "scales": None if tree.scales is None else np.asarray(tree.scales),
                "layout": tree.layout, "groups": tree.groups,
                "row_groups": tree.row_groups}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# --------------------------------------------------------------------------------------
# the cases, built once (numpy), and their JAX references
# --------------------------------------------------------------------------------------

S, HS, HQ, HK = 32, 16, 8, 4
POS0 = 11  # queries at 11 .. 11 + T


def _ring_case(sp: int, t: int, striped: bool) -> dict:
    rng = np.random.RandomState(10 * sp + t + 100 * striped)
    case = {"sp": sp, "t": t, "striped": striped,
            "q": rng.randn(1, t, HQ, HS).astype(np.float32),
            "k": rng.randn(1, HK, S, HS).astype(np.float32),
            "v": rng.randn(1, HK, S, HS).astype(np.float32),
            "positions": (POS0 + np.arange(t)).astype(np.int64)}
    if striped:
        # committed rows below POS0; the chunk's own K/V at POS0..; a window of 16
        case.update(live_end=POS0, window_slots=-(-16 // sp),
                    chunk=(rng.randn(1, HK, t, HS).astype(np.float32),
                           rng.randn(1, HK, t, HS).astype(np.float32), POS0))
    return case


RING_CASES = [(sp, t, striped) for sp in (2, 4) for t in (1, 5) for striped in (False, True)]


def _jax_ring(case: dict) -> np.ndarray:
    """JAX's ring_attention under shard_map on sp virtual devices; the striped layout's
    global array puts rank m's stripe at [m·Sb, (m+1)·Sb)."""
    sp = case["sp"]
    k, v = case["k"], case["v"]
    if case["striped"]:
        k = np.concatenate([k[:, :, m::sp] for m in range(sp)], axis=2)
        v = np.concatenate([v[:, :, m::sp] for m in range(sp)], axis=2)
    mesh = jmake_mesh(sp=sp, tp=1, devices=jax.devices()[:sp])
    positions = jnp.asarray(case["positions"], jnp.int32)
    chunk = None
    if case.get("chunk") is not None:
        kn, vn, start = case["chunk"]
        chunk = (jnp.asarray(kn), jnp.asarray(vn), jnp.int32(start))
    live = None if case.get("live_end") is None else jnp.int32(case["live_end"])

    def f(q, kc, vc):
        return jring(q, kc, vc, positions, axis_name="sp", axis_size=sp, live_end=live,
                     chunk=chunk, striped=case["striped"],
                     window_slots=case.get("window_slots"))

    kvp = P(None, None, "sp", None)
    fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), kvp, kvp), out_specs=P(),
                           check_vma=False))
    return np.asarray(fn(jnp.asarray(case["q"]), jnp.asarray(k), jnp.asarray(v)))


def _full_attention(case: dict) -> np.ndarray:
    """gqa_attention on the whole cache (the ring's oracle); with live_end and a chunk,
    the committed rows and then the chunk's."""
    q, k, v = (jnp.asarray(case[n]) for n in ("q", "k", "v"))
    positions = jnp.asarray(case["positions"], jnp.int32)
    if case.get("chunk") is None:
        return np.asarray(gqa_attention(q, k, v, positions))
    kn, vn, start = case["chunk"]
    live = case["live_end"]
    kp = jnp.concatenate([jnp.arange(live), start + jnp.arange(kn.shape[2])])
    return np.asarray(gqa_attention(q, jnp.concatenate([k[:, :, :live], kn], axis=2),
                                    jnp.concatenate([v[:, :, :live], vn], axis=2),
                                    positions, key_positions=kp.astype(jnp.int32)))


def _spec(seq_len: int = 32) -> ModelSpec:
    """tests/test_ring.py's tiny spec."""
    return ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=256, seq_len=seq_len,
                     rope_type=RopeType.LLAMA).resolved()


STRADDLE = [(list(range(1, 13)), 0), (list(range(20, 28)), 12), ([3], 20)]
PLAIN = [([1, 7, 23, 5, 2, 9, 11, 4], 0), ([3], 8)]
WIDE = [([(i % 200) + 1 for i in range(16)], 0), ([3], 16)]
# name -> (sp, tp, seq_len, weight seed, chunks, attn_window)
FORWARD_CASES = {
    "grid_2x2": (2, 2, 32, 3, PLAIN, None),
    "chunk_wider_than_shard_sp4": (4, 1, 32, 4, WIDE, None),
    "windowed_ring_2x2": (2, 2, 64, 6, PLAIN, 32),
    "straddle_commit_2x2": (2, 2, 32, 9, STRADDLE, None),
}


def _forward_case(name: str) -> dict:
    sp, tp, seq_len, seed, chunks, window = FORWARD_CASES[name]
    spec = _spec(seq_len)
    return {"spec": dataclasses.asdict(port_spec(spec)), "sp": sp, "tp": tp,
            "params": to_numpy_tree(init_random_params(spec, FloatType.F32, seed=seed)),
            "chunks": chunks, "window": window}


def _jax_forward(name: str, sharded: bool):
    """JAX's logits of every chunk and its final caches: make_sharded_forward on the
    case's grid (deferred write), or the unsharded forward."""
    sp, tp, seq_len, seed, chunks, window = FORWARD_CASES[name]
    spec = _spec(seq_len)
    params = init_random_params(spec, FloatType.F32, seed=seed)
    rope = JRope.create(spec)
    if sharded:
        mesh = jmake_mesh(sp=sp, tp=tp, devices=jax.devices()[:sp * tp])
        params = jshard(params, mesh, spec)
        kc, vc = jinit_cache(spec, mesh)
        step = jsharded(spec, mesh, params, donate_cache=False, cache_write="deferred",
                        attn_window=window)
    else:
        mesh = None
        kc, vc = jfwd.init_kv_cache(spec)

        def step(p, r, toks, k, v, pos):
            return jfwd.forward(p, spec, r, toks, k, v, pos, cache_write="deferred")
    logits = []
    for toks, start in chunks:
        lg, kc, vc = step(params, rope, jnp.asarray([toks]), kc, vc, jnp.int32(start))
        logits.append(np.asarray(lg)[0])
    return logits, kc, vc, mesh


# --------------------------------------------------------------------------------------
# the engine's model files and runs
# --------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """test_torch_tp.py's tiny .m/.t pair (seq_len 64: 32 positions a stripe at sp=2)."""
    tmp = tmp_path_factory.mktemp("torch_sp_engine")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=262, seq_len=64).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=9)
    mpath = str(tmp / "model.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ", b"ab",
                                                                          b"cd"]
    tpath = str(tmp / "tok.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


PROMPT = [1] + list(range(3, 20))  # 18 tokens: chunks 8, 8, 1, 1
REPEAT = [3, 7, 11, 3, 7, 11, 3, 7]  # prompt-lookup drafts at once
# (how, prompt, tokens, temperature, seed, chunk or speculative k)
ENGINE_RUNS = (("generate", PROMPT, 8, 0.0, 77, 0), ("generate", PROMPT, 8, 0.8, 77, 0),
               ("chunked", PROMPT, 8, 0.0, 77, 4), ("chunked", [1, 7, 23, 5], 12, 0.0, 1, 5),
               ("chunked", PROMPT, 8, 0.8, 5, 4), ("speculative", REPEAT, 24, 0.0, 1, 6))


def _jax_engine_tokens(mpath, tpath, tp: int, sp: int) -> list:
    eng = JEngine.load(mpath, tpath, tp=tp, sp=sp)
    out = []
    for how, prompt, n, temperature, seed, chunk in ENGINE_RUNS:
        eng.reset()
        smp = JSampler(262, temperature, 0.9, seed=seed)
        if how == "generate":
            got, _ = eng.generate(list(prompt), n, smp)
        elif how == "chunked":
            got, _ = eng.generate_chunked(list(prompt), n, smp, chunk=chunk)
        else:
            got, _ = eng.generate_speculative(list(prompt), n, smp, k=chunk)
        out.append(got)
    return out, eng


# --------------------------------------------------------------------------------------
# the worlds: one of 2 ranks and one of 4, each launched once a module, beside the JAX
# references (the port's ranks are processes of their own)
# --------------------------------------------------------------------------------------

class _World(threading.Thread):
    """One launch.run per target on a world of n ranks, in the background."""

    def __init__(self, n: int, sp: int, jobs: list, workdir: str):
        super().__init__(daemon=True)
        self.n, self.sp, self.jobs, self.workdir = n, sp, jobs, workdir
        self.out, self.err = {}, None
        self.start()

    def run(self):
        try:
            for name, target, args in self.jobs:
                self.out[name] = launch.run(target, self.n, "cpu", args=args, sp=self.sp,
                                            workdir=self.workdir, deadline=240)
        except BaseException as e:  # noqa: BLE001 — raised by result()
            self.err = e

    def result(self) -> dict:
        self.join(300)
        if self.is_alive():
            raise AssertionError(f"the world of {self.n} did not finish")
        if self.err is not None:
            raise self.err
        return self.out


HI = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 8}


def _server_flags(files) -> list:
    return ["--model", files[0], "--tokenizer", files[1], "--device", "cpu",
            "--chat-template", "llama2", "--host", "127.0.0.1", "--port", "0", "--batch",
            "1", "--temperature", "0", "--seed", "1"]


def _post(port, body) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


class _SpServer:
    """`api_server --batch 1 --sp 2` in a subprocess; `port()` waits for rank 0's
    listening line."""

    def __init__(self, files):
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "distributed_llama_tpu_torch.apps.api_server",
             *_server_flags(files), "--sp", "2", "--drain-timeout", "60"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO)
        self._port = None

    def port(self) -> int:
        if self._port is None:
            for line in self.proc.stdout:
                m = re.search(r"listening on .*:(\d+)", line)
                if m:
                    self._port = int(m.group(1))
                    break
            threading.Thread(target=lambda: [None for _ in self.proc.stdout],
                             daemon=True).start()
            assert self._port is not None, "rank 0 never listened"
        return self._port

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


@pytest.fixture(scope="module")
def sp_server(model_files):
    srv = _SpServer(model_files)
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, model_files, sp_server):
    mpath, tpath = model_files
    out = {}
    threads = []
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sp{n}")
        ring = [_ring_case(*c) for c in RING_CASES if c[0] <= n]
        torch.save(ring, tmp / "ring.pt")
        jobs = [("ring", "torch_sp_ranks:ring_cases", (str(tmp / "ring.pt"),))]
        if n == 4:
            names = list(FORWARD_CASES)
            torch.save([_forward_case(k) for k in names], tmp / "fwd.pt")
            jobs += [("forward", "torch_sp_ranks:forward_cases", (str(tmp / "fwd.pt"),)),
                     ("engine", "torch_sp_ranks:engine_cases",
                      (mpath, tpath, ENGINE_RUNS))]
        else:
            jobs += [("engine", "torch_sp_ranks:engine_cases",
                      (mpath, tpath, ENGINE_RUNS[:1])),
                     ("refusals", "torch_sp_ranks:refusals", ())]
        threads.append((n, _World(n, 2, jobs, str(tmp))))
    # the JAX references while the worlds run
    jax_ring = {c: _jax_ring(_ring_case(*c)) for c in RING_CASES}
    jax_tp1, jeng1 = _jax_engine_tokens(mpath, tpath, 1, 1)
    jax_grid, jeng = _jax_engine_tokens(mpath, tpath, 2, 2)
    jeng.reset()
    jstats = jeng.collective_stats()
    jax_fwd = {(k, sharded): _jax_forward(k, sharded) for k in FORWARD_CASES
               for sharded in (True, False)}
    for n, world in threads:
        out[n] = world.result()
    out["jax"] = {"ring": jax_ring, "tp1": jax_tp1, "grid": jax_grid, "stats": jstats,
                  "forward": jax_fwd}
    return out


# --------------------------------------------------------------------------------------
# the ring alone
# --------------------------------------------------------------------------------------

@pytest.mark.parametrize("sp,t,striped", RING_CASES)
def test_ring_attention_matches_jax_and_full(worlds, sp, t, striped):
    case = _ring_case(sp, t, striped)
    want_full = _full_attention(case)
    want_jax = worlds["jax"]["ring"][(sp, t, striped)]
    ranks = worlds[sp]["ring"]
    i = [c for c in RING_CASES if c[0] <= sp].index((sp, t, striped))
    slots = case.get("window_slots") or S // sp
    for r, rank in enumerate(ranks):
        got = rank[i]["out"]
        np.testing.assert_allclose(got, want_full, atol=2e-5, rtol=1e-4,
                                   err_msg=f"rank {r} against the full cache")
        np.testing.assert_allclose(got, want_jax, atol=2e-5, rtol=1e-4,
                                   err_msg=f"rank {r} against JAX's ring")
        # sp - 1 rotations of K and V, each (1, hk, slots, hs) f32
        assert rank[i]["count"] == 2 * (sp - 1)
        assert rank[i]["permute"] == 2 * (sp - 1) * HK * slots * HS * 4


# --------------------------------------------------------------------------------------
# the sharded forward and the striped commit
# --------------------------------------------------------------------------------------

def _rank_of(rows: list, s: int, t: int) -> dict:
    (row,) = [r for r in rows if (r["s"], r["t"]) == (s, t)]
    return row


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_sharded_forward_matches_jax(worlds, name):
    sp, tp = FORWARD_CASES[name][:2]
    i = list(FORWARD_CASES).index(name)
    rows = [r[i] for r in worlds[4]["forward"]]
    for sharded in (True, False):
        want = worlds["jax"]["forward"][(name, sharded)][0]
        for row in rows:
            for g, w in zip(row["logits"], want):
                np.testing.assert_allclose(
                    g, w, atol=2e-4, rtol=1e-3,
                    err_msg=f"rank (s={row['s']}, t={row['t']}) against JAX "
                            f"{'sharded' if sharded else 'unsharded'}")
                assert np.array_equal(np.argmax(g, -1), np.argmax(w, -1))
    assert sorted((r["s"], r["t"]) for r in rows) == sorted(
        (s, t) for s in range(sp) for t in range(tp))


def test_striped_commit_matches_jax_cache_and_unsharded(worlds):
    """tests/test_ring.py's straddling chunk: prefill 12, a chunk at 12..20 across the
    shard edge, a decode step at 20."""
    name = "straddle_commit_2x2"
    i = list(FORWARD_CASES).index(name)
    rows = [r[i] for r in worlds[4]["forward"]]
    _, jk, jv, mesh = worlds["jax"]["forward"][(name, True)]
    _, uk, uv, _ = worlds["jax"]["forward"][(name, False)]
    sp, tp = 2, 2
    for cache, jc, uc in (("k", jk, uk), ("v", jv, uv)):
        shards = {s.device: np.asarray(s.data) for s in jc.addressable_shards}
        uc = np.asarray(uc)
        hk = uc.shape[2] // tp
        for s in range(sp):
            for t in range(tp):
                mine = _rank_of(rows, s, t)[cache]
                np.testing.assert_allclose(mine, shards[mesh.devices[0, s, t]], atol=1e-6)
                # destriped: slot j of stripe s is position j·sp + s
                for j in range(mine.shape[3]):
                    p = j * sp + s
                    if p < 21:
                        np.testing.assert_allclose(
                            mine[:, :, :, j], uc[:, :, t * hk:(t + 1) * hk, p], atol=1e-6,
                            err_msg=f"{cache} stripe {s} slot {j} (position {p})")


# --------------------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------------------

@pytest.mark.parametrize("run", range(len(ENGINE_RUNS)))
def test_engine_tp2_sp2_tokens_match_jax_engines(worlds, run):
    ranks = worlds[4]["engine"]
    got = [r["tokens"][run] for r in ranks]
    assert all(g == got[0] for g in got)  # rank 0's decisions reach every rank
    assert got[0] == worlds["jax"]["grid"][run], "against JAX Engine(tp=2, sp=2)"
    assert got[0] == worlds["jax"]["tp1"][run], "against JAX tp=1"


def test_engine_sp2_on_a_world_of_two(worlds):
    ranks = worlds[2]["engine"]
    assert [r["tokens"][0] for r in ranks] == [worlds["jax"]["tp1"][0]] * 2
    # at sp = 2 the two combines are mirror images: the same sums, so the same bits
    assert all(r["first_finite"] and r["first_diff"] == 0.0 for r in ranks)


def test_counted_permute_and_all_reduce_bytes_equal_jax_collective_stats(worlds):
    want = worlds["jax"]["stats"]
    for r in worlds[4]["engine"]:
        for op in ("collective-permute", "all-reduce", "all-gather"):
            assert r["payload"][op] == want.payload_bytes[op], op
            assert r["counts"][op] == want.counts[op], op
        assert r["sent"] == pytest.approx(want.sent_bytes_per_device, rel=1e-9)
        assert set(r["counts"]) == set(want.counts)
        assert r["first_finite"]


# --------------------------------------------------------------------------------------
# the CLI and the refusals
# --------------------------------------------------------------------------------------

def test_cli_sp2_prints_the_sp1_text(model_files, capsysbinary):
    mpath, tpath = model_files
    common = ["--model", mpath, "--tokenizer", tpath, "--steps", "10", "--device", "cpu",
              "--temperature", "0", "--seed", "1", "--prompt", "ab cd ab"]
    runs = {extra: subprocess.Popen(
        [sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama", "generate",
         *common, *extra], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for extra in (("--sp", "2"), ("--sp", "2", "--tp", "2", "--buffer-float-type",
                                      "f32"))}
    dllama.main(["generate", *common])
    want = capsysbinary.readouterr().out.rstrip(b"\n").split(b"\n")[-1]
    for extra, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, stderr.decode()[-2000:]
        out = stdout.rstrip(b"\n").split(b"\n")
        assert out[-1] == want, extra
        assert sum(b"Loaded model" in line for line in out) == 1  # only rank 0 prints
        assert b"sp=2 ring over gloo" in stdout


def test_refusals(worlds, model_files, capsys):
    said = worlds[2]["refusals"][0]
    assert "tp-only" in said[0] and "per-row positions" in said[1]
    with pytest.raises(ValueError, match="host KV spill is single-card"):
        Engine._refuse_under_sp(kv_cache_storage="host")
    with pytest.raises(ValueError, match="block pool is incompatible"):
        Engine._refuse_under_sp(kv_pool=(8, 16))
    with pytest.raises(ValueError, match="per-row cache positions"):
        Engine._refuse_under_sp(batch=2)
    spec = port_spec(_spec())
    with pytest.raises(ValueError, match="per-row cache positions, which the "
                                         "sequence-sharded"):
        BatchEngine(spec, {"blocks": {}}, device="cpu", sp=2)
    with pytest.raises(ValueError, match=r"Queue A item 1 \(a\): dp"):
        make_mesh(tp=1, dp=2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(tp=1, sp=2, device="cpu")
    mpath, tpath = model_files
    with pytest.raises(SystemExit):
        api_server.main(["--model", mpath, "--tokenizer", tpath, "--device", "cpu",
                         "--batch", "2", "--sp", "2"])
    assert ("--batch > 1 requires --sp 1: per-row cache positions are incompatible with "
            "the sequence-sharded (ring) cache") in capsys.readouterr().err
    with pytest.raises(SystemExit):
        dllama.main(["generate", "--model", mpath, "--tokenizer", tpath, "--device",
                     "cpu", "--sp", "2", "--cache-write", "inscan"])
    assert "--cache-write inscan: the port's forward is deferred-only" in (
        capsys.readouterr().err)
    for extra, match in ((["--kv-cache-storage", "host"], "single-card"),
                         (["--draft-model", mpath], "drafter")):
        with pytest.raises(ValueError, match=match):
            dllama.main(["generate", "--model", mpath, "--tokenizer", tpath, "--device",
                         "cpu", "--sp", "2", *extra])


def test_api_server_batch1_sp2_answers_the_sp1_text_and_drains(worlds, model_files,
                                                                sp_server):
    server = api_server.build_server(api_server.build_parser().parse_args(
        _server_flags(model_files)))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        want = _post(server.server_address[1], HI)["choices"][0]["message"]["content"]
    finally:
        server.shutdown()
        server.server_close()
    port = sp_server.port()
    assert _post(port, HI)["choices"][0]["message"]["content"] == want
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=60) as r:
        coll = json.loads(r.read())["collectives"]
    assert (coll["tp"], coll["sp"], coll["wire"]) == (1, 2, "f32")
    assert coll["decode_t1"]["counts"] == {"collective-permute": 2 * 2}  # K, V x 2 layers
    sp_server.proc.send_signal(signal.SIGTERM)  # the launcher passes it on to rank 0
    assert sp_server.proc.wait(90) == 0
