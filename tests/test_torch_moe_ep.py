"""PyTorch port: expert parallelism (moe_sharding="expert": whole experts over tp,
parallel/sharding.py _EP_SPLITS, models/forward.py _moe_ffn on the owner window, the
matvecs' owner window) against the JAX package's, on the CPU over gloo worlds of 2 and 4 ranks
(parallel/launch.py), one module-scoped world of each size running every case in the
background while the JAX references compute (the rank code is tests/torch_ep_ranks.py).

- Every case of tests/test_moe_ep.py: the expert-sharded forward at tp = 4 for Mixtral
  and Grok-1, a 3-token chunk and a 1-token decode at pos 2, against the JAX package's
  replicated forward at its 2e-4 atol/rtol (and at tp = 2, el = 2); Q40 weights through
  prepare_for_cuda(moe_sharding="expert") (every MoE stack groups = 1, row_groups = 1)
  and the kernels' plain versions (the expert entries' owner window), against JAX's
  expert-sharded Pallas path at test_torch_tp.py's kernel tolerance and within JAX's
  0.03·max of its replicated logits with the same argmax; batched decode with per-row
  positions; Engine(tp=4, moe_sharding="expert") greedy tokens identical to the JAX
  Engine(tp=1)'s; the divisibility refusal.
- Beside them: Engine(tp=2) through generate, the device loop and n-gram speculation
  (and on the Q80 wire), and Engine(sp=2, tp=2), each with JAX tp = 1's tokens (the
  Q80 wire: the JAX Engine's on the same wire), the counted bytes of a decode step equal
  to collective_kbytes_per_token; the layout inert at tp = 1; BatchEngine(tp=2,
  moe_sharding="expert") with super-steps and speculation, whose greedy tokens equal
  the JAX Engine's, rank 1's device blocks rank 0's; the expert entries' plain window
  against the JAX package's owner test (lax.cond around its Pallas matvec) for indices
  inside, at the edges of and outside [e_lo, e_lo + el), outside exactly zero;
  `dllama generate --tp 2 --moe-sharding expert` printing --tp 1's text, and its
  argument checks."""

import dataclasses
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models import forward as jfwd
from distributed_llama_tpu.models.params import init_random_params, prepare_for_pallas
from distributed_llama_tpu.models.spec import ArchType, HiddenAct, ModelSpec, RopeType
from distributed_llama_tpu.ops.matmul import qmatmul as jqmatmul
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
from distributed_llama_tpu_torch.models.params import params_from_numpy, prepare_for_cuda
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.ops import q4_matvec as mv
from distributed_llama_tpu_torch.ops import q8_matvec as q8
from distributed_llama_tpu_torch.parallel import launch
from distributed_llama_tpu_torch.parallel.sharding import check_divisibility
from distributed_llama_tpu_torch.quants import QTensor
from distributed_llama_tpu_torch.runtime.engine import Engine, collective_kbytes_per_token
from distributed_llama_tpu_torch.runtime.sampler import Sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _moe_spec(arch=ArchType.MIXTRAL, **kw):
    """tests/test_moe_ep.py's spec."""
    base = dict(arch_type=arch, dim=128, hidden_dim=128, n_layers=2, n_heads=4,
                n_kv_heads=4, vocab_size=128, seq_len=32, n_experts=4,
                n_active_experts=2, rope_type=RopeType.FALCON)
    if arch == ArchType.GROK1:
        base["hidden_act"] = HiddenAct.GELU
    base.update(kw)
    return ModelSpec(**base).resolved()


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
# the cases
# --------------------------------------------------------------------------------------

SEED_STEP = ([[5, 6]], 0)  # decode continues from a seeded cache: pos > 0
# name -> (tp, arch, weights, seed, kernels, batch, steps); the last step is held
FORWARD_CASES = {
    "mixtral_chunk_tp4": (4, ArchType.MIXTRAL, FloatType.F32, 7, False, 1,
                          [SEED_STEP, ([[1, 2, 3]], 2)]),
    "mixtral_decode_tp4": (4, ArchType.MIXTRAL, FloatType.F32, 7, False, 1,
                           [SEED_STEP, ([[9]], 2)]),
    "grok1_chunk_tp4": (4, ArchType.GROK1, FloatType.F32, 7, False, 1,
                        [SEED_STEP, ([[1, 2, 3]], 2)]),
    "grok1_decode_tp4": (4, ArchType.GROK1, FloatType.F32, 7, False, 1,
                         [SEED_STEP, ([[9]], 2)]),
    "mixtral_q40_kernels_tp4": (4, ArchType.MIXTRAL, FloatType.Q40, 3, True, 1,
                                [([[7]], 0)]),
    "mixtral_batched_decode_tp4": (4, ArchType.MIXTRAL, FloatType.F32, 12, False, 2,
                                   [([[1, 2, 3], [4, 5, 6]], 0), ([[7], [9]], [3, 2])]),
    "mixtral_decode_tp2": (2, ArchType.MIXTRAL, FloatType.F32, 7, False, 1,
                           [SEED_STEP, ([[9]], 2)]),
    "grok1_chunk_tp2": (2, ArchType.GROK1, FloatType.F32, 7, False, 1,
                        [SEED_STEP, ([[1, 2, 3]], 2)]),
}

ENGINE_PROMPT = [1, 5, 9]
REPEAT = [3, 7, 11, 3, 7, 11, 3, 7]  # prompt-lookup drafts at once
# name -> (grid (sp, tp), weights seed, compress, runs [(how, prompt, n, k)])
ENGINE_CASES = {
    "tp4": ((1, 4), 21, False, [("generate", ENGINE_PROMPT, 6, 0)]),
    "sp2_tp2": ((2, 2), 21, False, [("generate", ENGINE_PROMPT, 6, 0)]),
    "tp2": ((1, 2), 21, False, [("generate", ENGINE_PROMPT, 6, 0),
                                ("chunked", ENGINE_PROMPT, 6, 4),
                                ("speculative", REPEAT, 12, 4)]),
    "tp2_q80_wire": ((1, 2), 21, True, [("generate", ENGINE_PROMPT, 6, 0)]),
}
BATCH_PROMPTS = [(ENGINE_PROMPT, 8), (REPEAT, 10)]
BATCH_KW = dict(slots=2, superstep=4, speculative=4)


def _weights(arch, ftype, seed):
    return init_random_params(_moe_spec(arch), ftype, seed=seed)


def _jax_replicated(spec, params, steps, batch, kernels=False):
    """The JAX package's unsharded forward over the steps: the last step's logits."""
    rope = JRope.create(spec)
    if kernels:
        params = prepare_for_pallas(params, 1, spec=spec)
    kc, vc = jfwd.init_kv_cache(spec, batch=batch)
    for toks, start in steps:
        pos = jnp.int32(start) if isinstance(start, int) else jnp.asarray(start, jnp.int32)
        lg, kc, vc = jfwd.forward(params, spec, rope, jnp.asarray(toks), kc, vc, pos,
                                  cache_write="deferred", use_pallas=kernels)
    return np.asarray(lg)


def _jax_expert_sharded_kernels(spec, params, tp, steps):
    """JAX's expert-sharded Pallas path (tests/test_moe_ep.py's quantized case)."""
    rope = JRope.create(spec)
    mesh = jmake_mesh(tp=tp)
    pp = prepare_for_pallas(params, tp=tp, moe_sharding="expert")
    sharded = jshard(pp, mesh, spec, moe_sharding="expert")
    step = jsharded(spec, mesh, sharded, donate_cache=False, use_pallas=True,
                    moe_sharding="expert")
    kc, vc = jinit_cache(spec, mesh)
    for toks, start in steps:
        lg, kc, vc = step(sharded, rope, jnp.asarray(toks), kc, vc, jnp.int32(start))
    return np.asarray(lg)


class _World(threading.Thread):
    """launch.run of each job on a world of n ranks, in the background."""

    def __init__(self, n: int, jobs: list, workdir: str):
        super().__init__(daemon=True)
        self.n, self.jobs, self.workdir = n, jobs, workdir
        self.out, self.err = {}, None
        self.start()

    def run(self):
        try:
            for name, target, args in self.jobs:
                self.out[name] = launch.run(target, self.n, "cpu", args=args,
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


# --------------------------------------------------------------------------------------
# the CLI's tiny MoE pair, and the worlds
# --------------------------------------------------------------------------------------

CLI_VOCAB = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ", b"ab",
                                                                          b"cd"]


@pytest.fixture(scope="module")
def moe_files(tmp_path_factory):
    """A tiny Mixtral .m/.t pair: 4 experts, dim 64 (32 a rank at tp = 2)."""
    tmp = tmp_path_factory.mktemp("torch_ep_cli")
    spec = ModelSpec(arch_type=ArchType.MIXTRAL, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=len(CLI_VOCAB), seq_len=64,
                     n_experts=4, n_active_experts=2, rope_type=RopeType.FALCON).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=9)
    mpath, tpath = str(tmp / "moe.m"), str(tmp / "tok.t")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
    write_tokenizer(tpath, TokenizerData(vocab=CLI_VOCAB,
                                         scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


def _cli_args(files, *extra):
    return ["generate", "--model", files[0], "--tokenizer", files[1], "--steps", "10",
            "--device", "cpu", "--temperature", "0", "--seed", "1", "--prompt",
            "ab cd ab", *extra]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, moe_files):
    """Every rank case, one launch per world size and job, in the background; the
    `dllama --tp 2 --moe-sharding expert` subprocess beside them."""
    cli = subprocess.Popen([sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama",
                            *_cli_args(moe_files, "--tp", "2", "--moe-sharding", "expert")],
                           cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    threads = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ep{n}")
        fwd = []
        for name, (tp, arch, ftype, seed, kernels, batch, steps) in FORWARD_CASES.items():
            if tp == n:
                fwd.append({"spec": dataclasses.asdict(port_spec(_moe_spec(arch))),
                            "params": to_numpy_tree(_weights(arch, ftype, seed)),
                            "use_kernels": kernels, "batch": batch, "steps": steps})
        torch.save(fwd, tmp / "forward.pt")
        eng = []
        for name, (grid, seed, compress, runs) in ENGINE_CASES.items():
            if grid[0] * grid[1] == n:
                eng.append({"spec": dataclasses.asdict(port_spec(_moe_spec())),
                            "params": to_numpy_tree(_weights(ArchType.MIXTRAL,
                                                             FloatType.F32, seed)),
                            "grid": grid, "compress": compress, "use_kernels": False,
                            "runs": runs})
        torch.save(eng, tmp / "engine.pt")
        jobs = [("forward", "torch_ep_ranks:forward_cases", (str(tmp / "forward.pt"),)),
                ("engine", "torch_ep_ranks:engine_cases", (str(tmp / "engine.pt"),))]
        if n == 2:
            torch.save({"spec": dataclasses.asdict(port_spec(_moe_spec())),
                        "params": to_numpy_tree(_weights(ArchType.MIXTRAL, FloatType.F32,
                                                         21)),
                        "kw": dict(BATCH_KW, device="cpu"), "prompts": BATCH_PROMPTS},
                       tmp / "batch.pt")
            jobs.append(("batch", "torch_ep_ranks:batch_case", (str(tmp / "batch.pt"),)))
        threads[n] = _World(n, jobs, str(tmp))
    out = {n: w.result() for n, w in threads.items()}
    try:
        stdout, stderr = cli.communicate(timeout=240)
    finally:
        if cli.poll() is None:
            cli.kill()
    out["cli"] = (cli.returncode, stdout, stderr)
    return out


def _forward_result(worlds, name):
    tp = FORWARD_CASES[name][0]
    names = [n for n, c in FORWARD_CASES.items() if c[0] == tp]
    return [r[names.index(name)] for r in worlds[tp]["forward"]]


def _engine_result(worlds, name):
    grid = ENGINE_CASES[name][0]
    n = grid[0] * grid[1]
    names = [k for k, c in ENGINE_CASES.items() if c[0][0] * c[0][1] == n]
    return [r[names.index(name)] for r in worlds[n]["engine"]]


_JAX_TOKENS: dict = {}


def _jax_tokens(seed, prompt, n, tp=1, compress=False):
    """The JAX Engine's greedy tokens on tests/test_moe_ep.py's Mixtral draw (tp > 1:
    moe_sharding="expert")."""
    key = (seed, tuple(prompt), n, tp, compress)
    if key not in _JAX_TOKENS:
        spec = _moe_spec()
        params = _weights(ArchType.MIXTRAL, FloatType.F32, seed)
        kw = dict(moe_sharding="expert", compress_collectives=compress) if tp > 1 else {}
        eng = JEngine(spec, params, tp=tp, **kw)
        _JAX_TOKENS[key], _ = eng.generate(list(prompt), n,
                                           JSampler(spec.vocab_size, temperature=0.0))
    return _JAX_TOKENS[key]


# --------------------------------------------------------------------------------------
# tests/test_moe_ep.py's cases
# --------------------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n, c in FORWARD_CASES.items() if not c[4]])
def test_expert_sharded_matches_replicated(worlds, name):
    tp, arch, ftype, seed, _, batch, steps = FORWARD_CASES[name]
    ranks = _forward_result(worlds, name)
    spec = _moe_spec(arch)
    want = _jax_replicated(spec, _weights(arch, ftype, seed), steps, batch)
    np.testing.assert_allclose(ranks[0]["logits"][-1], want, atol=2e-4, rtol=2e-4)
    # every rank's stacks: E/tp whole experts
    for r in ranks:
        shape = r["stacks"]["moe_up"][0]
        assert shape[1] == spec.n_experts // tp and shape[2:] == (spec.hidden_dim, spec.dim)


def test_expert_sharded_quantized_kernel_path(worlds):
    """Q40 through prepare_for_cuda(moe_sharding="expert") and the kernels' plain
    versions: each rank's stacks whole experts in one-card packs, its decode through the
    expert entries' owner window."""
    tp, arch, ftype, seed, _, batch, steps = FORWARD_CASES["mixtral_q40_kernels_tp4"]
    ranks = _forward_result(worlds, "mixtral_q40_kernels_tp4")
    spec = _moe_spec(arch)
    params = _weights(arch, ftype, seed)
    pp = prepare_for_cuda(params_from_numpy(to_numpy_tree(params)), tp=tp,
                          spec=port_spec(spec), moe_sharding="expert")
    assert pp["blocks"]["moe_down"].groups == 1  # whole experts: no column groups
    assert pp["blocks"]["moe_gu"].row_groups == 1  # [up | gate] with no interleave
    for r in ranks:
        for name, (shape, layout, groups, row_groups) in r["stacks"].items():
            assert shape[1] == spec.n_experts // tp and groups == 1 and row_groups == 1, name
            assert layout == "i4p", name
    got = ranks[0]["logits"][-1]
    want = _jax_expert_sharded_kernels(spec, params, tp, steps)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    plain = _jax_replicated(spec, params, steps, batch)
    rel = np.abs(got - plain).max() / (np.abs(plain).max() + 1e-9)
    assert rel < 0.03, rel  # Q80 activation-quantization error scale
    assert np.argmax(got, -1).tolist() == np.argmax(plain, -1).tolist()


@pytest.mark.parametrize("name", ["tp4", "sp2_tp2", "tp2"])
def test_engine_expert_sharded_generation(worlds, name):
    """Engine(moe_sharding="expert") greedy tokens against the JAX Engine(tp=1)'s: at tp =
    4, on the 2 x 2 (sp x tp) grid, and at tp = 2 through the host loop, the device loop
    and n-gram speculation; every rank decodes rank 0's tokens; the counted bytes of a
    decode step are the model's, as under "slice"."""
    grid, seed, _, runs = ENGINE_CASES[name]
    ranks = _engine_result(worlds, name)
    spec = port_spec(_moe_spec())
    for i, (how, prompt, n, _) in enumerate(runs):
        want = _jax_tokens(seed, prompt, n)
        for r in ranks:
            assert r["tokens"][i] == want, (how, r["tokens"][i], want)
    for r in ranks:
        assert r["moe_sharding"] == "expert" and r["experts"] == spec.n_experts // grid[1]
        if grid[0] == 1:
            model = collective_kbytes_per_token(spec, grid[1], False) * 1024.0
            assert r["sent"] == model
            assert r["counts"] == {"all-reduce": 2 * spec.n_layers, "all-gather": 1}


def test_engine_expert_sharded_on_the_q80_wire(worlds):
    """The Q80 wire: tokens the JAX Engine(tp=2, moe_sharding="expert") gives on the same
    wire, and the counted bytes of a decode step the model's."""
    grid, seed, _, runs = ENGINE_CASES["tp2_q80_wire"]
    spec = port_spec(_moe_spec())
    (how, prompt, n, _), = runs
    want = _jax_tokens(seed, prompt, n, tp=2, compress=True)
    model = collective_kbytes_per_token(spec, 2, True) * 1024.0
    for r in _engine_result(worlds, "tp2_q80_wire"):
        assert r["tokens"][0] == want
        assert r["sent"] == model
        assert r["counts"] == {"all-to-all": 2 * spec.n_layers,
                               "all-gather": 2 * spec.n_layers + 1}


def test_expert_layout_is_inert_on_one_card():
    """moe_sharding="expert" at tp = 1 (the JAX Engine's rule): whole experts over one
    rank are the model, so the Engine keeps the layout's name and decodes what "slice"
    decodes; a dense model's layout is "slice"."""
    spec = _moe_spec()
    params = _weights(ArchType.MIXTRAL, FloatType.Q40, 21)
    tparams = to_numpy_tree(params)
    toks = {}
    for layout in ("slice", "expert"):
        eng = Engine(port_spec(spec), params_from_numpy(tparams), device="cpu",
                     use_kernels=True, moe_sharding=layout)
        assert eng.moe_sharding == layout
        assert eng.params["blocks"]["moe_gu"].shape[1] == spec.n_experts
        toks[layout], _ = eng.generate(ENGINE_PROMPT, 6, Sampler(spec.vocab_size, 0.0))
    assert toks["expert"] == toks["slice"]
    dense = port_spec(_moe_spec(ArchType.LLAMA, n_experts=0, n_active_experts=0))
    eng = Engine(dense, params_from_numpy(to_numpy_tree(init_random_params(
        _moe_spec(ArchType.LLAMA, n_experts=0, n_active_experts=0), FloatType.Q40, 1))),
                 device="cpu", moe_sharding="expert")
    assert eng.moe_sharding == "slice"
    with pytest.raises(ValueError, match="'slice' or 'expert'"):
        Engine(port_spec(spec), params_from_numpy(tparams), device="cpu",
               moe_sharding="experts")


def test_expert_sharded_batched_serving(worlds):
    """BatchEngine(tp=2, moe_sharding="expert"), two greedy requests together through
    super-steps of 4 and speculation 4: each output the JAX Engine's tokens on the same
    draw; rank 1 replayed every device operation, its device-sampled blocks rank 0's."""
    lead, follower = worlds[2]["batch"]
    assert lead["moe_sharding"] == "expert"
    for out, (prompt, n) in zip(lead["outs"], BATCH_PROMPTS):
        assert out == _jax_tokens(21, prompt, n)
    assert lead["counts"]["super_steps"] > 0 and lead["counts"]["verify_steps"] > 0
    assert follower["replayed"] > 0
    assert follower["blocks"] == lead["blocks"] and lead["blocks"]


def test_expert_sharding_requires_divisibility():
    spec = port_spec(_moe_spec(dim=256, n_experts=4, n_heads=8, n_kv_heads=8))
    with pytest.raises(ValueError, match="expert sharding: tp=8 must divide n_experts=4"):
        check_divisibility(spec, tp=8, moe_sharding="expert")
    check_divisibility(spec, tp=4, moe_sharding="expert")


# --------------------------------------------------------------------------------------
# the owner window of the expert entries, against the JAX package's owner test
# --------------------------------------------------------------------------------------

E, EL, H, K = 8, 4, 64, 256  # moe_gu: (2H, K) an expert
WINDOW_INDICES = (-1, 0, 3, 4, 7, 8)  # outside, the edges of both windows, outside


def _jax_owner_test(x, stack: JQTensor, e: int, e_lo: int):
    """JAX's per-(row, expert) owner test (models/forward.py _moe_ffn_expert_sharded):
    lax.cond(in_range, its Pallas matvec against local expert e - e_lo, zeros)."""
    e_rel = jnp.int32(e) - e_lo
    in_range = (e_rel >= 0) & (e_rel < EL)
    e_loc = jnp.clip(e_rel, 0, EL - 1)

    def compute():
        w = jax.tree_util.tree_map(lambda a: jax.lax.dynamic_slice_in_dim(a, e_loc, 1, 0)[0],
                                   stack)
        return jqmatmul(x, w, use_pallas=True)
    return np.asarray(jax.lax.cond(in_range, compute, lambda: jnp.zeros((1, 2 * H))))


@pytest.mark.parametrize("ftype", [FloatType.Q40, FloatType.Q80])
def test_owner_window_against_the_jax_owner_test(ftype):
    spec = _moe_spec(n_experts=E, dim=K, hidden_dim=H, n_heads=8, n_kv_heads=8)
    params = prepare_for_pallas(init_random_params(spec, ftype, seed=31), 1,
                                moe_sharding="expert", spec=spec)
    jstack = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["moe_gu"])
    assert jstack.layout == ("i4p" if ftype == FloatType.Q40 else "i8")
    tstack = params_from_numpy({"w": to_numpy_tree(jstack)})["w"]
    x = np.random.RandomState(4).randn(1, K).astype(np.float32)
    xt = torch.from_numpy(x)
    entry = mv.q4_matvec_expert if ftype == FloatType.Q40 else q8.q8_matvec_expert
    for e_lo in (0, EL):
        local = jax.tree_util.tree_map(lambda a: a[e_lo:e_lo + EL], jstack)
        tlocal = QTensor(tstack.ftype, tstack.data[e_lo:e_lo + EL].contiguous(),
                         tstack.scales[e_lo:e_lo + EL].contiguous(), tstack.layout)
        for e in WINDOW_INDICES:
            got = entry(xt, tlocal, torch.tensor([e]), e_lo=e_lo).numpy()
            want = _jax_owner_test(jnp.asarray(x), local, e, e_lo)
            if not e_lo <= e < e_lo + EL:
                assert not got.any() and not want.any(), (e_lo, e)  # exact zeros
                continue
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=f"window {e_lo}, expert {e}")
            # the window (0, E) is the one-card entry: bit for bit
            one_card = entry(xt, tstack, torch.tensor([e])).numpy()
            assert np.array_equal(got, one_card), (e_lo, e)


# --------------------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------------------

def test_cli_moe_sharding_expert_prints_the_tp1_text(worlds, moe_files, capsysbinary):
    dllama.main(_cli_args(moe_files))
    want = capsysbinary.readouterr().out.rstrip(b"\n").split(b"\n")[-1]
    rc, stdout, stderr = worlds["cli"]
    assert rc == 0, stderr.decode()[-2000:]
    assert stdout.rstrip(b"\n").split(b"\n")[-1] == want
    assert b"tp=2 over gloo, Q80 wire, experts whole over tp" in stdout


def test_cli_moe_sharding_argument_checks(moe_files):
    """--moe-sharding takes slice or expert, in dllama and api_server alike; expert
    needs --tp to divide the model's experts (JAX's message), checked before any rank
    starts; slice and tp = 1 pass."""
    args = dllama.build_parser().parse_args(_cli_args(moe_files, "--tp", "2",
                                                      "--moe-sharding", "expert"))
    assert args.moe_sharding == "expert"
    dllama.check_tp(args)
    args = dllama.build_parser().parse_args(_cli_args(moe_files, "--tp", "3",
                                                      "--moe-sharding", "expert"))
    with pytest.raises(ValueError, match="expert sharding: tp=3 must divide n_experts=4"):
        dllama.check_tp(args)
    args.moe_sharding = "slice"
    dllama.check_moe_layout(args)
    assert dllama.build_parser().parse_args(_cli_args(moe_files)).moe_sharding == "slice"
    with pytest.raises(SystemExit):
        dllama.build_parser().parse_args(_cli_args(moe_files, "--moe-sharding", "rows"))
    srv = api_server.build_parser().parse_args(
        ["--model", moe_files[0], "--tokenizer", moe_files[1], "--tp", "2",
         "--moe-sharding", "expert"])
    assert srv.moe_sharding == "expert"
    assert api_server.engine_kwargs(srv)["moe_sharding"] == "expert"
