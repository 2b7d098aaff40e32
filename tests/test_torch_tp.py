"""PyTorch port: tensor parallelism (distributed_llama_tpu_torch/parallel/) against the
JAX package's, on the CPU.

- Shards: each rank's slice of every tensor (parallel/tp.py shard_params after
  prepare_for_cuda(tp=)) equals the matching addressable shard of the JAX package's
  shard_params on the 8-device CPU mesh byte for byte: Q40 planar, i4p packed per tp
  column group (wo, w2, moe_down), fused wqkv / w13 / moe_gu with rows interleaved per tp
  group, Q80 int8 planes, KV-head replication. No world needed: a Mesh names the rank.
- The sharded forward over gloo worlds of 2 and 4 ranks (parallel/launch.py): a 5-token
  prefill and one decode step held against the JAX package's make_sharded_forward and
  its unsharded forward at tests/test_tp.py's atol 1e-4, rtol 1e-3, for Llama Q40,
  Mixtral and Grok-1 (slice mode), GQA at tp = n_kv_heads and KV replication at (tp,
  n_kv_heads) in {(4, 1), (4, 2)}; again with the kernels' plain versions on the i4p
  shard layouts (against JAX's Pallas kernels in interpret mode, sharded under shard_map
  and unsharded: both regimes quantize the decode activations to Q80); and
  with the Q80 wire, against JAX's compressed forward and within test_tp.py's 0.05 of
  the uncompressed logits with the same argmax.
- Engine(tp=2) on a tiny .m/.t pair: greedy and seeded tokens identical to the JAX
  Engine(tp=2) and to JAX tp=1, raw and on the Q80 wire; the counted bytes of one decode
  step equal collective_kbytes_per_token and JAX's collective_stats().
- `dllama generate --tp 2 --device cpu` prints --tp 1's text; inference mode prints the
  collectives line and the S/R columns; a failing rank fails the launcher and dllama; a
  --tp above the visible cards raises."""

import dataclasses
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models import forward as jfwd
from distributed_llama_tpu.models.params import init_random_params, prepare_for_pallas
from distributed_llama_tpu.models.spec import ArchType, HiddenAct, ModelSpec, RopeType
from distributed_llama_tpu.ops.rope import RopeTables as JRope
from distributed_llama_tpu.parallel import make_mesh as jmake_mesh
from distributed_llama_tpu.parallel import make_sharded_forward as jsharded
from distributed_llama_tpu.parallel import shard_params as jshard
from distributed_llama_tpu.parallel.tp import init_sharded_kv_cache as jinit_cache
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.quants import QTensor as JQTensor
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.engine import (
    collective_kbytes_per_token as jcollective_kbytes)
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.models.params import params_from_numpy, prepare_for_cuda
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.parallel import launch
from distributed_llama_tpu_torch.parallel.mesh import Mesh
from distributed_llama_tpu_torch.parallel.sharding import (check_divisibility,
                                                           effective_kv_heads,
                                                           param_split_axes)
from distributed_llama_tpu_torch.parallel.tp import shard_params
from distributed_llama_tpu_torch.quants import QTensor
from distributed_llama_tpu_torch.runtime.engine import Engine, collective_kbytes_per_token

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKS = [[1, 7, 23, 5, 9], [42]]  # a 5-token prefill, then one decode step


def tp_spec(arch=ArchType.LLAMA, **kw) -> ModelSpec:
    """tests/test_tp.py's spec."""
    defaults = dict(arch_type=arch, dim=256, hidden_dim=256, n_layers=2, n_heads=8,
                    n_kv_heads=8, vocab_size=256, seq_len=16, rope_type=RopeType.LLAMA)
    if arch != ArchType.LLAMA:
        defaults.update(n_experts=4, n_active_experts=2, rope_type=RopeType.FALCON)
    if arch == ArchType.GROK1:
        defaults.update(hidden_act=HiddenAct.GELU)
    defaults.update(kw)
    return ModelSpec(**defaults).resolved()


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
# shards, byte for byte
# --------------------------------------------------------------------------------------

def _bytes(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _jax_shard(arr, device) -> np.ndarray:
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


SHARD_CASES = {
    "q40_planar": (tp_spec(), FloatType.Q40, False),
    "q40_kernel_layouts": (tp_spec(), FloatType.Q40, True),
    "q80_int8_planes": (tp_spec(), FloatType.Q80, True),
    "kv_replication_planar": (tp_spec(n_kv_heads=2), FloatType.Q40, False),
    "kv_replication_kernel_layouts": (tp_spec(n_kv_heads=2), FloatType.Q40, True),
    "mixtral_kernel_layouts": (tp_spec(ArchType.MIXTRAL), FloatType.Q40, True),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_shards_equal_jax_shard_params_byte_for_byte(name, tp):
    spec, ftype, kernels = SHARD_CASES[name]
    jp = init_random_params(spec, ftype, seed=5)
    tparams = params_from_numpy(to_numpy_tree(jp))
    if kernels:
        jp = prepare_for_pallas(jp, tp, spec=spec)
        tparams = prepare_for_cuda(tparams, tp=tp, spec=port_spec(spec))
    jmesh = jmake_mesh(tp=tp)
    jsh = jshard(jp, jmesh, spec)
    devices = list(jmesh.devices.flat)
    seen_layouts = set()
    for r in range(tp):
        mesh = Mesh(rank=r, shape={"dp": 1, "sp": 1, "tp": tp}, group=None,
                    device=torch.device("cpu"))
        mine = shard_params(tparams, mesh, port_spec(spec))
        leaves = [("embedding", mine["embedding"], jsh["embedding"]),
                  ("rms_final", mine["rms_final"], jsh["rms_final"]),
                  ("wcls", mine["wcls"], jsh["wcls"])]
        leaves += [(k, v, jsh["blocks"][k]) for k, v in mine["blocks"].items()]
        assert set(mine["blocks"]) == set(jsh["blocks"])
        for key, t, j in leaves:
            if isinstance(t, QTensor):
                assert (t.ftype, t.layout, t.row_groups) == (int(j.ftype), j.layout,
                                                             j.row_groups), key
                assert t.groups == 1, key  # a rank's i4p shard is one whole pack
                seen_layouts.add((t.layout, j.groups, j.row_groups))
                pairs = [(t.data, j.data), (t.scales, j.scales)]
            else:
                pairs = [(t, j)]
            for a, b in pairs:
                if a is None:
                    assert b is None, key
                    continue
                np.testing.assert_array_equal(_bytes(a), _bytes(_jax_shard(b, devices[r])),
                                              err_msg=f"{name} rank {r} {key}")
    if kernels and ftype == FloatType.Q40:
        assert ("i4p", tp, 1) in seen_layouts  # the column-group packs
    if name in ("q40_kernel_layouts", "q80_int8_planes", "mixtral_kernel_layouts"):
        assert any(rg == tp for _, _, rg in seen_layouts)  # the fused interleaves


def test_replicated_kv_rows_and_split_axes():
    spec = tp_spec(n_kv_heads=2)
    assert effective_kv_heads(port_spec(spec), 4) == 4
    assert effective_kv_heads(port_spec(spec), 2) == 2
    axes = param_split_axes({"blocks": {"wo": None, "w2": None, "wqkv": None,
                                        "router": None, "rms_att": None}})
    assert axes["blocks"] == {"wo": 2, "w2": 2, "wqkv": 1, "router": None, "rms_att": None}
    assert axes["wcls"] == 0 and axes["embedding"] is None
    expert = param_split_axes({"blocks": {"moe_down": None}}, "expert")
    assert expert["blocks"]["moe_down"] == 1
    mesh = Mesh(rank=0, shape={"dp": 1, "sp": 1, "tp": 2}, group=None,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="Queue A item 3"):
        shard_params({"blocks": {}}, mesh, moe_sharding="expert")


def test_divisibility_errors_without_a_world():
    """tests/test_tp.py's tp=8 against n_kv_heads=3 (n_heads=24 keeps n_heads % tp ==
    0, so only the replication guard can fire), and the other checks."""
    spec = port_spec(tp_spec(n_heads=24, n_kv_heads=3, dim=768, hidden_dim=768))
    with pytest.raises(ValueError, match="n_kv_heads"):
        check_divisibility(spec, 8)
    with pytest.raises(ValueError, match="n_heads"):
        check_divisibility(port_spec(tp_spec(n_heads=6, n_kv_heads=2, dim=192)), 4)
    with pytest.raises(ValueError, match="32-wide quant blocks"):
        check_divisibility(port_spec(tp_spec(dim=64 * 3, n_heads=8 * 3, n_kv_heads=8 * 3)),
                           4)
    with pytest.raises(ValueError, match="hidden_dim"):
        check_divisibility(port_spec(tp_spec(hidden_dim=260)), 8)
    check_divisibility(port_spec(tp_spec()), 8)


def test_fused_groups_must_carry_the_meshs_interleave():
    spec = tp_spec()
    tparams = params_from_numpy(to_numpy_tree(init_random_params(spec, FloatType.Q40,
                                                                 seed=1)))
    one_card = prepare_for_cuda(tparams, spec=port_spec(spec))
    mesh = Mesh(rank=0, shape={"dp": 1, "sp": 1, "tp": 2}, group=None,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="row interleave 1"):
        shard_params(one_card, mesh, port_spec(spec))
    # regrouped for tp=2: the one-card layouts give the tp-prepared shards exactly
    again = prepare_for_cuda(one_card, tp=2, spec=port_spec(spec))
    want = shard_params(prepare_for_cuda(tparams, tp=2, spec=port_spec(spec)), mesh,
                        port_spec(spec))
    got = shard_params(again, mesh, port_spec(spec))
    for k, t in want["blocks"].items():
        if isinstance(t, QTensor):
            assert torch.equal(got["blocks"][k].data, t.data), k
            assert torch.equal(got["blocks"][k].scales, t.scales), k


# --------------------------------------------------------------------------------------
# the sharded forward on gloo worlds
# --------------------------------------------------------------------------------------

# name -> (tp, spec, weights, kernels, compress)
FORWARD_CASES = {
    "llama_q40_tp2": (2, tp_spec(), FloatType.Q40, False, False),
    "llama_q40_kernels_tp2": (2, tp_spec(), FloatType.Q40, True, False),
    "gqa_tp2_eq_kv_heads": (2, tp_spec(n_kv_heads=2), FloatType.Q40, False, False),
    "llama_q40_q80_wire_tp2": (2, tp_spec(), FloatType.Q40, False, True),
    "llama_q40_tp4": (4, tp_spec(), FloatType.Q40, False, False),
    "mixtral_tp4": (4, tp_spec(ArchType.MIXTRAL), FloatType.Q40, False, False),
    "grok1_tp4": (4, tp_spec(ArchType.GROK1), FloatType.Q40, False, False),
    "gqa_tp4_eq_kv_heads": (4, tp_spec(n_kv_heads=4), FloatType.F32, False, False),
    "kv_replication_tp4_hk1": (4, tp_spec(n_kv_heads=1), FloatType.Q40, False, False),
    "kv_replication_tp4_hk2": (4, tp_spec(n_kv_heads=2), FloatType.Q40, False, False),
    "kv_replication_kernels_tp4_hk2": (4, tp_spec(n_kv_heads=2), FloatType.Q40, True,
                                       False),
    "mixtral_kernels_tp4": (4, tp_spec(ArchType.MIXTRAL), FloatType.Q40, True, False),
    "llama_q40_q80_wire_tp4": (4, tp_spec(), FloatType.Q40, False, True),
}


def _weights(spec, ftype):
    return init_random_params(spec, ftype, seed=11)


def _jax_logits(spec, params, tp, kernels=False, compress=False):
    """The JAX package's logits of every chunk: make_sharded_forward at tp (tp=None:
    the unsharded forward)."""
    rope = JRope.create(spec)
    outs, pos = [], 0
    if tp is None:
        if kernels:
            params = prepare_for_pallas(params, 1, spec=spec)
        kc, vc = jfwd.init_kv_cache(spec)
        for chunk in CHUNKS:
            lg, kc, vc = jfwd.forward(params, spec, rope, jnp.asarray([chunk]), kc, vc,
                                      jnp.int32(pos), cache_write="deferred",
                                      use_pallas=kernels)
            outs.append(np.asarray(lg)[0])
            pos += len(chunk)
        return outs
    mesh = jmake_mesh(tp=tp)
    if kernels:
        params = prepare_for_pallas(params, tp, spec=spec)
    sharded = jshard(params, mesh, spec)
    kc, vc = jinit_cache(spec, mesh)
    step = jsharded(spec, mesh, sharded, donate_cache=False, use_pallas=kernels,
                    compress_collectives=compress, cache_write="deferred")
    for chunk in CHUNKS:
        lg, kc, vc = step(sharded, rope, jnp.asarray([chunk]), kc, vc, jnp.int32(pos))
        outs.append(np.asarray(lg)[0])
        pos += len(chunk)
    return outs


@pytest.fixture(scope="module")
def forward_worlds(tmp_path_factory):
    """Every forward case, one launch per world size."""
    results = {}
    for tp in (2, 4):
        names = [n for n, c in FORWARD_CASES.items() if c[0] == tp]
        cases = []
        for n in names:
            _, spec, ftype, kernels, compress = FORWARD_CASES[n]
            cases.append({"spec": dataclasses.asdict(port_spec(spec)),
                          "params": to_numpy_tree(_weights(spec, ftype)),
                          "use_kernels": kernels, "compress": compress,
                          "chunks": CHUNKS})
        tmp = tmp_path_factory.mktemp(f"fwd{tp}")
        torch.save(cases, tmp / "cases.pt")
        ranks = launch.run("torch_tp_ranks:forward_cases", tp, "cpu",
                           args=(str(tmp / "cases.pt"),), workdir=str(tmp), deadline=240)
        for i, n in enumerate(names):
            results[n] = {"logits": ranks[0][i]["logits"],
                          "kv_heads": [r[i]["kv_heads"] for r in ranks]}
    return results


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_sharded_forward_matches_jax(forward_worlds, name):
    tp, spec, ftype, kernels, compress = FORWARD_CASES[name]
    params = _weights(spec, ftype)
    got = forward_worlds[name]["logits"]
    assert forward_worlds[name]["kv_heads"] == [effective_kv_heads(spec, tp) // tp] * tp
    if compress:
        # the Q80 wire: within test_tp.py's bound of the uncompressed logits, the same
        # argmax; against JAX's compressed forward (the same wire, bit-identical
        # collectives) within one Q80 step of a reduced activation: a partial sum that
        # differs from XLA's in its last bit can round one wire value across a code
        # boundary, moving it by one step (<= |x|max/127 of its block)
        plain = _jax_logits(spec, params, tp)
        want = _jax_logits(spec, params, tp, compress=True)
        for g, p, w in zip(got, plain, want):
            assert np.max(np.abs(g - p)) < 0.05
            assert np.array_equal(np.argmax(g, -1), np.argmax(p, -1))
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-3)
        return
    for against in (tp, None):
        want = _jax_logits(spec, params, against, kernels=kernels)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3,
                                       err_msg=f"against JAX at tp={against}")
            assert np.array_equal(np.argmax(g, -1), np.argmax(w, -1))


# --------------------------------------------------------------------------------------
# the Engine, its traffic, the CLI
# --------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tp_engine")
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
ENGINE_CASES = ((False, 0.0, 77), (False, 0.8, 77), (True, 0.0, 77), (True, 0.8, 5))
_JAX_ENGINES: dict = {}


def _jax_engine(mpath, tpath, tp, compress=False):
    """The JAX engines, loaded (and compiled) once a module, reset before each use."""
    key = (mpath, tp, compress)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JEngine.load(mpath, tpath, tp=tp, compress_collectives=compress)
    eng = _JAX_ENGINES[key]
    eng.reset()
    return eng


@pytest.fixture(scope="module")
def engine_world(model_files, tmp_path_factory):
    mpath, tpath = model_files
    tmp = tmp_path_factory.mktemp("eng2")
    ranks = launch.run("torch_tp_ranks:engine_cases", 2, "cpu",
                       args=(mpath, tpath, PROMPT, ENGINE_CASES), workdir=str(tmp),
                       deadline=240)
    return ranks


@pytest.mark.parametrize("case", range(len(ENGINE_CASES)))
def test_engine_tp2_tokens_match_jax_engines(model_files, engine_world, case):
    mpath, tpath = model_files
    compress, temperature, seed = ENGINE_CASES[case]
    got = [r[case]["tokens"] for r in engine_world]
    assert got[0] == got[1]  # the ranks decode one sequence
    jeng = _jax_engine(mpath, tpath, 2, compress)
    want, _ = jeng.generate(PROMPT, 8, JSampler(262, temperature, 0.9, seed=seed))
    assert got[0] == want
    if not compress:
        one, _ = _jax_engine(mpath, tpath, 1).generate(
            PROMPT, 8, JSampler(262, temperature, 0.9, seed=seed))
        assert got[0] == one


@pytest.mark.parametrize("compress", [False, True])
def test_counted_traffic_equals_model_and_jax_collective_stats(model_files, engine_world,
                                                               compress):
    mpath, tpath = model_files
    case = [c[0] for c in ENGINE_CASES].index(compress)
    spec = Engine.load(mpath, tpath, device="cpu").spec
    model = collective_kbytes_per_token(spec, 2, compress) * 1024.0
    assert model == jcollective_kbytes(spec, 2, compress) * 1024.0
    measured = _jax_engine(mpath, tpath, 2, compress).collective_stats(
    ).sent_bytes_per_device
    for r in engine_world:
        row = r[case]
        assert row["sent"] == model
        assert row["sent"] == pytest.approx(measured, rel=1e-9)
        assert row["source"] == "measured" and row["kb"] == model / 1024.0
        want = ({"all-to-all": 2 * spec.n_layers, "all-gather": 2 * spec.n_layers + 1}
                if compress else {"all-reduce": 2 * spec.n_layers, "all-gather": 1})
        assert row["counts"] == want


def test_engine_refuses_what_tp_cannot_run():
    with pytest.raises(ValueError, match="Queue A item 1"):
        Engine._refuse_under_tp(batch=2)
    with pytest.raises(ValueError, match="single-card"):
        Engine._refuse_under_tp(kv_cache_storage="host")
    for flag in ("device_loop", "speculative"):
        with pytest.raises(ValueError, match="Queue A item 1"):
            Engine._refuse_under_tp(**{flag: True})
    with pytest.raises(RuntimeError, match="process group"):
        Engine(port_spec(tp_spec()), {"blocks": {}}, device="cpu", tp=2)


def _dllama(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama",
                           *args], cwd=REPO, capture_output=True, timeout=timeout)


def test_cli_tp2_prints_the_tp1_text(model_files, capsysbinary):
    mpath, tpath = model_files
    common = ["--model", mpath, "--tokenizer", tpath, "--steps", "10", "--device", "cpu",
              "--temperature", "0", "--seed", "1", "--prompt", "ab cd ab"]
    dllama.main(["generate", *common])
    want = capsysbinary.readouterr().out.rstrip(b"\n").split(b"\n")[-1]
    res = _dllama("generate", *common, "--tp", "2")  # the Q80 wire, the CLI's default
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out = res.stdout.rstrip(b"\n").split(b"\n")
    assert out[-1] == want
    assert sum(b"Loaded model" in line for line in out) == 1  # only rank 0 prints
    assert b"tp=2 over gloo, Q80 wire" in res.stdout
    res = _dllama("inference", *common, "--tp", "2", "--buffer-float-type", "f32")
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    text = res.stdout.decode("utf-8", "replace")
    assert "🔷 Collectives/step: all-gatherx1 all-reducex4" in text
    assert text.count("🔶 G") == 10 and " kB R " in text
    assert "S/R source:          measured per-device ring bytes" in text


def test_cli_chat_tp2_reads_the_console_on_rank_0(model_files, monkeypatch, capsysbinary):
    """`dllama chat --tp 2`: the launching process forwards the console to rank 0, which
    hands each line to rank 1; the turn (the tiny model's 64 positions hold one) answers
    as --tp 1's does, and the console's end ends the chat."""
    mpath, tpath = model_files
    args = ["chat", "--model", mpath, "--tokenizer", tpath, "--device", "cpu",
            "--temperature", "0", "--seed", "1", "--chat-template", "llama2"]
    console = "be brief\nab cd\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(console))
    dllama.main(args)
    outs = [capsysbinary.readouterr().out]
    res = subprocess.run([sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama",
                          *args, "--tp", "2"], cwd=REPO, input=console.encode(),
                         capture_output=True, timeout=240)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    outs.append(res.stdout)
    outs = [o.split(b"Loaded model", 1)[1].split(b"\n", 1)[1] for o in outs]
    assert outs[0].count(b"Assistant") == 1 and b"User" in outs[0]
    assert outs[1] == outs[0]


def test_a_failing_rank_fails_the_job(tmp_path, model_files):
    with pytest.raises(launch.RankFailed, match="exited with code"):
        launch.run("torch_tp_ranks:fail_on_rank_one", 2, "cpu", workdir=str(tmp_path),
                   timeout=60, deadline=120)
    with pytest.raises(launch.RankFailed, match="did not finish within"):
        launch.run("torch_tp_ranks:sleep_forever", 2, "cpu", deadline=3)
    mpath, tpath = model_files
    with pytest.raises(SystemExit, match="exited with code"):
        dllama.main(["generate", "--model", mpath + ".missing", "--tokenizer", tpath,
                     "--device", "cpu", "--tp", "2", "--steps", "2"])


def test_tp_above_the_visible_cards_raises(model_files):
    mpath, tpath = model_files
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        dllama.main(["generate", "--model", mpath, "--tokenizer", tpath, "--tp",
                     str(max(n + 1, 2))])
    assert dllama.rank_devices("cuda:0", n + 1) == ["cuda:0"] * (n + 1)
    assert dllama.rank_devices("cpu", 2) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="Queue A item 1"):
        dllama.main(["generate", "--model", mpath, "--tokenizer", tpath, "--tp", "2",
                     "--device", "cpu", "--device-loop", "4"])
    r = launch.run("torch_tp_ranks:ranks_and_devices", 2, "cpu")
    assert r == [(0, 2, "cpu", "gloo"), (1, 2, "cpu", "gloo")]
