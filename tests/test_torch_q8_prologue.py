"""PyTorch port: the int8-plane (i8) layout, Q80 weights and the fused activation
prologue on single-sequence decode, against the JAX package on the same seeded inputs.
The JAX side runs its Pallas kernels in interpret mode (use_pallas=True), the regime in
which the q8 matvec and the prologue exist; the port runs its kernels' plain versions.

Tolerances:
- i8 planes and scales, prepare_for_cuda against prepare_for_pallas: byte-identical;
- the matvecs (q8_matvec int8 and precise, q8_matvec_q80, q4_matvec_q80): rtol 1e-5
  plus atol 1e-5·max|y| (exact integer block dots, or f32 block sums of identical
  products; the f32 sum over blocks in another order);
- the prologue: xq exactly equal, sx within rtol 1e-6;
- qmatmul with kernels on against JAX qmatmul(use_pallas=True): 1e-5·max|y|;
- forward with the prologue: logits within 1e-4·max|logits|, identical argmax;
- Engine: identical tokens, greedy and seeded-stochastic.
"""

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
from distributed_llama_tpu.models.spec import ArchType, ModelSpec, RopeType
from distributed_llama_tpu.ops.matmul import qmatmul as j_qmatmul
from distributed_llama_tpu.ops.pallas_prologue import quantize_q80_row as j_quantize
from distributed_llama_tpu.ops.pallas_prologue import rmsnorm_quantize_q80 as j_rmsnorm_q80
from distributed_llama_tpu.ops.pallas_q4 import _q4_matvec_inline
from distributed_llama_tpu.ops.pallas_q8 import (_expand_f32, _expand_q80, _q8_matvec,
                                                 _q8_matvec_inline)
from distributed_llama_tpu.ops.rope import RopeTables as JRope
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.quants import QTensor as JQTensor
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.models import forward as tfwd
from distributed_llama_tpu_torch.models.params import params_from_numpy, prepare_for_cuda
from distributed_llama_tpu_torch.models.spec import ArchType as TArch
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.ops import matmul as tmatmul
from distributed_llama_tpu_torch.ops import prologue as tpro
from distributed_llama_tpu_torch.ops import prologue_plan as tplan
from distributed_llama_tpu_torch.ops import q4_matvec as tmv
from distributed_llama_tpu_torch.ops import q8_matvec as tq8
from distributed_llama_tpu_torch.ops.rope import RopeTables as TRope
from distributed_llama_tpu_torch.quants import FloatType as TFloatType
from distributed_llama_tpu_torch.quants import QTensor as TQTensor
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

from test_torch_forward import to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_prologue.py::_spec, and the same at dim 96 (K % 64 != 0: Q40 goes to i8)
_KW = dict(hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
           seq_len=16)


def _specs(dim):
    return (ModelSpec(arch_type=ArchType.LLAMA, dim=dim, rope_type=RopeType.LLAMA,
                      **_KW).resolved(),
            TSpec(arch_type=TArch.LLAMA, dim=dim, **_KW).resolved())


def _close_scaled(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def _tq(jq: JQTensor) -> TQTensor:
    leaf = to_numpy_tree({"w": jq})["w"]
    return params_from_numpy({"w": leaf})["w"]


def _jweight(n, k, ftype, seed):
    rng = np.random.RandomState(seed)
    return JQTensor.from_float(rng.randn(n, k).astype(np.float32) * 0.02, ftype)


@pytest.mark.parametrize("ftype", [FloatType.Q40, FloatType.Q80])
def test_i8_planes_byte_identical_to_jax(ftype):
    jw = _jweight(40, 96, ftype, seed=int(ftype))
    want = jw.to_i8_layout()
    got = _tq(jw).to_i8_layout()
    assert got.layout == "i8" and got.shape == (40, 96) == want.shape
    assert got.data.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(got.dequantize(torch.bfloat16).float().numpy(),
                                  np.asarray(want.dequantize(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("dim,ftype,fuse", [(64, FloatType.Q40, True),
                                            (96, FloatType.Q40, True),
                                            (64, FloatType.Q80, True),
                                            (96, FloatType.Q80, False)])
def test_prepare_for_cuda_matches_prepare_for_pallas(dim, ftype, fuse):
    jspec, _ = _specs(dim)
    jp = init_random_params(jspec, ftype, seed=dim)
    want = to_numpy_tree(prepare_for_pallas(jp, spec=jspec, fuse=fuse))
    got = prepare_for_cuda(params_from_numpy(to_numpy_tree(jp)), fuse=fuse)
    assert sorted(got["blocks"]) == sorted(want["blocks"])
    leaves = [(got["wcls"], want["wcls"])] + [(got["blocks"][n], want["blocks"][n])
                                               for n in want["blocks"]]
    for g, w in leaves:
        if not isinstance(w, dict) or "ftype" not in w:
            np.testing.assert_array_equal(g.numpy(), w)
            continue
        assert (g.layout, g.groups, g.row_groups) == (w["layout"], w["groups"],
                                                      w["row_groups"])
        np.testing.assert_array_equal(g.data.numpy(), w["data"])
        scales = w["scales"].view(np.float16) if w["layout"] == "i4p" else w["scales"]
        np.testing.assert_array_equal(g.scales.numpy(), scales)
    layouts = {w["layout"] for _, w in leaves if isinstance(w, dict) and "ftype" in w}
    # Q40 at K % 64 == 0 packs to i4p (dim 96: w2, whose K is hidden_dim 128)
    assert layouts == {FloatType.Q80: {"i8"}, 64: {"i4p"}, 96: {"i4p", "i8"}}[
        FloatType.Q80 if ftype == FloatType.Q80 else dim]
    # weights already in a kernel layout are left as they are
    again = prepare_for_cuda(got, fuse=fuse)
    assert all(again["blocks"][n] is got["blocks"][n] for n in got["blocks"])


def _row(k, seed, zero_block=True):
    x = np.random.RandomState(seed).randn(1, k).astype(np.float32)
    if zero_block:
        x[0, 32:64] = 0.0  # an all-zero block quantizes to zeros with a zero scale
    return x


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n,k", [(48, 96), (200, 256)])
def test_q8_matvec_plain_matches_pallas(n, k, precise):
    jw = _jweight(n, k, FloatType.Q80, seed=n).to_i8_layout()
    x = _row(k, seed=k)
    expand = _expand_f32 if precise else _expand_q80
    xexp, sx = expand(jnp.asarray(x[0]), k // 32)
    want = _q8_matvec(xexp, sx, jw.data, jw.scales, interpret=True, precise=precise)
    before = (tq8.launches, tq8.precise_launches)
    got = tq8.q8_matvec(torch.from_numpy(x), _tq(jw), precise=precise)
    assert got.shape == (1, n) and (tq8.launches, tq8.precise_launches) == before
    _close_scaled(got.numpy()[0], np.asarray(want)[:, 0])


@pytest.mark.parametrize("layout", ["i8", "i4p"])
def test_q80_matvecs_plain_match_inline_pallas(layout):
    n, k = 72, 256
    rng = np.random.RandomState(5)
    xq = rng.randint(-127, 128, (1, k)).astype(np.int8)
    xq[0, :32] = 0
    sx = (rng.rand(1, k // 32) * 0.01).astype(np.float32)
    sx[0, 0] = 0.0
    if layout == "i8":
        jw = _jweight(n, k, FloatType.Q40, seed=6).to_i8_layout()
        want = _q8_matvec_inline(jnp.asarray(xq), jnp.asarray(sx), jw.data, jw.scales,
                                 interpret=True)
        fn, counter = tq8.q8_matvec_q80, lambda: tq8.q80_launches
    else:
        jw = _jweight(n, k, FloatType.Q40, seed=6).to_i4p_layout()
        want = _q4_matvec_inline(jnp.asarray(xq), jnp.asarray(sx), jw.data, jw.scales,
                                 interpret=True)
        fn, counter = tmv.q4_matvec_q80, lambda: tmv.q80_launches
    before = counter()
    got = fn(torch.from_numpy(xq), torch.from_numpy(sx), _tq(jw))
    assert got.shape == (n,) and counter() == before
    _close_scaled(got.numpy(), np.asarray(want)[:, 0])


def _cluster_threshold(x_bf16):
    """The shortest row the port's rmsnorm_q80 kernel splits over a cluster of CTAs."""
    return next(k for k in range(32, tplan.MAX_K + 1, 32)
                if tplan.plan(k, x_bf16, True).ctas > 1)


# one block, small rows, and the rows beside each dtype's cluster threshold
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("k", [32, 64, 256, 352] + [
    _cluster_threshold(xb) + d for xb in (False, True) for d in (-32, 32)])
def test_prologue_plain_matches_pallas(k, dtype):
    x = _row(k, seed=k) * 3.0
    w = (1.0 + 0.1 * np.random.RandomState(k + 1).randn(k)).astype(np.float32)
    if dtype == "bfloat16":  # both sides widen the same bf16 values exactly
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    before = (tpro.rmsnorm_launches, tpro.quantize_launches)
    for got, want in ((tpro.rmsnorm_quantize_q80(xt, torch.from_numpy(w), 1e-5),
                       j_rmsnorm_q80(xj, jnp.asarray(w), 1e-5, interpret=True)),
                      (tpro.quantize_q80_row(xt), j_quantize(xj, interpret=True))):
        assert got[0].shape == (1, k) and got[1].shape == (1, k // 32)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=0)
        if k >= 64:  # the zero block
            assert got[1][0, 1] == 0.0 and (got[0][0, 32:64] == 0).all()
    assert (tpro.rmsnorm_launches, tpro.quantize_launches) == before
    assert tpro.prologue_supported(k) and not tpro.prologue_supported(k + 16)


@pytest.mark.parametrize("ftype,k", [(FloatType.Q40, 96), (FloatType.Q80, 64),
                                     (FloatType.Q80, 96)])
def test_qmatmul_kernel_route_matches_jax(ftype, k):
    """The fault this slice repairs: a Q40 weight with K % 64 != 0, and every Q80
    weight, took the dequantize path with an unquantized row under use_kernels=True
    (6.5e-3 relative off JAX at Q40 N=48, K=96); both now take q8_matvec on the i8
    planes, as JAX does."""
    jspec, _ = _specs(k)
    jw = prepare_for_pallas({"embedding": np.zeros((1, k), np.float32),
                             "rms_final": np.ones(k, np.float32), "blocks": {},
                             "wcls": _jweight(48, k, ftype, seed=k)}, spec=jspec)["wcls"]
    assert jw.layout == "i8"
    tw = prepare_for_cuda({"embedding": torch.zeros(1, k), "rms_final": torch.ones(k),
                           "blocks": {}, "wcls": _tq(_jweight(48, k, ftype, seed=k))})
    tw = tw["wcls"]
    x = np.random.RandomState(1).randn(1, 1, k).astype(np.float32)
    want = np.asarray(j_qmatmul(jnp.asarray(x), jw, use_pallas=True))
    tmatmul.reset_kernel_selections()
    got = tmatmul.qmatmul(torch.from_numpy(x), tw, use_kernels=True)
    assert tmatmul.kernel_selections() == {
        f"m=1,n=48,k={k},layout=i8,op=mm": "q8_matvec"}
    _close_scaled(got.numpy(), want)


def test_qmatmul_q80_routes():
    k = 128
    xq = torch.from_numpy(np.random.RandomState(2).randint(-127, 128, (1, k)).astype(
        np.int8))
    sx = torch.full((1, k // 32), 0.01)
    base = _tq(_jweight(24, k, FloatType.Q40, seed=3))
    # the dequantize route of a planar weight is the reference for the kernel routes
    want = tmatmul.qmatmul_q80(xq, sx, base, use_kernels=True)
    tmatmul.reset_kernel_selections()
    for w in (base.to_i4p_layout(), base.to_i8_layout()):
        y = tmatmul.qmatmul_q80(xq, sx, w, use_kernels=True)
        assert y.shape == (1, 1, 24) and y.dtype == torch.float32
        _close_scaled(y.numpy(), want.numpy())
    assert tmatmul.kernel_selections() == {
        "m=1,n=24,k=128,layout=i4p,op=q80": "q4_matvec_q80",
        "m=1,n=24,k=128,layout=i8,op=q80": "q8_matvec_q80"}
    tmatmul.qmatmul_q80(xq, sx, base.to_i8_layout(), use_kernels=False)
    assert tmatmul.kernel_selections()["m=1,n=24,k=128,layout=i8,op=q80"] == "dequant"


def _forward_pair(dim, ftype, seed):
    jspec, tspec = _specs(dim)
    jp = prepare_for_pallas(init_random_params(jspec, ftype, seed=seed), spec=jspec)
    return jspec, tspec, jp, params_from_numpy(to_numpy_tree(jp))


@pytest.mark.parametrize("dim,ftype", [(64, FloatType.Q40), (64, FloatType.Q80),
                                       (96, FloatType.Q40)])
def test_forward_prologue_matches_jax(dim, ftype):
    jspec, tspec, jp, tp = _forward_pair(dim, ftype, seed=29)
    jrope, trope = JRope.create(jspec), TRope.create(tspec)
    jk, jv = jfwd.init_kv_cache(jspec)
    tk, tv = tfwd.init_kv_cache(tspec)
    before = (tpro.rmsnorm_launches, tq8.q80_launches, tmv.q80_launches)
    for pos, tok in enumerate([5, 17, 3, 99]):
        jl, jk, jv = jfwd.forward(jp, jspec, jrope, jnp.asarray([[tok]]), jk, jv,
                                  jnp.int32(pos), use_pallas=True, fused_prologue=True,
                                  cache_write="deferred")
        tl, tk, tv = tfwd.forward(tp, tspec, trope, torch.tensor([[tok]]), tk, tv, pos,
                                  use_kernels=True, fused_prologue=True)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
    assert (tpro.rmsnorm_launches, tq8.q80_launches, tmv.q80_launches) == before


def test_forward_prologue_gate(monkeypatch):
    """The prologue applies only to one row of one token at a scalar start, with the
    kernels on; elsewhere forward runs as without it."""
    _, tspec, _, tp = _forward_pair(64, FloatType.Q80, seed=4)
    trope = TRope.create(tspec)
    calls = []
    orig = tfwd.rmsnorm_quantize_q80

    def rec(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(tfwd, "rmsnorm_quantize_q80", rec)
    for toks, kernels in (([[5, 6]], True), ([[5], [6]], True), ([[5]], False)):
        tk, tv = tfwd.init_kv_cache(tspec, batch=len(toks))
        start = 0 if len(toks) == 1 else torch.zeros(len(toks), dtype=torch.long)
        tfwd.forward(tp, tspec, trope, torch.tensor(toks), tk, tv, start,
                     use_kernels=kernels, fused_prologue=True)
    assert not calls
    tk, tv = tfwd.init_kv_cache(tspec)
    tfwd.forward(tp, tspec, trope, torch.tensor([[5]]), tk, tv, 0, use_kernels=True,
                 fused_prologue=True)
    assert len(calls) == 2 * tspec.n_layers


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_prologue_q80_token_identity_with_jax(temperature):
    jspec, tspec = _specs(64)
    jp = init_random_params(jspec, FloatType.Q80, seed=13)
    prompt = [1, 7, 3, 9, 11, 2, 4, 8, 5]  # chunks 8, 1
    jeng = JEngine(jspec, jp, tp=1, use_pallas=True, fused_prologue=True)
    want, _ = jeng.generate(prompt, 6, JSampler(128, temperature, 0.9, seed=5))
    eng = Engine(tspec, params_from_numpy(to_numpy_tree(jp)), device="cpu",
                 use_kernels=True, fused_prologue=True)
    assert eng.fused_prologue and eng.params["blocks"]["wqkv"].layout == "i8"
    got, _ = eng.generate(prompt, 6, Sampler(128, temperature, 0.9, seed=5))
    assert got == want


def test_engine_prologue_env(monkeypatch):
    _, tspec = _specs(64)
    params = params_from_numpy(to_numpy_tree(init_random_params(_specs(64)[0],
                                                                FloatType.Q80, seed=1)))
    for value, want in (("1", True), ("yes", True), ("0", False), ("", False)):
        monkeypatch.setenv("DLT_PROLOGUE", value)
        assert Engine(tspec, params, device="cpu").fused_prologue is want
    assert Engine(tspec, params, device="cpu", fused_prologue=False).fused_prologue is False


@pytest.fixture(scope="module")
def q80_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_q80")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=262, seq_len=64).resolved()
    params = init_random_params(spec, FloatType.Q80, seed=21)
    mpath = str(tmp / "model.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q80)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ", b"ab",
                                                                          b"cd"]
    tpath = str(tmp / "tok.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


def _cli(module, args) -> tuple[str, bytes]:
    """(the CLI's header lines, the generated bytes after the last spec line)."""
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                         capture_output=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr.decode("utf-8", "replace")[-2000:]
    head, _, text = res.stdout.partition("💡 seq_len: 64\n".encode())
    assert text, res.stdout[-500:]
    return head.decode("utf-8", "replace"), text


def test_cli_generate_prologue_q80_matches_jax_cli(q80_files):
    mpath, tpath = q80_files
    common = ["generate", "--model", mpath, "--tokenizer", tpath, "--steps", "8",
              "--temperature", "0", "--seed", "1", "--prompt", "ab cd", "--prologue"]
    _, want = _cli("distributed_llama_tpu.apps.dllama", [*common, "--tp", "1"])
    head, got = _cli("distributed_llama_tpu_torch.apps.dllama", [*common, "--device", "cpu"])
    assert "prologue=True" in head
    assert got == want and len(got) > 1


def test_q80_model_file_decodes_on_the_kernel_route(q80_files):
    mpath, tpath = q80_files
    eng = Engine.load(mpath, tpath, device="cpu", use_kernels=True, fused_prologue=True)
    assert all(t.layout == "i8" for n, t in eng.params["blocks"].items()
               if n in ("wqkv", "wo", "w13", "w2"))
    assert eng.params["wcls"].layout == "i8" and eng.params["wcls"].ftype == TFloatType.Q80
    before = (tq8.launches, tq8.q80_launches)
    out, _ = eng.generate([1, 260, 261], 4, Sampler(262, temperature=0.0))
    assert len(out) == 4 and (tq8.launches, tq8.q80_launches) == before  # plain on CPU


def test_api_server_prologue_flag(q80_files, capsys):
    """--prologue reaches the engine: the --batch 1 Engine takes it; at --batch 2 the
    BatchEngine warns that it is inert and serves as without it."""
    import json
    import threading
    import urllib.request

    from distributed_llama_tpu_torch.apps import api_server

    mpath, tpath = q80_files
    common = ["--model", mpath, "--tokenizer", tpath, "--device", "cpu", "--host",
              "127.0.0.1", "--port", "0", "--chat-template", "llama2", "--temperature",
              "0", "--prologue"]
    srv = api_server.build_server(api_server.build_parser().parse_args(
        [*common, "--batch", "1"]))
    assert srv.api_state.engine.fused_prologue
    srv.server_close()
    assert "inert" not in capsys.readouterr().err
    srv = api_server.build_server(api_server.build_parser().parse_args(
        [*common, "--batch", "2"]))
    be = srv.api_state.batch_engine
    assert "--prologue is inert with batched decode" in capsys.readouterr().err
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = {"messages": [{"role": "user", "content": "ab cd"}], "max_tokens": 4}
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/chat/completions",
            json.dumps(body).encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            payload = json.loads(r.read())
        assert r.status == 200
        assert payload["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        srv.shutdown()
        srv.server_close()
        be.close()
