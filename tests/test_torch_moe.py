"""PyTorch port: the MoE forward (Mixtral, Grok-1) against the JAX package on tiny models
(E = 4 experts, k = 2, 2 layers) with weights made from a seed and carried across with
params_from_numpy, in the three numerics regimes of tests/test_torch_forward.py:

- use_kernels=False vs use_pallas=False: f32 dequantize + product everywhere;
- use_kernels=True (the kernels' plain versions on the CPU) vs use_pallas=True (the
  Pallas kernels in interpret mode): the decode step's experts through the matvecs'
  expert entries, Q80 activations;
- use_kernels="all" vs use_pallas="all" at dim and hidden 256 (K/2 = 128 passes the
  dequant-matmul's gate): the prefill chunk's expert-major loop through q4_matmul.

Logits within atol 1e-4 with identical argmax at every step, Q40 and Q80, on weight
seeds 3 and 4. An activation whose last bit differs from the JAX one (sum order) can
land on the other side of a Q80 rounding boundary in the row a matvec quantizes, and
move every logit of that step (tests/test_torch_forward.py). So each step also counts
the Q80 codes of the two forwards' matvec rows that differ (`_MatvecRows`), and a step
with one or more gets atol FLIP_ATOL: with seed 3, Mixtral's first decode step in the
"all" regime has one code of layer 1's first expert down row and, downstream, two of
the logits row differing, and its logits 1.6e-3 apart; every other step of every case
here counts none and stays within 1e-4. Besides: each branch gate of the MoE FFN against
the JAX package's, the router's tie rule, the expert entries' plain versions against
slice-then-2-D-entry, the weights prepared for the kernels byte for byte, the decode
bytes of a token, and the Engine, the BatchEngine and the CLI on `.m`/`.t` files the
port's writers produced, token for token with the JAX engines."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models import forward as jfwd
from distributed_llama_tpu.models import params as jparams
from distributed_llama_tpu.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu.ops.rope import RopeTables as JRope
from distributed_llama_tpu.quants import FloatType as JFloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.formats.mfile import params_file_order, write_model
from distributed_llama_tpu_torch.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu_torch.models import forward as tfwd
from distributed_llama_tpu_torch.models import params as tparams
from distributed_llama_tpu_torch.models.spec import ArchType as TArch
from distributed_llama_tpu_torch.models.spec import HiddenAct as TAct
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.models.spec import RopeType as TRopeType
from distributed_llama_tpu_torch.ops import matmul as tmm
from distributed_llama_tpu_torch.ops import q4_matvec as mv
from distributed_llama_tpu_torch.ops import q8_matvec as q8
from distributed_llama_tpu_torch.ops.rope import RopeTables as TRope
from distributed_llama_tpu_torch.quants import FloatType, QTensor
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler
from test_torch_forward import to_numpy_tree

V = 262
ARCHS = ("mixtral", "grok1")
# a prefill chunk of 8 (the expert-major loop: 8·2 > 4), one of 2 (the gather: 2·2 <= 4)
# and four decode steps
CHUNKS = [[1, 7, 9, 30, 200, 5, 6, 8], [17, 40], [99], [3], [120], [66]]


def _specs(arch: str, dim: int = 64, hidden: int = 128, n_experts: int = 4):
    """The JAX package's and the port's spec of one tiny MoE model, k = 2."""
    kw = dict(dim=dim, hidden_dim=hidden, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=V, seq_len=64, n_experts=n_experts, n_active_experts=2)
    if arch == "grok1":
        return (ModelSpec(arch_type=ArchType.GROK1, hidden_act=HiddenAct.GELU,
                          **kw).resolved(),
                TSpec(arch_type=TArch.GROK1, hidden_act=TAct.GELU, **kw).resolved())
    return (ModelSpec(arch_type=ArchType.MIXTRAL, **kw).resolved(),
            TSpec(arch_type=TArch.MIXTRAL, **kw).resolved())


FLIP_ATOL = 5e-3


class _MatvecRows:
    """The float rows both forwards hand their one-row matvecs (which quantize them to
    Q80 inside), in call order: the JAX package's through an ordered debug callback
    (its layers run in a scan), the port's from its calls."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        jq, tq = jfwd.qmatmul, tfwd.qmatmul

        def j(x, w, **kw):
            if kw.get("use_pallas") and math.prod(x.shape[:-1]) == 1:
                jax.debug.callback(lambda v: self.jax.append(
                    np.array(v, np.float32).reshape(-1)), x, ordered=True)
            return jq(x, w, **kw)

        def t(x, w, **kw):
            if kw.get("use_kernels") and math.prod(x.shape[:-1]) == 1:
                self.port.append(x.detach().float().reshape(-1).numpy().copy())
            return tq(x, w, **kw)
        monkeypatch.setattr(jfwd, "qmatmul", j)
        monkeypatch.setattr(tfwd, "qmatmul", t)

    def flips(self) -> int:
        """Q80 codes that differ between the two forwards' rows since the last call."""
        jax.effects_barrier()
        a, b, self.jax, self.port = self.jax, self.port, [], []
        assert [r.shape for r in a] == [r.shape for r in b]
        return sum(int((mv.quantize_row(torch.from_numpy(x))[0]
                        != mv.quantize_row(torch.from_numpy(y))[0]).sum())
                   for x, y in zip(a, b))


def _run_both(jp, tp, jspec, tspec, jpol, tpol, chunks=CHUNKS, prologue=False,
              rows=None):
    """Each chunk through both forwards; the logits within atol 1e-4 with the same
    argmax — within FLIP_ATOL at a step where `rows` counts a Q80 code that differs."""
    jrope, trope = JRope.create(jspec), TRope.create(tspec)
    jk, jv = jfwd.init_kv_cache(jspec)
    tk, tv = tfwd.init_kv_cache(tspec)
    pos = 0
    for chunk in chunks:
        jl, jk, jv = jfwd.forward(jp, jspec, jrope, jnp.asarray([chunk]), jk, jv,
                                  jnp.int32(pos), use_pallas=jpol, cache_write="deferred",
                                  fused_prologue=prologue)
        tl, tk, tv = tfwd.forward(tp, tspec, trope, torch.tensor([chunk]), tk, tv, pos,
                                  use_kernels=tpol, fused_prologue=prologue)
        jl = np.asarray(jl)
        flips = rows.flips() if rows is not None else 0
        np.testing.assert_allclose(tl.numpy(), jl, atol=FLIP_ATOL if flips else 1e-4,
                                   rtol=0, err_msg=f"{flips} Q80 codes differ")
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
        pos += len(chunk)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ftype", [JFloatType.Q40, JFloatType.Q80])
@pytest.mark.parametrize("regime", ["dequant", "kernels", "all", "prologue"])
@pytest.mark.parametrize("seed", [3, 4])
def test_moe_forward_matches_jax(monkeypatch, arch, ftype, regime, seed):
    """`prologue`: the kernel regime with the fused prologue on, which applies to the
    attention only (Grok-1's wo exit takes no residual)."""
    wide = regime == "all"
    jspec, tspec = _specs(arch, *((256, 256) if wide else (64, 128)))
    jp = jparams.init_random_params(jspec, ftype, seed=seed)
    policy = {"dequant": False, "kernels": True, "all": "all", "prologue": True}[regime]
    if policy:
        jp = jparams.prepare_for_pallas(jp, spec=jspec)
        want = "i4p" if ftype == JFloatType.Q40 else "i8"
        assert jp["blocks"]["moe_gu"].layout == jp["blocks"]["moe_down"].layout == want
    tp = tparams.params_from_numpy(to_numpy_tree(jp))
    tmm.reset_kernel_selections()
    _run_both(jp, tp, jspec, tspec, policy, policy, prologue=regime == "prologue",
              rows=_MatvecRows(monkeypatch))
    routes = set(tmm.kernel_selections().values())
    if regime == "prologue":
        assert ("q4_matvec_q80" if ftype == JFloatType.Q40 else "q8_matvec_q80") in routes
    if regime in ("kernels", "prologue"):
        assert ("q4_matvec_expert" if ftype == JFloatType.Q40 else "q8_matvec_expert") in routes
    if regime == "all" and ftype == JFloatType.Q40:
        assert {"q4_mm", "q4_matvec_expert"} <= routes


@pytest.mark.parametrize("arch,atol,rtol", [(ArchType.MIXTRAL, 2e-4, 1e-3),
                                            (ArchType.GROK1, 3e-4, 2e-3)])
def test_moe_golden_against_the_numpy_oracle(arch, atol, rtol):
    """The port's forward on F32 weights against tests/test_forward.py's numpy oracle
    (written against the reference's math), at the JAX package's golden tolerances."""
    from test_forward import oracle_forward, tiny_spec

    jspec = tiny_spec(arch=arch)
    tspec = TSpec(**{**jspec.__dict__, "arch_type": TArch(int(jspec.arch_type)),
                     "hidden_act": TAct(int(jspec.hidden_act)),
                     "rope_type": TRopeType(int(jspec.rope_type))})
    jp = jparams.init_random_params(jspec, JFloatType.F32, seed=3)
    tokens = np.arange(1, 6, dtype=np.int32)
    want = oracle_forward(jp, jspec, tokens)
    tk, tv = tfwd.init_kv_cache(tspec)
    got, _, _ = tfwd.forward(tparams.params_from_numpy(to_numpy_tree(jp)), tspec,
                             TRope.create(tspec), torch.from_numpy(tokens[None].astype(
                                 np.int64)), tk, tv, 0)
    np.testing.assert_allclose(got[0].numpy(), want, atol=atol, rtol=rtol)


def test_params_from_numpy_carries_the_prepared_moe_tree():
    """A JAX-prepared Mixtral tree keeps its merged [up | gate] stack, its layouts and its
    bytes across params_from_numpy, and prepare_for_cuda of the planar tree gives the
    same bytes as prepare_for_pallas."""
    jspec, tspec = _specs("mixtral", 128, 128)
    raw = jparams.init_random_params(jspec, JFloatType.Q40, seed=5)
    jp = jparams.prepare_for_pallas(raw, spec=jspec)
    tp = tparams.params_from_numpy(to_numpy_tree(jp))
    gu = tp["blocks"]["moe_gu"]
    assert gu.layout == "i4p" and tuple(gu.data.shape) == (2, 4, 256, 64)
    assert tp["blocks"]["router"].layout == "planar"
    planar = tparams.params_from_numpy(to_numpy_tree(raw))
    got = tparams.prepare_for_cuda(planar)
    assert set(got["blocks"]) == set(jp["blocks"])
    for name, t in got["blocks"].items():
        j = jp["blocks"][name]
        if isinstance(t, QTensor):
            assert t.layout == j.layout, name
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
            js = np.asarray(j.scales)
            np.testing.assert_array_equal(t.scales.numpy().view(js.dtype), js)
    # [up | gate]: each expert's first hidden rows are its up rows, then its gate rows
    gu = got["blocks"]["moe_gu"].dequantize(torch.float32)
    for half, member in ((slice(0, 128), "moe_up"), (slice(128, 256), "moe_gate")):
        assert torch.equal(gu[:, :, half], planar["blocks"][member].dequantize(torch.float32))


def _branch_spy(monkeypatch):
    """Which MoE branch each call of the port's and the JAX package's _moe_ffn took:
    (a) expert matvecs, (b) gather, (c) expert-major loop."""
    seen = {"port": [], "jax": []}
    for mod, who in ((tfwd, "port"), (jfwd, "jax")):
        gather, step = mod._gather_expert, getattr(mod, "_make_expert_step", None)

        def g(*a, _who=who, _f=gather, **k):
            seen[_who].append("b")
            return _f(*a, **k)
        monkeypatch.setattr(mod, "_gather_expert", g)
        if step is not None:
            def s(*a, _f=step, **k):
                seen["jax"].append("c")
                return _f(*a, **k)
            monkeypatch.setattr(mod, "_make_expert_step", s)
    real = tfwd.qmatmul

    def q(*a, **k):  # an index tensor: the expert entries; a Python int: the loop
        e = k.get("expert")
        if e is not None:
            seen["port"].append("a" if isinstance(e, torch.Tensor) else "c")
        return real(*a, **k)
    monkeypatch.setattr(tfwd, "qmatmul", q)
    return seen


@pytest.mark.parametrize("b,t,policy,branch", [
    (1, 1, True, "a"),     # one row, kernels on: the expert entries
    (1, 1, False, "b"),    # one row, dequantize path: 1·1·2 <= 8, gather
    (1, 4, True, "b"),     # a 4-token chunk: 4·2 <= 8, gather (not the loop)
    (2, 2, "all", "b"),    # 2·2·2 <= 8
    (1, 5, True, "c"),     # 5·2 > 8: the expert-major loop
    (5, 1, "all", "c"),    # a batched decode step of 5 rows: the loop
    (2, 1, True, "b"),     # two rows never take the expert entries
])
def test_moe_branch_gates_match_jax(monkeypatch, b, t, policy, branch):
    """The MoE FFN's gates on a block of E = 8 experts, k = 2, against the JAX package's:
    each call takes the same branch in both."""
    jspec, tspec = _specs("mixtral", 256, 256, n_experts=8)
    jp = jparams.init_random_params(jspec, JFloatType.Q40, seed=1)
    if policy:
        jp = jparams.prepare_for_pallas(jp, spec=jspec)
    tp = tparams.params_from_numpy(to_numpy_tree(jp))
    seen = _branch_spy(monkeypatch)
    xb = np.random.RandomState(2).randn(b, t, 256).astype(np.float32)
    jlayer = {k: _layer0(v) for k, v in jp["blocks"].items()}
    want = jfwd._moe_ffn(jnp.asarray(xb), jlayer, jspec, None, policy, False)
    got = tfwd._moe_ffn(torch.from_numpy(xb), tfwd.layer_params(tp["blocks"], 0), tspec,
                        policy)
    assert set(seen["port"]) == {branch} and set(seen["jax"]) <= {branch}
    if branch != "a":
        assert seen["jax"], "the JAX package took the expert matvecs"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _layer0(v):
    """Layer 0 of a stacked JAX leaf (a QTensor or an array)."""
    import jax

    return jax.tree_util.tree_map(lambda a: a[0], v)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    """A zero router gives every expert the same probability: the port, as
    jax.lax.top_k, picks experts 0..k-1, each with weight 1/k."""
    jspec, tspec = _specs(arch)
    bp = {"router": QTensor(FloatType.F32, torch.zeros(4, 64))}
    xb = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 64).astype(np.float32))
    top_i, w = tfwd._route(xb, bp, tspec)
    assert top_i.tolist() == [[[0, 1]] * 3] * 2
    assert torch.equal(w, torch.full((2, 3, 2), 0.5))
    import jax

    probs = jax.nn.softmax(jnp.zeros((2, 3, 4)), axis=-1)
    assert np.asarray(jax.lax.top_k(probs, 2)[1]).tolist() == top_i.tolist()


@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_expert_entries_plain_equal_slice_then_2d_entry(fmt):
    """The expert entries' plain versions are the 2-D entries' against the sliced expert,
    bit for bit; an index past either end lies outside the one-card window (0, E) and
    gives exact zeros there, while the dequantize route clamps it into the stack (the
    JAX package's dynamic_slice_in_dim)."""
    rng = np.random.RandomState(7)
    e_n, n, k = 4, 96, 256
    x = torch.from_numpy(rng.randn(k).astype(np.float32))
    if fmt == "q4":
        w = torch.from_numpy(rng.randint(0, 256, (e_n, n, k // 2)).astype(np.uint8))
        s = torch.from_numpy((rng.rand(e_n, n, k // 32) * 0.01).astype(np.float16))
        plain, two_d = mv.q4_matvec_expert_plain, mv.q4_matvec_plain
        entry = mv.q4_matvec_expert
        qt = QTensor(FloatType.Q40, w, s, layout="i4p")
    else:
        w = torch.from_numpy(rng.randint(-128, 128, (e_n, n, k)).astype(np.int8))
        s = torch.from_numpy((rng.rand(e_n, n, k // 32) * 0.01).astype(np.float32))
        plain, two_d = q8.q8_matvec_expert_plain, q8.q8_matvec_plain
        entry = q8.q8_matvec_expert
        qt = QTensor(FloatType.Q80, w, s, layout="i8")
    for e, at in ((0, 0), (2, 2), (3, 3), (-1, 0), (9, 3)):
        idx = torch.tensor([e])
        want = two_d(x, w[at], s[at])
        if e != at:  # outside the window: zeros from the entries
            want = torch.zeros_like(want)
        assert torch.equal(plain(x, w, s, idx), want)
        assert torch.equal(entry(x[None, None], qt, idx)[0, 0], want)
        got = tmm.qmatmul(x[None, None], qt, use_kernels=True, expert=idx)
        assert torch.equal(got[0, 0], want)
        # the dequantize route computes the same expert
        deq = tmm.qmatmul(x[None, None], qt, use_kernels=False, expert=idx)[0, 0]
        np.testing.assert_allclose(deq.numpy(), (QTensor(
            qt.ftype, w[at], s[at], qt.layout).dequantize(torch.float32) @ x).numpy(),
            rtol=1e-5, atol=1e-5)


def test_decode_stream_bytes_counts_the_chosen_experts():
    """A token streams k of E experts and the whole router: at tiny size the same figure
    as the JAX package's, and Mixtral-8x7B at 32 layers, prepared for the kernels on
    meta tensors, 7.17 GB."""
    jspec, tspec = _specs("mixtral")
    jp = jparams.prepare_for_pallas(jparams.init_random_params(jspec, JFloatType.Q40,
                                                               seed=2), spec=jspec)
    tp = tparams.params_from_numpy(to_numpy_tree(jp))
    assert tparams.decode_stream_bytes(tp, tspec) == jparams.decode_stream_bytes(jp, jspec)
    with pytest.raises(ValueError, match="spec"):
        tparams.decode_stream_bytes(tp)

    spec = TSpec(arch_type=TArch.MIXTRAL, dim=4096, hidden_dim=14336, n_layers=32,
                 n_heads=32, n_kv_heads=8, vocab_size=32000, seq_len=2048, n_experts=8,
                 n_active_experts=2).resolved()
    meta = torch.device("meta")

    def q40(*shape):
        return QTensor(FloatType.Q40,
                       torch.empty(*shape[:-1], shape[-1] // 32, 16, dtype=torch.uint8,
                                   device=meta),
                       torch.empty(*shape[:-1], shape[-1] // 32, dtype=torch.float16,
                                   device=meta))
    blocks = {name: (q40(spec.n_layers, *shape) if quantized
                     else torch.empty(spec.n_layers, *shape, device=meta))
              for name, (shape, quantized) in tparams.block_tensor_shapes(spec).items()}
    params = tparams.prepare_for_cuda({
        "embedding": torch.empty(32000, 4096, device=meta), "blocks": blocks,
        "rms_final": torch.empty(4096, device=meta), "wcls": q40(32000, 4096)})
    assert params["blocks"]["moe_gu"].layout == "i4p"
    assert params["blocks"]["router"].layout == "planar"
    assert round(tparams.decode_stream_bytes(params, spec) / 1e9, 2) == 7.17


@pytest.fixture(scope="module")
def moe_files(tmp_path_factory):
    """Tiny Mixtral and Grok-1 `.m` files and one `.t`, written by the port's writers."""
    tmp = tmp_path_factory.mktemp("torch_moe")
    paths = {}
    for arch in ARCHS:
        _, spec = _specs(arch, 256, 256)
        spec = TSpec(**{**spec.__dict__, "seq_len": 128})
        params = tparams.init_random_params(spec, FloatType.Q40, seed=4)
        paths[arch] = str(tmp / f"{arch}.m")
        write_model(paths[arch], spec, params_file_order(spec, params), FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [
        b" ", b"ab", b"cd"]
    tpath = str(tmp / "tok.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab,
                                         scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return paths, tpath


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_token_identity_with_jax_engine(moe_files, arch, temperature):
    paths, tpath = moe_files
    prompt = [1] + list(range(3, 20))  # 18 tokens: chunks 8, 8, 1, 1
    want, _ = JEngine.load(paths[arch], tpath, tp=1).generate(
        prompt, 10, JSampler(V, temperature, 0.9, seed=77))
    eng = Engine.load(paths[arch], tpath, device="cpu")
    assert eng.spec.is_moe and eng.use_kernels is False
    got, stats = eng.generate(prompt, 10, Sampler(V, temperature, 0.9, seed=77))
    assert got == want and stats.generated_tokens == 10


def test_engine_kernel_regime_and_device_loop(moe_files):
    """The Engine with the kernels' plain versions and the prefill kernel ("all") gives
    the JAX engine's tokens in its Pallas regime, and generate_chunked (the device loop)
    the host loop's greedy tokens."""
    paths, tpath = moe_files
    prompt = [1] + list(range(30, 50))
    want, _ = JEngine.load(paths["mixtral"], tpath, tp=1, use_pallas=True).generate(
        prompt, 8, JSampler(V, temperature=0.0))
    eng = Engine.load(paths["mixtral"], tpath, device="cpu", use_kernels=True,
                      prefill_kernel=True)
    assert eng.use_kernels == "all" and "moe_gu" in eng.params["blocks"]
    got, _ = eng.generate(prompt, 8, Sampler(V, temperature=0.0))
    assert got == want
    eng.reset()
    loop, _ = eng.generate_chunked(prompt, 8, Sampler(V, temperature=0.0), chunk=4)
    eng.reset()
    host, _ = eng.generate(prompt, 8, Sampler(V, temperature=0.0))
    assert loop == host


def _staggered(be, sampler_cls, prompts, max_tokens=8, after=3):
    reqs = [None] * len(prompts)

    def submit(i):
        n = [0]

        def on_token(_tok):
            n[0] += 1
            if n[0] == after and i + 1 < len(prompts):
                submit(i + 1)
        reqs[i] = be.submit(prompts[i], max_tokens, sampler_cls(V, 0.0), on_token=on_token)
    try:
        submit(0)
        reqs[0].wait(timeout=300)
        return [reqs[i].wait(timeout=300) for i in range(len(prompts))]
    finally:
        be.close()


@pytest.mark.parametrize("fused,superstep", [(False, 1), (True, 1), (False, 4)])
def test_batch_engine_greedy_identity_with_jax(moe_files, fused, superstep):
    """Three staggered requests on tiny Mixtral: mixed prefill steps take the
    expert-major loop, two- and three-row decode steps the gather or the loop (E = 4:
    2·2 <= 4 gathers, 3·2 > 4 loops), the same tokens as the JAX BatchEngine in the same
    configuration; fused, the kernels' plain versions against the Pallas kernels in
    interpret mode; at superstep 4, pipelined super-steps of batched decode."""
    paths, tpath = moe_files
    prompts = [[1] + list(range(3, 30)), [1, 5, 9, 11, 40, 41, 42], [1] + list(range(60, 90))]
    kw = dict(use_pallas=True, fused_matmul=True, paged_kernel=True) if fused else {}
    pipe = superstep > 1
    jbe = JBatchEngine.load(paths["mixtral"], tpath, slots=3, tp=1, superstep=superstep,
                            pipeline=pipe, prefix_cache=False, **kw)
    want = _staggered(jbe, JSampler, prompts)
    tkw = dict(use_kernels=True, fused_matmul=True) if fused else {}
    be = BatchEngine.load(paths["mixtral"], tpath, slots=3, device="cpu",
                          superstep=superstep, pipeline=pipe, prefix_cache=False, **tkw)
    got = _staggered(be, Sampler, prompts)
    assert got == want and all(len(o) == 8 for o in got)


def test_cli_generate_on_a_mixtral_file(moe_files, capsysbinary):
    """`dllama generate` and `inference` on a Mixtral file (the pieces generate prints
    are raw bytes)."""
    paths, tpath = moe_files
    common = ["--model", paths["mixtral"], "--tokenizer", tpath, "--steps", "5",
              "--device", "cpu", "--temperature", "0", "--seed", "1", "--prompt", "ab"]
    dllama.main(["generate", *common])
    out = capsysbinary.readouterr().out
    assert b"device=cpu" in out and b"n_experts: 4" in out
    dllama.main(["inference", *common])
    out = capsysbinary.readouterr().out
    assert b"Generated tokens:    5" in out and b"GB/step" in out
