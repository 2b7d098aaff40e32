"""PyTorch port: the device loops' arithmetic and the single-sequence loop
(runtime/device_loop.py, Engine.generate_chunked) against the JAX package on the CPU.

- xorshift* on int64 halves bit-exact with the JAX split-uint32 functions and the host
  Sampler's _random_u32, states at and above 2^63 included;
- threefry2x32 (PRNGKey, split, fold_in, uniform) bit-exact with jax.random under the
  JAX package's 32-bit setting, seeds at and above 2^32 included;
- device_sample_coin token-identical with the JAX function for greedy, multinomial and
  nucleus rows. The one allowed exception: a coin whose draw point lies within 1e-6 of a
  cumulative-probability boundary (the two packages sum the softmax in other orders);
  the tests count such rows and require them to be rare;
- make_decode_loop and Engine.generate_chunked token-identical with the JAX loop and
  engine, greedy and seeded stochastic, through a stop inside a chunk and the host-loop
  tail at the context end. On the CPU the loop's steps run eagerly (no CUDA graph): the
  same step function a graph captures on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime import device_loop as jdl
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu.runtime.sampler import _random_u32 as j_random_u32
from distributed_llama_tpu_torch.models.forward import forward
from distributed_llama_tpu_torch.runtime import device_loop as tdl
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler, _random_u32
from distributed_llama_tpu_torch.runtime.step_graph import StepGraphs, copy_to_host, upload

V = 262
M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ xorshift*


def _states(family: str) -> np.ndarray:
    rs = np.random.RandomState({"low": 1, "high": 2, "top": 3, "edge": 4}[family])
    if family == "low":  # below 2^63
        return rs.randint(1, 2**63, size=400, dtype=np.uint64)
    if family == "high":  # at or above 2^63
        return rs.randint(0, 2**63, size=400, dtype=np.uint64) | np.uint64(1 << 63)
    if family == "top":  # one half zero or all ones
        lo = rs.randint(0, 2**32, size=200, dtype=np.uint64)
        return np.concatenate([lo, (lo << np.uint64(32)) | np.uint64(M32)])
    return np.array([0, 1, 2, M32, M32 + 1, 2**63 - 1, 2**63, 2**64 - 1,
                     0x2545F4914F6CDD1D, 987654321], dtype=np.uint64)


@pytest.mark.parametrize("family", ["low", "high", "top", "edge"])
def test_xorshift_matches_jax_and_host_sampler(family):
    """The int64-halves xorshift* against the JAX split-uint32 one and both host
    samplers' _random_u32 (the state after each round and the 32-bit output)."""
    states = _states(family)
    hi = torch.from_numpy((states >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((states & np.uint64(M32)).astype(np.int64))
    jh = jnp.asarray((states >> np.uint64(32)).astype(np.uint32))
    jl = jnp.asarray((states & np.uint64(M32)).astype(np.uint32))
    for _ in range(8):
        hi, lo, out = tdl.xorshift_star_step(hi, lo)
        jh, jl, jo = jdl.xorshift_star_step(jh, jl)
        host = [_random_u32(s) for s in states]
        assert [j_random_u32(s) for s in states] == host
        states = np.array([h[0] for h in host], np.uint64)
        got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
        assert (got == states).all()
        assert (out.numpy() == np.array([h[1] for h in host], np.int64)).all()
        assert (hi.numpy() == np.asarray(jh)).all() and (lo.numpy() == np.asarray(jl)).all()
        assert (out.numpy() == np.asarray(jo)).all()


@pytest.mark.parametrize("seed", [987654321, 0, 2**63 + 12345, 2**64 - 1])
def test_xorshift_coin_matches_host_coin(seed):
    """The JAX test's oracle (test_superstep.py::test_device_coin_matches_host_coin):
    the device coin is the host Sampler's randomF32, for the port and for JAX."""
    want = Sampler(16, temperature=1.0, seed=seed).next_coin()
    _, _, coin = tdl.xorshift_coin(torch.tensor([seed >> 32]), torch.tensor([seed & M32]))
    _, _, jcoin = jdl.xorshift_coin(jnp.uint32(seed >> 32), jnp.uint32(seed & M32))
    assert coin.dtype == torch.float32
    assert np.float32(want) == coin.item() == np.asarray(jcoin)


# ------------------------------------------------------------------ threefry


@pytest.mark.parametrize("seed", [0, 1, 77, 2**31, 2**32 - 1, 2**32, 2**32 + 7,
                                  2**40 + 3, 12345678901234, 2**63 - 1])
def test_threefry_matches_jax_random(seed):
    """PRNGKey (a seed of 2^32 or more keeps its low 32 bits, as jax does with 64-bit
    types off), split, fold_in and uniform, bit for bit."""
    key, jkey = tdl.prng_key(seed), jax.random.PRNGKey(seed)
    assert key.tolist() == np.asarray(jkey).tolist()
    for _ in range(3):  # the chunk keys of generate_chunked: split, keep both halves
        (key, sub), (jkey, jsub) = tdl.split(key), jax.random.split(jkey)
        assert key.tolist() == np.asarray(jkey).tolist()
        assert sub.tolist() == np.asarray(jsub).tolist()
        folded = tdl.fold_in(sub, torch.arange(20))
        for i in range(20):
            jf = jax.random.fold_in(jsub, i)
            assert folded[i].tolist() == np.asarray(jf).tolist()
            assert tdl.uniform(folded[i]).item() == float(jax.random.uniform(jf))
    assert tdl.split(key, 5).tolist() == np.asarray(jax.random.split(jkey, 5)).tolist()


# ------------------------------------------------------------------ sampling


def _near_boundary(row: np.ndarray, u: float, temp: float, topp: float) -> bool:
    """Whether the draw point of coin u lies within 1e-6 of a cumulative-probability
    boundary of the row (exact f64 sums), where a sum in another order may pick the
    neighbouring token."""
    x = row.astype(np.float64) / temp
    p = np.exp(x - x.max())
    p /= p.sum()
    if 0.0 < topp < 1.0:
        p = np.where(p >= (1.0 - topp) / (len(p) - 1), p, 0.0)
        p = -np.sort(-p, kind="stable")
        csum = np.cumsum(p)
        if np.abs(csum - topp).min() < 1e-6:
            return True
        over = np.nonzero(csum > topp)[0]
        csum = csum[:(over[0] if len(over) else len(p) - 1) + 1]
    else:
        csum = np.cumsum(p)
    return bool(np.abs(csum - u * csum[-1]).min() < 1e-6)


# the JAX batched loop's form: the one-row function mapped over rows
_jax_sample_rows = jax.jit(jax.vmap(jdl.device_sample_coin))


@pytest.mark.parametrize("temp,topp", [(0.0, 0.9), (0.8, 1.0), (1.3, 0.0), (0.8, 0.9),
                                       (1.3, 0.5), (1e4, 1e-4), ("mixed", "mixed")])
def test_device_sample_coin_matches_jax(temp, topp):
    """Token identity with the JAX device_sample_coin per row, on 96 rows of 257 logits
    and their coins; (1e4, 1e-4) is the degenerate nucleus (every token filtered)."""
    rs = np.random.RandomState(5)
    b, n = 96, 257
    logits = (rs.standard_normal((b, n)) * 3).astype(np.float32)
    logits[::7, 11] += 9.0  # some peaked rows
    u = rs.uniform(0, 1, b).astype(np.float32)
    if temp == "mixed":
        temps = rs.choice([0.0, 0.7, 1.2], b).astype(np.float32)
        topps = rs.choice([0.0, 0.5, 0.9, 1.0], b).astype(np.float32)
    else:
        temps, topps = np.full(b, temp, np.float32), np.full(b, topp, np.float32)
    got = tdl.device_sample_coin(torch.from_numpy(logits), torch.from_numpy(u),
                                 torch.from_numpy(temps), torch.from_numpy(topps)).numpy()
    want = np.asarray(_jax_sample_rows(logits, u, temps, topps))
    off = [r for r in range(b) if got[r] != want[r]]
    assert all(temps[r] != 0 and _near_boundary(logits[r], u[r], temps[r], topps[r])
               for r in off), off
    assert len(off) <= 1, off
    assert ((got >= 0) & (got < n)).all()


def test_device_sample_with_key_matches_jax():
    """device_sample draws its coin with jax.random.uniform from the row's key."""
    rs = np.random.RandomState(6)
    logits = (rs.standard_normal((8, 100)) * 2).astype(np.float32)
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(8)]
    keys = tdl.fold_in(tdl.prng_key(9), torch.arange(8))
    got = tdl.device_sample(torch.from_numpy(logits), keys, torch.full((8,), 0.9),
                            torch.full((8,), 0.9)).tolist()
    want = np.asarray(jax.jit(jax.vmap(jdl.device_sample))(
        jnp.asarray(logits), jnp.stack(jkeys), jnp.full(8, 0.9, jnp.float32),
        jnp.full(8, 0.9, jnp.float32))).tolist()
    assert got == want


# ------------------------------------------------------------------ the loop


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_device_loop")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=V, seq_len=64).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=9)
    mpath = str(tmp / "model.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ", b"ab",
                                                                          b"cd"]
    tpath = str(tmp / "tok.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


@pytest.fixture(scope="module")
def engines(files):
    """One JAX engine and one port engine for the module (the JAX loops compile once per
    chunk and mode)."""
    jeng = JEngine.load(*files, tp=1)
    eng = Engine.load(*files, device="cpu")
    assert not eng.cuda_graph and not eng.graphs.enabled
    return jeng, eng


def _fresh(jeng, eng):
    jeng.reset()
    eng.reset()


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_decode_loop_matches_jax_make_decode_loop(engines, mode):
    """One 6-step loop from the same prefilled caches: the same tokens, the last logits
    row within f32 tolerance, and the caches advanced the same way."""
    jeng, eng = engines
    _fresh(jeng, eng)
    prompt = [1, 40, 41, 42, 43]
    jeng.prefill(prompt)
    eng.prefill(prompt)
    jloop = jeng._decode_loop(6, mode, None)
    jkey = jax.random.split(jax.random.PRNGKey(33))[1]
    jtoks, jrow, jeng.k_cache, jeng.v_cache = jloop(
        jeng.params, jeng.rope, 50, jeng.k_cache, jeng.v_cache, len(prompt), jkey, 0.9, 0.9)
    loop = eng._decode_loop(6, mode, None)
    key = tdl.split(tdl.prng_key(33))[1]
    toks, row, _, _ = loop(eng.rope, 50, eng.k_cache, eng.v_cache, len(prompt),
                           key.tolist(), 0.9, 0.9)
    assert toks.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=0, atol=2e-4)
    n = len(prompt) + 6
    kc = eng.k_cache[:, 0, :, :n].numpy()  # JAX keeps (L, B, hk, S, hs) too
    np.testing.assert_allclose(kc, np.asarray(jeng.k_cache)[:, 0, :, :n], atol=2e-4)


@pytest.mark.parametrize("temp,topp,seed", [(0.0, 0.9, 0), (0.8, 0.9, 77),
                                            (1.1, 1.0, 2**40 + 3)])
def test_generate_chunked_matches_jax_engine(engines, temp, topp, seed):
    """JAX Engine.generate_chunked's tokens: greedy, nucleus and multinomial, a seed of
    2^32 or more; 13 tokens in chunks of 4 (the last chunk cut short)."""
    jeng, eng = engines
    _fresh(jeng, eng)
    prompt = [1, 9, 8, 7, 6]
    want, _ = jeng.generate_chunked(prompt, 13, JSampler(V, temp, topp, seed=seed), chunk=4)
    got, stats = eng.generate_chunked(prompt, 13, Sampler(V, temp, topp, seed=seed), chunk=4)
    assert got == want and len(got) == 13
    assert eng.pos == jeng.pos == len(prompt) + 12
    assert stats.generated_tokens == 13 and len(stats.token_ms) == 13


def test_generate_chunked_stop_mid_chunk(engines):
    """A stop inside a chunk (the 6th token, the second of the second chunk) ends the
    output at the stop and the position at its input; the engine then continues from
    there as the JAX engine does."""
    jeng, eng = engines

    def sixth():
        seen = []
        return lambda t: seen.append(t) or len(seen) == 6
    _fresh(jeng, eng)
    prompt = [1, 3, 5, 7]
    full, _ = eng.generate_chunked(prompt, 12, Sampler(V, 0.8, 0.9, seed=3), chunk=4)
    _fresh(jeng, eng)
    want, _ = jeng.generate_chunked(prompt, 12, JSampler(V, 0.8, 0.9, seed=3), chunk=4,
                                    stop_check=sixth())
    got, _ = eng.generate_chunked(prompt, 12, Sampler(V, 0.8, 0.9, seed=3), chunk=4,
                                  stop_check=sixth())
    assert got == want == full[:6]
    assert eng.pos == jeng.pos == len(prompt) - 1 + 6
    more = eng.generate_chunked([got[-1]], 5, Sampler(V, 0.0), chunk=4)[0]
    jmore = jeng.generate_chunked([want[-1]], 5, JSampler(V, 0.0), chunk=4)[0]
    assert more == jmore


def test_generate_chunked_context_end_tail(engines):
    """Fewer than `chunk` positions left: the host loop decodes the tail, up to the
    context end, as in the JAX engine."""
    jeng, eng = engines
    _fresh(jeng, eng)
    prompt = [1] + list(range(100, 150))  # 51 tokens of a 64-token context
    want, _ = jeng.generate_chunked(prompt, 30, JSampler(V, 0.0), chunk=8)
    got, stats = eng.generate_chunked(prompt, 30, Sampler(V, 0.0), chunk=8)
    assert got == want
    assert eng.pos == jeng.pos == 64 and len(got) == stats.generated_tokens


def test_generate_with_switches_to_the_device_loop(engines):
    jeng, eng = engines
    prompt = [1, 20, 21]
    _fresh(jeng, eng)
    chunked = eng.generate_with(prompt, 9, Sampler(V, 0.9, 0.9, seed=4),
                                device_loop_chunk=4)[0]
    eng.reset()
    assert chunked == eng.generate_chunked(prompt, 9, Sampler(V, 0.9, 0.9, seed=4),
                                           chunk=4)[0]
    eng.reset()
    host = eng.generate_with(prompt, 9, Sampler(V, 0.9, 0.9, seed=4))[0]
    eng.reset()
    assert host == eng.generate(prompt, 9, Sampler(V, 0.9, 0.9, seed=4))[0]
    assert chunked == jeng.generate_with(prompt, 9, JSampler(V, 0.9, 0.9, seed=4),
                                         device_loop_chunk=4)[0]


# ------------------------------------------------------------------ the step


def test_one_token_step_with_device_position_matches_int_position(engines):
    """forward with a 0-d position tensor (what a captured step reads) gives the int
    position's logits and cache rows bit for bit, on the kernel route and the plain one."""
    _, eng = engines
    spec = eng.spec
    for kernels in (False, True):
        caches = [tuple(torch.randn(spec.n_layers, 1, spec.n_kv_heads, spec.seq_len,
                                    spec.head_size, generator=torch.Generator().manual_seed(s))
                        for s in (1, 2)) for _ in range(2)]
        outs = []
        for (kc, vc), pos in zip(caches, (21, torch.tensor(21))):
            logits, _, _ = forward(eng.params, spec, eng.rope, torch.tensor([[17]]), kc, vc,
                                   pos, use_kernels=kernels, attn_window=32)
            outs.append((logits, kc, vc))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_step_graphs_and_host_copies_on_the_cpu():
    graphs = StepGraphs("cpu", enabled=False)
    calls = []
    assert graphs.run(("k",), lambda: calls.append(1) or 5) == 5 and calls == [1]
    assert graphs.captures == graphs.replays == 0
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraphs("cpu", enabled=True)
    buf = torch.zeros(2, 3, dtype=torch.int64)
    upload(buf, [[1, 2, 3], [4, 5, 6]])
    fetch = copy_to_host(buf)
    buf.zero_()  # copied at once on the CPU: a later step may overwrite the buffer
    assert fetch()[0].tolist() == [[1, 2, 3], [4, 5, 6]]


def test_cli_device_loop_generates_the_host_loops_greedy_text(files, capsys):
    """dllama generate --device-loop 4 prints the host loop's greedy text."""
    from distributed_llama_tpu_torch.apps import dllama

    common = ["generate", "--model", files[0], "--tokenizer", files[1], "--steps", "10",
              "--device", "cpu", "--temperature", "0", "--seed", "1", "--prompt", "ab"]
    texts = []
    for extra in ([], ["--device-loop", "4"]):
        dllama.main(common + extra)
        texts.append(capsys.readouterr().out.splitlines()[-1])
    assert texts[0] == texts[1] and texts[0]
