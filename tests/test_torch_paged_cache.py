"""PyTorch port: the host/disc KV spill (runtime/paged_cache.py HostKVStore,
cache/block_pool.py HostKVArena, ops/attention.py gqa_attention_lse and
merge_attention_partials, the hot-ring branch of models/forward.py, Engine(
kv_cache_storage=, kv_cache_resident=, kv_cache_dir=) and the --kv-cache-* flags)
against the JAX package's paged engine and the port's own dense engine, on one tiny `.m`
file (dim 64, 3 layers, seq_len 256, Q40, weight seed 11) with a 64-slot ring, the sizes
of tests/test_paged_cache.py.

Tolerances: the attention pieces and the cold partial 1e-5; engine logits 2e-4 (the JAX
test's bound) at every chunk; greedy tokens exactly. On the CPU both packages run f32.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.ops import attention as jatt
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime import paged_cache as jpc
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.cache.block_pool import HostKVArena
from distributed_llama_tpu_torch.models.spec import ArchType as TArch
from distributed_llama_tpu_torch.models.spec import ModelSpec as TModelSpec
from distributed_llama_tpu_torch.ops import attention as tatt
from distributed_llama_tpu_torch.resilience import FaultInjected, faults
from distributed_llama_tpu_torch.runtime import paged_cache as tpc
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 262
R = 64  # the ring: a multiple of 64, so kv_resident == R
SPEC = dict(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=3, n_heads=4,
            n_kv_heads=2, vocab_size=V, seq_len=256)
MIX = (64, 8, 1, 1, 7, 1)  # crosses the cold boundary (64), wraps the ring at 128, 192
N_STEPS = 200
TOL = 2e-4


def _write(path, spec, seed):
    params = init_random_params(spec, FloatType.Q40, seed=seed)
    write_model(str(path), spec, params_file_order(spec, params), FloatType.Q40)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_paged")
    mpath = _write(d / "m.m", ModelSpec(**SPEC).resolved(), 11)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ", b"ab",
                                                                          b"cd"]
    tpath = str(d / "t.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


def _chunks(seed: int, n_steps: int = N_STEPS, mix=MIX) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    out, pos, i = [], 0, 0
    while pos < n_steps:
        t = min(mix[i % len(mix)], n_steps - pos)
        out.append(rng.integers(0, V, size=t).tolist())
        pos, i = pos + t, i + 1
    return out


def _jax_paged(mpath, storage="host", **kw):
    eng = JEngine.load(mpath, tp=1, dtype=jnp.float32, kv_cache_storage=storage,
                       kv_cache_resident=R, **kw)
    assert eng.paged
    return eng


def _paged(mpath, storage="host", **kw):
    eng = Engine.load(mpath, device="cpu", kv_cache_storage=storage, kv_cache_resident=R,
                      **kw)
    assert eng.paged and eng.kv_resident == R and eng.k_cache.shape[3] == R
    return eng


@pytest.fixture(scope="module")
def jax_logits(files):
    """The JAX paged engine's last-token logits at every chunk of _chunks(0)."""
    eng = _jax_paged(files[0])
    return [eng.infer_chunk(c) for c in _chunks(0)]


# ------------------------------------------------------------------ the pieces


def _lse_case(which: str):
    rng = np.random.default_rng(3)
    b, t, hq, hk, hs, s = 2, 3, 4, 2, 8, 24
    q = rng.normal(size=(b, t, hq, hs)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, hs)).astype(np.float32)
    v = rng.normal(size=(b, hk, s, hs)).astype(np.float32)
    positions = np.array([20, 21, 22])
    if which == "split":  # the key axis cut at 10: two segments, both live
        segs = [(np.arange(10), slice(0, 10)), (np.arange(10, s), slice(10, s))]
    elif which == "empty":  # the second segment is past every query: fully masked
        segs = [(np.arange(s), slice(0, s)), (np.arange(100, 100 + s), slice(0, s))]
    else:  # "masked": row 0 sees no key of the first segment, the second segment none
        positions = np.array([5, 21, 22])
        segs = [(np.arange(10, 10 + s), slice(0, s)), (np.arange(100, 100 + s),
                                                       slice(0, s))]
    return q, k, v, positions, segs


@pytest.mark.parametrize("which", ["split", "empty", "masked"])
def test_lse_and_merge_match_jax(which):
    """gqa_attention_lse per segment and merge_attention_partials of the two against the
    JAX package's on the same arrays (1e-5): a split key axis (and the merge equals
    gqa_attention over the whole axis), an empty segment (lse -inf, zero weight), and a
    fully masked row (out 0, lse -inf; two empty segments merge to zeros)."""
    q, k, v, positions, segs = _lse_case(which)
    parts, jparts = [], []
    for kp, sl in segs:
        o, lse = tatt.gqa_attention_lse(torch.from_numpy(q), torch.from_numpy(k[:, :, sl]),
                                        torch.from_numpy(v[:, :, sl]),
                                        torch.from_numpy(positions),
                                        key_positions=torch.from_numpy(kp))
        jo, jlse = jatt.gqa_attention_lse(jnp.asarray(q), jnp.asarray(k[:, :, sl]),
                                          jnp.asarray(v[:, :, sl]), jnp.asarray(positions),
                                          key_positions=jnp.asarray(kp))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(np.asarray(jlse)))
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
        parts.append((o, lse))
        jparts.append((jo, jlse))
    merged = tatt.merge_attention_partials(*parts[0], *parts[1])
    jmerged = jatt.merge_attention_partials(*jparts[0], *jparts[1])
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), rtol=1e-5, atol=1e-5)
    if which == "split":
        full = tatt.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(positions))
        np.testing.assert_allclose(merged.reshape(full.shape).numpy(), full.numpy(),
                                   rtol=1e-5, atol=1e-5)
    if which == "masked":
        assert np.isneginf(parts[0][1][:, 0].numpy()).all()
        assert (merged[:, 0] == 0).all()


@pytest.mark.parametrize("storage", ["host", "disc"])
def test_cold_attend_matches_jax(storage, tmp_path):
    """HostKVStore.cold_attend against the JAX store's on the same rows and queries, for
    an empty cold segment and two cold lengths; the cold counters count the store's
    bytes (the JAX package its f32 copy: the same here, an f32 store)."""
    spec = ModelSpec(**SPEC).resolved()
    tspec = TModelSpec(**{**SPEC, "arch_type": TArch.LLAMA}).resolved()
    rng = np.random.default_rng(7)
    shape = (spec.n_layers, 1, spec.n_kv_heads, spec.seq_len, spec.head_size)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    d = str(tmp_path / "t") if storage == "disc" else None
    st = tpc.HostKVStore(tspec, R, storage=storage, directory=d)
    jst = jpc.HostKVStore(spec, R, storage=storage,
                          directory=str(tmp_path / "j") if d else None)
    st.append(torch.from_numpy(k), torch.from_numpy(v), 0)
    jst.append(k, v, 0)
    q = rng.normal(size=(1, 5, spec.n_heads, spec.head_size)).astype(np.float32)
    for start in (R, R + 37, spec.seq_len):
        calls0 = tpc._COLD_CALLS.value
        bytes0 = tpc._COLD_BYTES.value
        out, lse = st.cold_attend(1, torch.from_numpy(q), start)
        jout, jlse = jst.cold_attend(1, q, start)
        np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)
        cold = start - R
        assert tpc._COLD_CALLS.value - calls0 == (cold > 0)
        assert tpc._COLD_BYTES.value - bytes0 == 2 * spec.n_kv_heads * cold * \
            spec.head_size * 4
    assert st.nbytes() == jst.nbytes() == 2 * k.nbytes
    st.cleanup()
    jst.cleanup()


def test_bf16_disc_arena_holds_jax_bits(tmp_path):
    """A bf16 disc arena is an int16 memmap viewed as bfloat16: its file holds the same
    bytes as the JAX package's ml_dtypes bf16 memmap of the same values, sized
    L·B·hk·S·hs·2 a file; the caller's directory is kept."""
    import ml_dtypes

    from distributed_llama_tpu.cache.block_pool import HostKVArena as JHostKVArena

    shape = (2, 1, 2, 16, 8)
    vals = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    arena = HostKVArena(shape, torch.bfloat16, storage="disc", directory=str(tmp_path / "t"))
    jarena = JHostKVArena(shape, np.dtype(ml_dtypes.bfloat16), storage="disc",
                          directory=str(tmp_path / "j"))
    assert arena.k.dtype == torch.bfloat16 and arena._owned_dir is None
    arena.k.copy_(torch.from_numpy(vals))
    jarena.k[...] = vals.astype(ml_dtypes.bfloat16)
    arena._memmaps[0].flush()
    jarena.k.flush()
    for p, jp in zip(arena.paths, jarena.paths):
        assert os.path.getsize(p) == os.path.getsize(jp) == np.prod(shape) * 2
    with open(arena.paths[0], "rb") as f, open(jarena.paths[0], "rb") as jf:
        assert f.read() == jf.read()
    arena.cleanup()  # a caller's directory: kept
    assert os.path.exists(arena.paths[0])


# ------------------------------------------------------------------ the engine


@pytest.mark.parametrize("storage", ["host", "disc"])
def test_paged_engine_matches_jax_and_dense(files, jax_logits, storage, tmp_path):
    """Chunk by chunk over (64, 8, 1, 1, 7, 1) to 200 positions (the ring wraps twice),
    the port's paged engine against the JAX paged engine and the port's dense engine;
    the disc pair is sized for the full context."""
    mpath = files[0]
    d = str(tmp_path) if storage == "disc" else None
    dense, paged = Engine.load(mpath, device="cpu"), _paged(mpath, storage, kv_cache_dir=d)
    for i, (toks, want) in enumerate(zip(_chunks(0), jax_logits)):
        got = paged.infer_chunk(toks)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=f"against JAX at chunk {i} (pos {paged.pos})")
        np.testing.assert_allclose(got, dense.infer_chunk(toks), rtol=TOL, atol=TOL,
                                   err_msg=f"against dense at chunk {i} (pos {paged.pos})")
    assert paged.pos == dense.pos == N_STEPS
    if storage == "disc":
        spec = paged.spec
        size = spec.n_layers * spec.n_kv_heads * spec.seq_len * spec.head_size * 4
        assert [os.path.getsize(p) for p in paged.store.paths] == [size, size]
        assert os.path.dirname(paged.store.paths[0]) == d


def test_paged_generate_greedy_matches_jax(files):
    """generate() far past the ring emits the JAX paged engine's greedy tokens."""
    prompt = list(range(10, 80))  # prefill 70 > R
    want, _ = _jax_paged(files[0]).generate(prompt, 60, JSampler(V, temperature=0.0))
    got, stats = _paged(files[0]).generate(prompt, 60, Sampler(V, temperature=0.0))
    assert got == want and stats.generated_tokens == 60


def test_warm_phase_fires_no_cold_call(files):
    """While pos + T <= R the cold segment is empty: no cold call, and the store still
    takes every row; crossing the boundary engages it, with the dense engine's logits."""
    dense, paged = Engine.load(files[0], device="cpu"), _paged(files[0])
    calls = []
    orig = paged.store.cold_attend
    paged.store.cold_attend = lambda *a: (calls.append(a[0]), orig(*a))[1]
    toks = np.random.default_rng(4).integers(0, V, size=80).tolist()
    for t in (40, 20, 20):
        np.testing.assert_allclose(paged.infer_chunk(toks[:t]), dense.infer_chunk(toks[:t]),
                                   rtol=TOL, atol=TOL)
        toks = toks[t:]
        if paged.pos <= R:
            assert not calls, "cold calls in the warm phase"
            assert (paged.store.k[:, :, :, :paged.pos] == dense.k_cache[:, :, :, :paged.pos]
                    ).all()
            assert (paged.store.k[:, :, :, paged.pos:] == 0).all()
    assert calls == [0, 1, 2], "the crossing step made no cold call per layer"


def test_seek_after_a_wrap_matches_jax(files):
    """A rewind after the ring wrapped (api_server's resident rewind): the ring is
    restored from the store, a full rebuild and then a targeted patch, as JAX's."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, V, size=90).tolist()
    branch_a = rng.integers(0, V, size=30).tolist()
    branch_b = rng.integers(0, V, size=30).tolist()
    engines = (_jax_paged(files[0]), _paged(files[0]))
    outs = []
    for eng in engines:
        out, pos = [], 0
        for t in (64, 8, 8, 8, 1, 1):
            eng.infer_chunk(shared[pos:pos + t])
            pos += t
        for i in range(0, 30, 10):
            eng.infer_chunk(branch_a[i:i + 10])
        eng.seek(90)  # 30 back: the targeted patch
        for i in range(0, 30, 10):
            out.append(eng.infer_chunk(branch_b[i:i + 10]))
        eng.seek(20)  # 100 back: the rebuild
        out.append(eng.infer_chunk(branch_a[:7]))
        outs.append(out)
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"after seek {i}")


def test_reset_discards_stale_history(files):
    """reset() and a new context equals a fresh engine: stale ring slots and stale
    store rows past the new position are never read."""
    paged = _paged(files[0])
    for toks in _chunks(2, 90, (64, 8, 8, 8, 1, 1)):
        paged.infer_chunk(toks)
    paged.reset()
    fresh = _paged(files[0])
    probe = list(range(5, 75))
    for sl in (slice(0, 64), slice(64, 70)):
        np.testing.assert_allclose(paged.infer_chunk(probe[sl]), fresh.infer_chunk(probe[sl]),
                                   rtol=TOL, atol=TOL)


def test_reset_backend_zeroes_the_ring_and_keeps_the_store(files):
    """reset_backend (a wedge recovery) zeroes the ring in place and leaves the host
    store; the next context equals a fresh engine's."""
    paged = _paged(files[0])
    paged.prefill(list(range(3, 80)))  # 77 tokens: past the ring
    ring, store = paged.k_cache, paged.store.k.clone()
    paged.reset_backend()
    assert paged.pos == 0 and paged.k_cache is ring and (ring == 0).all()
    assert torch.equal(paged.store.k, store)
    probe = list(range(9, 79))
    np.testing.assert_allclose(paged.prefill(probe), _paged(files[0]).prefill(probe),
                               rtol=TOL, atol=TOL)


def test_paging_off_when_the_context_fits_and_single_sequence_only(files, capsys):
    eng = Engine.load(files[0], device="cpu", kv_cache_storage="host",
                      kv_cache_resident=4096)
    assert not eng.paged and eng.store is None and eng.k_cache.shape[3] == 256
    assert "nothing to page" in capsys.readouterr().err
    assert Engine.load(files[0], device="cpu", kv_cache_resident=1).kv_resident == 64
    for kw in ({"batch": 2}, {"kv_pool": (8, 16)}):
        with pytest.raises(ValueError, match="single-sequence"):
            _paged(files[0], **kw)
    paged = _paged(files[0])
    with pytest.raises(RuntimeError):
        paged.read_rows(0, 4)
    with pytest.raises(RuntimeError):
        paged.seed_rows(0, torch.zeros(3, 2, 4, 16), torch.zeros(3, 2, 4, 16))


def test_owned_tempdir_cleanup():
    """A store that made its own directory removes it on cleanup(), idempotently."""
    tspec = TModelSpec(**{**SPEC, "arch_type": TArch.LLAMA}).resolved()
    st = tpc.HostKVStore(tspec, R, storage="disc")
    d = os.path.dirname(st.paths[0])
    assert os.path.exists(d) and st._owned_dir == d
    st.cleanup()
    assert not os.path.exists(d)
    st.cleanup()


@pytest.mark.parametrize("point", ["paged.cold_attend", "paged.append"])
def test_paged_faults_propagate(files, point):
    """An injected fault at a paged point fails the step, as in the JAX engine."""
    paged = _paged(files[0])
    paged.infer_chunk(list(range(3, 67)))  # pos 64: the next step is paged
    with faults.active(faults.FaultSpec(point)):
        with pytest.raises(FaultInjected):
            paged.infer_chunk([5, 6])


def test_moe_paged_matches_dense_and_jax(tmp_path):
    """The hot-ring branch is arch-independent: a Mixtral-shaped spec across the cold
    boundary against the port's dense engine and the JAX paged engine."""
    spec = ModelSpec(arch_type=ArchType.MIXTRAL, dim=64, hidden_dim=96, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=96, seq_len=256, n_experts=4,
                     n_active_experts=2).resolved()
    mpath = _write(tmp_path / "moe.m", spec, 13)
    jeng = _jax_paged(mpath)
    dense, paged = Engine.load(mpath, device="cpu"), _paged(mpath)
    rng = np.random.default_rng(6)
    for t in (64, 8, 1, 7, 1):
        toks = rng.integers(0, 96, size=t).tolist()
        got = paged.infer_chunk(toks)
        np.testing.assert_allclose(got, jeng.infer_chunk(toks), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, dense.infer_chunk(toks), rtol=TOL, atol=TOL)


def test_speculative_in_paged_mode_equals_greedy(files):
    """generate_speculative on a paged engine (blocks at their own length, the targeted
    seek after every rejection) gives generate()'s greedy tokens, past the ring."""
    rep = [5, 9, 17, 3, 44, 9, 17, 3]
    prompt = [1] + rep * 8  # 65 tokens: the prefill crosses the ring
    want, _ = _paged(files[0]).generate(prompt, 60, Sampler(V, temperature=0.0))
    got, stats = _paged(files[0]).generate_speculative(prompt, 60,
                                                       Sampler(V, temperature=0.0), k=8)
    assert got == want and stats.spec_steps > 0


# ------------------------------------------------------------------ entry points


def test_cli_paged_generate_and_new_flags(files, capsysbinary):
    """dllama generate --kv-cache-storage host --kv-cache-resident 64 prints the greedy
    text of the dense run; --fused-matmul, --nthreads, --pipeline and --cache-write
    deferred parse, and --cache-write inscan is refused."""
    mpath, tpath = files
    common = ["generate", "--model", mpath, "--tokenizer", tpath, "--steps", "40",
              "--device", "cpu", "--temperature", "0", "--seed", "1",
              "--prompt", "ab cd " * 20]
    dllama.main(common)
    dense = capsysbinary.readouterr()
    dllama.main(common + ["--kv-cache-storage", "host", "--kv-cache-resident", "64",
                          "--fused-matmul", "--nthreads", "4", "--no-pipeline",
                          "--cache-write", "deferred"])
    paged = capsysbinary.readouterr()
    assert b"paged KV ring of 64" in paged.out and b"paged KV cache (host)" in paged.err
    assert paged.out.split(b"\n")[-2] == dense.out.split(b"\n")[-2]
    args = dllama.build_parser().parse_args(common[:5] + ["--fused-matmul", "--pipeline"])
    assert (args.fused_matmul, args.pipeline, args.nthreads, args.kv_cache_storage,
            args.kv_cache_resident) == (True, True, None, None, 1024)
    with pytest.raises(SystemExit):
        dllama.main(common + ["--cache-write", "inscan"])
    assert b"deferred-only" in capsysbinary.readouterr().err


def test_api_server_paged_flags(files):
    """The server takes the --kv-cache-* flags at --batch 1 (a paged engine, resident-
    only reuse, /v1/stats engine.paged) and refuses them at --batch > 1."""
    mpath, tpath = files
    p = api_server.build_parser()
    common = ["--model", mpath, "--tokenizer", tpath, "--device", "cpu", "--host",
              "127.0.0.1", "--port", "0", "--chat-template", "llama2",
              "--kv-cache-storage", "disc"]
    with pytest.raises(SystemExit):
        api_server.check_args(p, p.parse_args(common + ["--batch", "2"]))
    args = p.parse_args(common + ["--kv-cache-resident", "64"])
    api_server.check_args(p, args)
    srv = api_server.build_server(args)
    try:
        eng = srv.api_state.engine
        assert eng.paged and eng.store.paths is not None
        assert srv.api_state.cache.cache is None
        assert api_server._stats_payload(srv.api_state)["engine"]["paged"] is True
    finally:
        srv.server_close()
