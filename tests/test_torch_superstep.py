"""PyTorch port: K-step super-steps and their pipelining in the BatchEngine
(runtime/batch_engine.py over runtime/device_loop.py make_batched_decode_loop) against
the JAX package's BatchEngine in the same configuration (tp=1, prefix_cache=False,
paged KV) on one tiny `.m`/`.t` pair; the cases mirror tests/test_superstep.py and
tests/test_pipeline.py.

Requests are staggered from token callbacks on the scheduler thread, so each engine
sees one deterministic schedule: prefill chunks with decode rows riding them, single
steps while a request waits for admission, then super-steps (chained when pipelined).
Every request must get the JAX engine's tokens, greedy and seeded-stochastic, and its
sampler must end in the same xorshift* state. On the CPU each super-step's K steps run
eagerly: the step function a CUDA graph captures on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 262
PROMPTS = [[1, 7, 23, 5], [1, 9, 2, 40, 41, 42, 43, 44, 45, 46, 47], [1, 3, 5]]
MAX_TOKENS = [17, 6, 11]  # mixed budgets: rows park mid-block at different steps


def _files(tmp, seq_len: int, seed: int):
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=V, seq_len=seq_len).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=seed)
    mpath = str(tmp / f"model{seq_len}.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [
        b" ", b"ab", b"cd"]
    tpath = str(tmp / "tok.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab,
                                         scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("torch_superstep"), 128, 11)


@pytest.fixture(scope="module")
def jax_engines(files):
    """The JAX oracles, one per pipeline setting, built once for the module."""
    engines = {p: JBatchEngine.load(*files, slots=2, tp=1, superstep=4, pipeline=p,
                                    prefix_cache=False) for p in (False, True)}
    yield engines
    for be in engines.values():
        be.close()


def _port(files, **kw):
    return BatchEngine.load(*files, slots=2, device="cpu", superstep=4, prefix_cache=False,
                            **kw)


def staggered(be, sampler_cls, temp, after=3, seed=100):
    """Submit PROMPTS[0]; submit PROMPTS[i+1] from request i's callback after `after`
    tokens. Returns the outputs and each sampler's final state."""
    reqs, samplers = [None] * len(PROMPTS), [None] * len(PROMPTS)

    def submit(i):
        n = [0]

        def on_token(_t):
            n[0] += 1
            if n[0] == after and i + 1 < len(PROMPTS):
                submit(i + 1)
        samplers[i] = sampler_cls(V, temp, 0.9, seed=seed + i)
        reqs[i] = be.submit(PROMPTS[i], MAX_TOKENS[i], samplers[i], on_token=on_token)
    submit(0)
    reqs[0].wait(timeout=300)
    outs = [r.wait(timeout=300) for r in reqs]
    return outs, [int(s.state) for s in samplers]


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("pipeline", [False, True])
def test_superstep_token_identity_with_jax(files, jax_engines, pipeline, temp):
    """Tokens and final sampler states of three staggered requests with mixed budgets,
    against the JAX engine with the same superstep and pipeline setting."""
    want = staggered(jax_engines[pipeline], JSampler, temp)
    be = _port(files, pipeline=pipeline)
    try:
        assert be.pipeline == pipeline and be.superstep == 4
        got = staggered(be, Sampler, temp)
        assert got == want
        assert [len(o) for o in got[0]] == MAX_TOKENS
        assert be.super_steps > 0 and be.mixed_steps > 0
        assert (be.chained > 0) == pipeline
    finally:
        be.close()


def test_batched_loop_matches_jax_and_chains(files, jax_engines):
    """make_batched_decode_loop against the JAX one on the same zeroed paged pools: a
    greedy row and a stochastic row with budgets 4 and 2, then a second call chained
    from the first one's device carry; tokens, block-tail tokens, positions and the
    xorshift* states equal."""
    jbe = jax_engines[False]
    be = _port(files)
    try:
        for sl, jsl, n in zip(be._slots, jbe._slots, (9, 5)):
            for eng in (be, jbe):  # both tables cover the first n + 8 positions
                eng._paged_ensure((sl if eng is be else jsl), n + 8)
        tables, jtables = be._tables(), jbe._tables()
        rng = np.array([[0x12345678, 0x9ABCDEF0], [3, 99]], np.int64)
        args = dict(tokens=[7, 8], start_pos=[9, 5], temperature=[0.0, 0.9],
                    topp=[0.9, 0.9], budget=[4, 2])
        jloop = jbe._batched_loop(4, "sample", None)
        loop = be._batched_loop(4, "sample", None)
        eng, jeng = be.engine, jbe._eng
        jeng.k_cache, jeng.v_cache = jnp.zeros_like(jeng.k_cache), jnp.zeros_like(
            jeng.v_cache)  # the port's pools are fresh
        want = jloop(jeng.params, jeng.rope, args["tokens"], jeng.k_cache, jeng.v_cache,
                     args["start_pos"], rng.astype(np.uint32), args["temperature"],
                     args["topp"], args["budget"], jtables)
        jeng.k_cache, jeng.v_cache = want[4], want[5]
        got = loop(eng.rope, args["tokens"], eng.k_cache, eng.v_cache, args["start_pos"],
                   rng, args["temperature"], args["topp"], args["budget"], tables)
        for g, w in zip(got[:4], want[:4]):
            assert g.tolist() == np.asarray(w).astype(np.int64).tolist()
        # chained: the carry goes straight back in (the JAX arrays, the port's views)
        want2 = jloop(jeng.params, jeng.rope, want[1], jeng.k_cache, jeng.v_cache,
                      want[2], want[3], args["temperature"], args["topp"], [3, 4],
                      jtables)
        jeng.k_cache, jeng.v_cache = want2[4], want2[5]
        got2 = loop(eng.rope, got[1], eng.k_cache, eng.v_cache, got[2], got[3],
                    args["temperature"], args["topp"], [3, 4], tables)
        for g, w in zip(got2[:4], want2[:4]):
            assert g.tolist() == np.asarray(w).astype(np.int64).tolist()
    finally:
        be.close()
        for jsl in jbe._slots:  # its rows were overwritten: no prefix reuse from them
            jsl.history = []


@pytest.mark.parametrize("pipeline", [False, True])
def test_sampler_state_resync_after_mid_block_stop(files, jax_engines, pipeline):
    """A stop inside a block discards the tail, whose coins must not advance the
    caller's sampler: a sampler reused for a second request sees one unbroken stream,
    as in the JAX engine. The JAX engine writes the sampler's state after the request's
    done is set, so its side is read only after a barrier: a third one-token request
    (another sampler) that the single scheduler thread serves after that write. The
    port's engine writes it first (test_torch_speculative.py
    test_sampler_state_final_before_done) and is read at once."""
    results = []
    for be in (jax_engines[pipeline], _port(files, pipeline=pipeline)):
        smp_cls = JSampler if isinstance(be, JBatchEngine) else Sampler
        smp = smp_cls(V, temperature=0.9, topp=0.9, seed=99)
        seen = []
        first = be.submit([1, 7, 23], 16, smp,
                          stop_check=lambda t: seen.append(t) or len(seen) >= 6).wait(300)
        second = be.submit([1, 5, 2], 8, smp).wait(timeout=300)
        if isinstance(be, JBatchEngine):
            be.submit([1, 4], 1, smp_cls(V, 0.0)).wait(timeout=300)  # the barrier
        results.append((first, second, int(smp.state)))
        if isinstance(be, BatchEngine):
            be.close()
    assert results[0] == results[1]
    assert len(results[1][0]) == 6


def test_mid_block_stop_rolls_back_and_flushes(files):
    """A greedy stop inside a block: the output ends at the stop, the chained dispatch
    is flushed ("stop"), and the slot stays consistent: the same prompt again gives the
    full output."""
    be = _port(files, pipeline=True)
    try:
        full = be.submit([1, 2, 3], 12, Sampler(V, 0.0)).wait(timeout=300)
        seen = []
        got = be.submit([1, 2, 3], 12, Sampler(V, 0.0),
                        stop_check=lambda t: seen.append(t) or len(seen) == 6).wait(300)
        assert got == full[:6]
        assert be.flushes["stop"] >= 1 and be.rollback_tokens > 0
        assert be.submit([1, 2, 3], 12, Sampler(V, 0.0)).wait(timeout=300) == full
    finally:
        be.close()


@pytest.mark.parametrize("pipeline", [False, True])
def test_cancel_during_block(files, pipeline):
    """cancel() seen while a block is delivered stops the stream at the next token,
    discards the decoded tail (and a chained dispatch), frees the slot, and the engine
    keeps serving."""
    be = _port(files, pipeline=pipeline)
    try:
        box = []

        def on_token(_t):
            if len(box[0].out) == 2:
                box[0].cancel()
        req = be.submit([1, 8, 2], 40, Sampler(V, 0.0), on_token=on_token)
        box.append(req)
        assert req.wait(timeout=300) == req.out and len(req.out) == 2
        assert req.finish == "cancelled" and be.rollback_tokens > 0
        assert len(be.submit([1, 8, 2], 4, Sampler(V, 0.0)).wait(timeout=300)) == 4
        assert be._inflight is None
    finally:
        be.close()


def test_admission_breaks_the_chain(files, jax_engines):
    """A request submitted while the pipeline runs (from the first request's 6th token)
    breaks the chain ("admission") and is admitted; both get the JAX engine's tokens."""
    outs = []
    for be in (jax_engines[True], _port(files, pipeline=True)):
        smp_cls = JSampler if isinstance(be, JBatchEngine) else Sampler
        box = []

        def on_token(_t, be=be, smp_cls=smp_cls):
            if len(box[0].out) == 6:
                box.append(be.submit([1, 9, 2, 40, 41, 42, 43, 44], 12, smp_cls(V, 0.0)))
        box.append(be.submit([1, 7, 23, 5], 30, smp_cls(V, 0.0), on_token=on_token))
        outs.append([box[0].wait(timeout=300), box[1].wait(timeout=300)])
        if isinstance(be, BatchEngine):
            assert be.flushes["admission"] >= 1 and be.chained >= 1
            be.close()
    assert outs[0] == outs[1]


def test_one_host_fence_per_k_tokens(files):
    """n tokens of steady decode cost at most ceil((n - 1) / K) super-steps plus the
    host-sampled first token's step: one fence (the block's host copy) per K tokens."""
    be = _port(files, pipeline=True)
    try:
        n, k = 25, be.superstep
        assert len(be.submit([1, 3, 5], n, Sampler(V, 0.0)).wait(timeout=300)) == n
        assert be.super_steps >= (n - 1) // k
        assert be.decode_steps <= -(-(n - 1) // k) + 1
        assert be.loop_steps == k * (be.super_steps + sum(be.flushes.values()))
    finally:
        be.close()


def test_superstep_matches_superstep_1(files):
    """The port's super-steps, pipelined, give its own single steps' greedy tokens."""
    outs = []
    for kw in (dict(superstep=1), dict(superstep=4, pipeline=True)):
        be = BatchEngine.load(*files, slots=2, device="cpu", **kw)
        try:
            outs.append(staggered(be, Sampler, 0.0)[0])
        finally:
            be.close()
    assert outs[0] == outs[1]


def test_budget_clamps_at_context_end(tmp_path):
    """Rows within K of seq_len park mid-block and finish "length" with their bounds
    intact, pipelined or not, with the JAX engine's tokens."""
    files16 = _files(tmp_path, 16, 3)
    jbe = JBatchEngine.load(*files16, slots=2, tp=1, superstep=8, pipeline=True,
                            prefix_cache=False)
    try:
        want = jbe.submit([1, 2, 3, 4], 100, JSampler(V, 0.0)).wait(timeout=300)
    finally:
        jbe.close()
    for pipeline in (False, True):
        be = BatchEngine.load(*files16, slots=2, device="cpu", superstep=8,
                              pipeline=pipeline, prefix_cache=False)
        try:
            req = be.submit([1, 2, 3, 4], 100, Sampler(V, 0.0))
            assert req.wait(timeout=300) == want
            assert req.finish == "length" and 0 < len(want) <= 16
            for slot in be._slots:
                assert slot.pos <= 16 and len(slot.history) <= 16
        finally:
            be.close()


def test_kernel_route_superstep_on_the_cpu(files):
    """The fused kernel configuration's super-steps (the kernels' plain versions on the
    CPU: the paged-attention route with per-row device positions) against its single
    steps."""
    outs = []
    for k in (1, 4):
        be = BatchEngine.load(*files, slots=2, device="cpu", superstep=k,
                              use_kernels=True, fused_matmul=True)
        try:
            assert be.engine.paged_kernel
            outs.append(staggered(be, Sampler, 0.0)[0])
        finally:
            be.close()
    assert outs[0] == outs[1]
    assert torch.is_tensor(be.engine.k_cache)


def test_server_flags_build_a_pipelined_superstep_engine(files):
    """api_server --batch N serves super-steps of 8, pipelined, unless told otherwise."""
    from distributed_llama_tpu_torch.apps import api_server

    base = ["--model", files[0], "--tokenizer", files[1], "--batch", "2", "--device",
            "cpu", "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2"]
    for extra, k, pipelined in (([], 8, True), (["--superstep", "4", "--no-pipeline"], 4,
                                                False), (["--superstep", "1"], 1, False)):
        srv = api_server.build_server(api_server.build_parser().parse_args(base + extra))
        be = srv.api_state.batch_engine
        try:
            assert (be.superstep, be.pipeline) == (k, pipelined)
        finally:
            srv.server_close()
            be.close()
