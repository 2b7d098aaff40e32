"""PyTorch port: the continuous-batching BatchEngine (runtime/batch_engine.py) against
the JAX package's BatchEngine in the same configuration (tp=1, superstep=1,
pipeline=False, prefix_cache=False) on one tiny `.m`/`.t` pair (super-steps:
tests/test_torch_superstep.py).

Requests are staggered deterministically: request i+1 is submitted from request i's
token callback after its third token, so both engines see the same schedule — prefill
chunks with decode rows riding them, then batched decode steps — and every request must
get the same tokens, greedy and seeded-stochastic. The fused configuration (the q4
kernels with the residual and gate-pair epilogues, and the paged-attention kernel; their
plain versions on the CPU) is held against the JAX engine with the Pallas kernels in
interpret mode: greedy identity, with the kernel selections showing every fused route."""

import threading
import time
from collections import Counter

import pytest

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.cache.device_pool import KVPoolExhausted
from distributed_llama_tpu_torch.ops import matmul as tmm
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 262
PROMPTS = [[1] + list(range(3, 30)), [1, 5, 9, 11, 40, 41, 42, 43, 44, 45, 46],
           [1] + list(range(60, 130))]


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    # dim 256 and hidden 256: K/2 = 128 passes the q4 kernels' shape gate everywhere
    tmp = tmp_path_factory.mktemp("torch_batch")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=256, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=V, seq_len=128).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=3)
    mpath = str(tmp / "model.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [
        b" ", b"ab", b"cd"]
    tpath = str(tmp / "tok.t")
    write_tokenizer(tpath, TokenizerData(vocab=vocab,
                                         scores=[0.0] * 259 + [-1.0, -2.0, -3.0],
                                         bos_id=1, eos_id=2, max_token_length=4))
    return mpath, tpath


def staggered(be, sampler_cls, temperature, prompts=PROMPTS, max_tokens=10, after=3):
    """Submit prompts[0]; submit prompts[i+1] from request i's callback after `after`
    tokens. Returns each request's tokens (or its exception)."""
    reqs = [None] * len(prompts)

    def submit(i):
        n = [0]

        def on_token(_tok):
            n[0] += 1
            if n[0] == after and i + 1 < len(prompts):
                submit(i + 1)
        reqs[i] = be.submit(prompts[i], max_tokens,
                            sampler_cls(V, temperature, 0.9, seed=100 + i),
                            on_token=on_token)
    try:
        submit(0)
        reqs[0].wait(timeout=300)
        outs = []
        for i in range(len(prompts)):
            assert reqs[i] is not None, f"request {i} was never submitted"
            try:
                outs.append(reqs[i].wait(timeout=300))
            except Exception as e:  # noqa: BLE001 — the caller inspects it
                outs.append(e)
        return outs
    finally:
        be.close()


@pytest.mark.parametrize("temperature,paged", [(0.0, True), (0.8, True), (0.0, False)])
def test_token_identity_with_jax_batch_engine(model_files, temperature, paged):
    mpath, tpath = model_files
    jbe = JBatchEngine.load(mpath, tpath, slots=3, tp=1, superstep=1, pipeline=False,
                            prefix_cache=False, paged_kv=paged)
    want = staggered(jbe, JSampler, temperature)
    be = BatchEngine.load(mpath, tpath, slots=3, device="cpu", paged_kv=paged,
                          prefix_cache=False)
    assert (be.kv_pool is not None) == paged and be.engine.use_kernels is False
    got = staggered(be, Sampler, temperature)
    assert got == want and all(len(o) == 10 for o in got)
    assert be.mixed_steps > 0 and be.decode_steps > 0  # the schedule really mixed


def test_fused_kernels_token_identity_with_jax(model_files):
    mpath, tpath = model_files
    jbe = JBatchEngine.load(mpath, tpath, slots=3, tp=1, superstep=1, pipeline=False,
                            prefix_cache=False, use_pallas=True, fused_matmul=True,
                            paged_kernel=True)
    want = staggered(jbe, JSampler, 0.0)
    tmm.reset_kernel_selections()
    be = BatchEngine.load(mpath, tpath, slots=3, device="cpu", use_kernels=True,
                          fused_matmul=True, prefix_cache=False)
    assert be.engine.use_kernels == "fused" and be.engine.paged_kernel
    assert "w1" in be.engine.params["blocks"]  # the gate pair stays unmerged
    got = staggered(be, Sampler, 0.0)
    assert got == want
    assert set(tmm.kernel_selections().values()) == {"q4_mm", "q4_mm+res", "q4_gated_mm"}


def test_pool_exhaustion_fails_only_the_starving_request(model_files):
    """A pool of one context (8 blocks of 16) plus scratch and a spare cannot hold two
    long requests: exactly one fails with KVPoolExhausted, the other gets the tokens it
    gets alone, and the engine keeps serving."""
    mpath, tpath = model_files
    prompts = [[1] + list(range(3, 80)), [1] + list(range(90, 160))]
    solo = []
    for p in prompts:
        be = BatchEngine.load(mpath, tpath, slots=1, device="cpu")
        solo.append(be.generate(p, 30, Sampler(V))[0])
        be.close()
    be = BatchEngine.load(mpath, tpath, slots=2, device="cpu", kv_pool_blocks=10)
    try:
        reqs = [be.submit(p, 30, Sampler(V)) for p in prompts]
        for r in reqs:
            r.done.wait(300)
        failed = [isinstance(r.error, KVPoolExhausted) for r in reqs]
        assert sum(failed) == 1, [r.error for r in reqs]
        ok = failed.index(False)
        assert reqs[ok].out == solo[ok]
        assert be.scheduler_alive()
        assert len(be.submit([1, 9, 9], 6, Sampler(V)).wait(300)) == 6
        assert be.release_idle() == be.kv_pool.n_blocks - 1  # all free but scratch
    finally:
        be.close()


def _settled(be) -> None:
    """Wait until every prefix lease is released (the harvest runs just after a
    request's done.set())."""
    t0 = time.monotonic()
    while be.prefix_cache.total_refs():
        assert time.monotonic() - t0 < 60, "prefix leases still held"
        time.sleep(0.01)


def test_release_idle_races_the_scheduler_safely(model_files):
    """release_idle from another thread while staggered requests run, under a pool small
    enough that the scheduler reclaims idle slots and the prefix directory itself: every
    request still gets its tokens, and the refcounts end consistent with the slots' tables
    and the directory's nodes."""
    mpath, tpath = model_files
    be = BatchEngine.load(mpath, tpath, slots=3, device="cpu", kv_pool_blocks=12)
    stop = threading.Event()

    def hammer():
        while not stop.wait(0.001):
            be.release_idle()

    t = threading.Thread(target=hammer)
    t.start()
    try:
        outs = staggered(be, Sampler, 0.0, prompts=[p[:40] for p in PROMPTS] * 2,
                         max_tokens=6, after=2)
    finally:
        stop.set()
        t.join(60)
    assert all(isinstance(o, list) and len(o) == 6 for o in outs), outs
    _settled(be)
    with be._slock:
        # one reference per slot table entry and per directory node on a device block
        held = Counter(b for sl in be._slots for b in sl.blocks)
        stack = list(be.prefix_cache.radix.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.handle[0] == "dev":
                held[node.handle[1]] += 1
        refs = be.kv_pool.refcounts()
    assert refs[0] == 1
    assert [int(r) for r in refs[1:]] == [held[b] for b in range(1, len(refs))]
    assert be.release_idle() == be.kv_pool.n_blocks - 1


@pytest.mark.parametrize("kw", [dict(speculative=1, draft_model="draft.m"),
                                dict(draft_model="draft.m"),
                                dict(tenants=object()), dict(slo_ttft_interactive=1.0)])
def test_out_of_slice_arguments_raise(model_files, kw):
    with pytest.raises(NotImplementedError):
        BatchEngine.load(*model_files, slots=2, device="cpu", **kw)
