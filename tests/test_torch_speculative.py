"""PyTorch port: prompt-lookup speculative decoding (runtime/speculative.py, the Engine's
generate_speculative, make_batched_verify_loop and BatchEngine(speculative=K)) against
the JAX package on one tiny `.m` file (dim 64, 2 layers, Q40, weight seed 11) and the
repetitive prompts of tests/test_batched_spec.py.

Tolerances: the copied proposer, buckets and controller are held exactly (same
answers on the same inputs); the verify loop's targets, accepted lengths, carry tokens,
positions and xorshift* states exactly; every engine case token for token, with equal
final sampler states, finish reasons and, where the schedule is serialized, equal
(output length, drafted, accepted) turns. On the CPU the verify runs eagerly: the step
function a CUDA graph captures on the card.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime import speculative as jspec
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.runtime import speculative as spec_mod
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 256
K = 8
REP = [5, 9, 17, 3, 44, 9, 17, 3]
REP2 = [7, 31, 5, 102, 9, 31, 5, 77]


def _write(path, seq_len: int) -> str:
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=V, seq_len=seq_len).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=11)
    write_model(str(path), spec, params_file_order(spec, params), FloatType.Q40)
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec")
    return {256: _write(d / "m256.m", 256), 64: _write(d / "m64.m", 64)}


def _pair(models, seq_len=256, **kw):
    """(JAX engine, port engine) on the same file and configuration."""
    kw.setdefault("prefix_cache", False)
    return (JBatchEngine.load(models[seq_len], tp=1, **kw),
            BatchEngine.load(models[seq_len], device="cpu", **kw))


def _jobs_run(be, jobs, timeout=300):
    """Submit [(prompt, n, sampler factory args, kw)]; returns outputs, final sampler
    states, finish reasons and the requests."""
    smp_cls = JSampler if isinstance(be, JBatchEngine) else Sampler
    reqs = [be.submit(list(p), n, smp_cls(V, *sargs), **kw) for p, n, sargs, kw in jobs]
    outs = [r.wait(timeout=timeout) for r in reqs]
    return outs, [int(r.sampler.state) for r in reqs], [r.finish for r in reqs], reqs


# ---------------------------------------------------------------- the copies


def _corpora():
    rs = np.random.RandomState(3)
    return [rs.randint(0, 6, size=300).tolist(), list(range(50, 90)), REP * 6 + REP2,
            [], [4]]


@pytest.mark.parametrize("which", range(5))
def test_proposers_match_jax(which):
    """propose_ngram and NgramIndex (propose, propose_extended) at every append point,
    exactly as the JAX package's."""
    toks = _corpora()[which]
    idx, jidx = spec_mod.NgramIndex(toks[:3]), jspec.NgramIndex(toks[:3])
    for i in range(3, len(toks) + 1):
        for k in (1, 4, 8):
            assert spec_mod.propose_ngram(toks[:i], k) == jspec.propose_ngram(toks[:i], k)
            assert idx.propose(k) == jidx.propose(k)
            assert idx.propose_extended(k) == jidx.propose_extended(k)
        if i < len(toks):
            idx.append(toks[i])
            jidx.append(toks[i])
    assert idx.entries == jidx.entries


def test_ngram_index_cap_matches_jax():
    """The memory cap's rebuild keeps the same window and answers as the JAX index."""
    rs = np.random.RandomState(5)
    toks = rs.randint(0, 40, size=3000).tolist()
    idx = spec_mod.NgramIndex([], max_entries=512)
    jidx = jspec.NgramIndex([], max_entries=512)
    for t in toks:
        idx.append(t)
        jidx.append(t)
        assert idx.entries == jidx.entries
        assert idx.propose_extended(8) == jidx.propose_extended(8)


def test_buckets_and_adaptive_k_match_jax():
    """verify_block_bucket, draft_buckets, and AdaptiveK under one random sequence of
    attach / observe / tick / detach: the same k and EMA at every turn."""
    for t in range(1, 40):
        for cap in (2, 3, 9, 17, 33):
            assert spec_mod.verify_block_bucket(t, cap) == jspec.verify_block_bucket(t, cap)
    for k in range(1, 40):
        assert spec_mod.draft_buckets(k) == jspec.draft_buckets(k)
    rs = np.random.RandomState(9)
    for k_cap in (1, 4, 8):
        a, ja = spec_mod.AdaptiveK(k_cap), jspec.AdaptiveK(k_cap)
        for _ in range(400):
            row, op = int(rs.randint(0, 3)), rs.randint(0, 10)
            if op == 0:
                a.attach(row), ja.attach(row)
            elif op == 1:
                a.detach(row), ja.detach(row)
            elif op == 2:
                a.tick(row), ja.tick(row)
            else:
                d = int(rs.randint(0, k_cap + 1))
                acc = int(rs.randint(0, d + 1))
                a.observe(row, d, acc), ja.observe(row, d, acc)
            assert a.k_for(row) == ja.k_for(row)
            assert a.stats() == ja.stats()


def test_ngram_proposer_matches_jax():
    """NgramProposer, which the BatchEngine drafts through: the same drafts and probes
    as the JAX one on the same rows, through attach / push / observe / detach."""
    prop = spec_mod.NgramProposer()
    jprop = jspec.NgramProposer()
    for m in (prop, jprop):
        m.attach(0, [1] + REP * 3)
        m.attach(1, [1, 2] + REP2 * 2)
        m.attach(2, [1, 2, 3])
    for step, tok in enumerate([9, 17, 3, 44, 77, 7, 31]):
        want = {0: 8, 1: 3, 2: 4}
        assert prop.propose_batch(want) == jprop.propose_batch(want)
        for row in range(3):
            assert prop.ready(row, 8, 1) == jprop.ready(row, 8, 1)
            prop.push(row, tok), jprop.push(row, tok)
            prop.observe(row, step % 3), jprop.observe(row, step % 3)
    prop.detach(1), jprop.detach(1)
    assert prop.propose(1, 4) == jprop.propose(1, 4) == []
    assert prop.name == jprop.name


# --------------------------------------------------------- the verify loop


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_batched_verify_loop_matches_jax(models, mode):
    """make_batched_verify_loop against the JAX one on the same zeroed paged pools: three
    rows (two live, one parked with ndraft -1), a first block of arbitrary drafts, then
    two blocks whose drafts are the previous block's targets (turn n accepts at least
    n - 1 of them);
    targets, accepted lengths, carry tokens, positions and xorshift* states equal."""
    jbe, be = _pair(models, slots=3, superstep=4, speculative=K)
    try:
        t = 5
        starts = [9, 5, 12]
        for sl, jsl, n in zip(be._slots, jbe._slots, starts):
            be._paged_ensure(sl, n + 2 * t)
            jbe._paged_ensure(jsl, n + 2 * t)
        tables, jtables = be._tables(), jbe._tables()
        jeng, eng = jbe._eng, be.engine
        jeng.k_cache = jnp.zeros_like(jeng.k_cache)
        jeng.v_cache = jnp.zeros_like(jeng.v_cache)
        temps = [0.0, 0.02, 0.9] if mode == "sample" else [0.0, 0.0, 0.0]
        rng = np.array([[0x12345678, 0x9ABCDEF0], [3, 99], [7, 0xFFFFFFFF]], np.int64)
        jloop, loop = jbe._verify_loop(t, mode, None), be._verify_loop(t, mode, None)
        props = [[7, 1, 2, 3, 4], [8, 5, 6, 0, 0], [0, 0, 0, 0, 0]]
        ndraft = [4, 2, -1]
        for _turn in range(3):
            want = jloop(jeng.params, jeng.rope, props, jeng.k_cache, jeng.v_cache, starts,
                         rng.astype(np.uint32), temps, [0.9] * 3, ndraft, jtables)
            jeng.k_cache, jeng.v_cache = want[5], want[6]
            got = loop(eng.rope, props, eng.k_cache, eng.v_cache, starts, rng, temps,
                       [0.9] * 3, ndraft, tables)
            for g, w in zip(got[:5], want[:5]):
                assert g.tolist() == np.asarray(w).astype(np.int64).tolist()
            targets = np.asarray(want[0])
            # the next block: each live row's drafts follow its targets (accept >= 2)
            props = [[props[0][0]] + targets[:4, 0].tolist(),
                     [props[1][0]] + targets[:2, 1].tolist() + [0, 0], props[2]]
        assert int(got[1][0]) >= 2
        assert int(got[3][2]) == starts[2]  # the parked row stays at its position
    finally:
        be.close()
        jbe.close()


# ------------------------------------------------------ the single sequence


@pytest.mark.parametrize("case", ["plain", "stop", "context_end", "padded"])
def test_generate_speculative_matches_jax(models, case):
    """Engine.generate_speculative against the JAX one: tokens, verify turns and the
    final position equal; also equal to generate(). "stop" stops inside an accepted
    block; "context_end" runs a 64-token context to its end (a block whose bucket would
    pass the end runs at its own length); "padded" also checks that every block ran at
    its verify bucket while JAX's ran at their raw lengths."""
    seq_len = 64 if case == "context_end" else 256
    jeng = JEngine.load(models[seq_len], tp=1)
    eng = Engine.load(models[seq_len], device="cpu")
    blocks = []
    step_block = eng._step_block
    eng._step_block = lambda toks, window: blocks.append(toks.shape[1]) or step_block(
        toks, window)
    prompt = [1] + REP * (3 if case == "context_end" else 6)
    n = 64 if case == "context_end" else 48
    kw = {}
    if case == "stop":
        _, probe = jeng.generate_speculative(list(prompt), n, JSampler(V, 0.0), k=K)
        n0 = next(t[0] for t in probe.spec_turns if t[2] >= 2)
        jeng.reset()
        seen = []
        kw["stop_check"] = lambda tok, j=n0 + 1: seen.append(tok) or len(seen) - 1 == j
    want, wstats = jeng.generate_speculative(list(prompt), n, JSampler(V, 0.0), k=K, **kw)
    if "stop_check" in kw:
        seen.clear()
    got, stats = eng.generate_speculative(list(prompt), n, Sampler(V, 0.0), k=K, **kw)
    assert got == want and stats.spec_turns == wstats.spec_turns
    assert (stats.spec_steps, stats.spec_drafted, stats.spec_accepted) == (
        wstats.spec_steps, wstats.spec_drafted, wstats.spec_accepted)
    assert eng.pos == jeng.pos
    assert stats.spec_accepted >= 1
    if "stop_check" in kw:
        seen.clear()
    eng.reset()
    plain, _ = eng.generate(list(prompt), n, Sampler(V, 0.0), **kw)
    assert got == plain
    if case == "context_end":
        assert len(got) == seq_len - len(prompt)  # the host loop stops at pos == seq_len
    if case == "stop":
        assert len(got) == n0 + 2
    if case == "padded":
        assert blocks and set(blocks) <= {2, 3, 5, 9}
        assert any(d + 1 not in (2, 3, 5, 9) for _, d, _ in stats.spec_turns)


def test_generate_with_dispatches_speculative(models, capsys):
    """generate_with(speculative_k=) speculates a greedy request and falls back, with
    one warning per engine, for a sampled one; the sampled tokens are generate()'s."""
    eng = Engine.load(models[256], device="cpu")
    prompt = [1] + REP * 6
    _, stats = eng.generate_with(prompt, 16, Sampler(V, 0.0), speculative_k=K)
    assert stats.spec_steps >= 1
    outs = []
    for _ in range(2):
        eng.reset()
        out, stats = eng.generate_with(prompt, 8, Sampler(V, 0.8, 0.9, seed=3),
                                       speculative_k=K)
        assert stats.spec_steps == 0
        outs.append(out)
    eng.reset()
    assert outs[0] == outs[1] == eng.generate(prompt, 8, Sampler(V, 0.8, 0.9, seed=3))[0]
    assert capsys.readouterr().err.count("greedy-only") == 1


# ------------------------------------------------------ the batched engine

# test_batched_spec.py's cases: (prompt, max_tokens, sampler arguments)
GREEDY = [([1] + REP * 6, 48, (0.0,)), ([1, 2] + REP2 * 5, 48, (0.0,))]
STOCH = [([1] + REP * 6, 48, (0.02, 0.9, 42))]
MIXED = [([1] + REP * 6, 40, (0.0,)), ([1, 2] + REP2 * 5, 40, (0.8, 0.9, 7))]
STORM = [([1, 3 + i] + REP * 4, 1 + (i % 2), (0.0,)) for i in range(6)] + [
    ([1] + REP * 6, 40, (0.0,))]


@pytest.fixture(scope="module")
def shared(models):
    """The shared engines of test_batched_spec.py (2 slots, superstep K, pipelined)."""
    jbe, be = _pair(models, slots=2, superstep=K, speculative=K)
    yield jbe, be
    be.close()
    jbe.close()


@pytest.mark.parametrize("jobs", ["greedy", "stochastic", "mixed", "storm"])
def test_batch_engine_matches_jax(shared, jobs):
    """The port's BatchEngine(speculative=8) against the JAX one: tokens, final sampler
    states and finish reasons equal, verify dispatches engaged and accepting, and the
    same tokens with speculation off. "storm" interleaves 1-2 token requests with a
    long one (pipeline flushes while verifies engage): no slot or lease stays held."""
    jbe, be = shared
    spec_jobs = {"greedy": GREEDY, "stochastic": STOCH, "mixed": MIXED, "storm": STORM}
    js = [(p, n, s, {}) for p, n, s in spec_jobs[jobs]]
    want = _jobs_run(jbe, js)
    got = _jobs_run(be, js)
    assert got[:3] == want[:3]
    reqs = got[3]
    if jobs != "storm":
        assert sum(r.stats.spec_steps for r in reqs) >= 1
        assert sum(r.stats.spec_accepted for r in reqs) >= 1
    k = be.spec_k
    try:
        be.spec_k = 0
        off = _jobs_run(be, js)
    finally:
        be.spec_k = k
    assert off[:3] == got[:3]
    with be._slock:
        assert all(s.req is None and s.lease is None for s in be._slots)
    assert be.scheduler_alive()
    assert be.verify_steps > 0 and be.spec_stats()["verify_steps"] == be.verify_steps


def _stop_at(j):
    seen = [0]

    def check(_t):
        seen[0] += 1
        return seen[0] - 1 == j
    return check


@pytest.mark.parametrize("pipeline", [False, True])
def test_stop_mid_accepted_block_matches_jax(models, pipeline):
    """A stop inside an accepted block: the output ends at the stop, the sampler
    replays only the delivered coins (its state equal to the JAX engine's and to the
    speculation-off run's), and the same verify turns as the JAX engine."""
    jbe, be = _pair(models, slots=2, superstep=K, speculative=K, pipeline=pipeline)
    try:
        prompt = [1] + REP * 6
        # the probe runs on both engines, so both start the stop run with one history
        probe = _jobs_run(jbe, [(prompt, 48, (0.02, 0.9, 42), {})])
        assert _jobs_run(be, [(prompt, 48, (0.02, 0.9, 42), {})])[:3] == probe[:3]
        n0 = next(t[0] for t in probe[3][0].stats.spec_turns if t[2] >= 2)
        runs = [_jobs_run(e, [(prompt, 48, (0.02, 0.9, 42), {"stop_check": _stop_at(n0 + 1)})])
                for e in (jbe, be)]
        assert runs[1][:3] == runs[0][:3]
        assert runs[1][0][0] == probe[0][0][:n0 + 2] and runs[1][2] == ["stop"]
        assert runs[1][3][0].stats.spec_turns == runs[0][3][0].stats.spec_turns
        last = runs[1][3][0].stats.spec_turns[-1]
        assert last[0] + last[2] + 1 > len(runs[1][0][0])  # the block went past the stop
        be.spec_k = 0
        off = _jobs_run(be, [(prompt, 48, (0.02, 0.9, 42), {"stop_check": _stop_at(n0 + 1)})])
        assert off[:3] == runs[1][:3]
    finally:
        be.close()
        jbe.close()


def test_context_end_clamp_matches_jax(models):
    """Rows decoding to the end of a 64-token context: the block shrinks so live writes
    stay inside the cache, the output equals the JAX engine's and the spec-off run's,
    and the request finishes "length" at pos == seq_len."""
    jbe, be = _pair(models, 64, slots=2, superstep=4, speculative=K)
    try:
        prompt = [1] + REP * 3
        js = [(prompt, 64, (0.0,), {})]
        want, got = _jobs_run(jbe, js), _jobs_run(be, js)
        assert got[:3] == want[:3] and got[2] == ["length"]
        assert len(got[0][0]) == 64 - len(prompt) + 1
        assert got[3][0].stats.spec_accepted >= 1
        be.spec_k = 0
        assert _jobs_run(be, js)[:3] == got[:3]
    finally:
        be.close()
        jbe.close()


def test_accept_length_oracle_and_sequential_match(models):
    """A serialized engine (1 slot, no pipelining): every verify turn equals the JAX
    engine's, and each turn's (drafted, accepted) is what the sequential algorithm
    computes at that point of the (identical) greedy stream; generate_speculative emits
    the same tokens."""
    jbe, be = _pair(models, slots=1, superstep=K, speculative=K, pipeline=False)
    try:
        prompt = [1] + REP * 6
        n = 48
        js = [(prompt, n, (0.0,), {})]
        want, got = _jobs_run(jbe, js), _jobs_run(be, js)
        out, req = got[0][0], got[3][0]
        assert out == want[0][0] and req.stats.spec_turns == want[3][0].stats.spec_turns
        assert req.stats.spec_steps >= 2
        for n_out, drafted, accepted in req.stats.spec_turns:
            cap = min(K, n - n_out - 1, 256 - (len(prompt) - 1 + n_out) - 2)
            draft = spec_mod.NgramIndex(prompt + out[:n_out]).propose_extended(cap)
            assert drafted <= len(draft)
            ok = 0
            for i, d in enumerate(draft[:drafted]):
                if n_out + i < len(out) and d == out[n_out + i]:
                    ok += 1
                else:
                    break
            assert accepted == min(ok, drafted)
        seq, _ = Engine.load(models[256], device="cpu").generate_speculative(
            list(prompt), n, Sampler(V, 0.0), k=K)
        assert seq == out
    finally:
        be.close()
        jbe.close()


def test_prefix_cache_after_verify_heavy_request(models):
    """With the prefix cache on, a verify-heavy request's history joins the directory
    only up to its verified frontier (rejected KV past it never counts as committed):
    a later prompt sharing its blocks is a hit, and its tokens equal the cache-off
    engine's and the JAX engine's with the cache on."""
    jbe, be = _pair(models, slots=2, superstep=K, speculative=K, prefix_cache=True)
    off = BatchEngine.load(models[256], device="cpu", slots=2, superstep=K,
                           speculative=K, prefix_cache=False)
    try:
        first = [1] + REP * 6
        runs = []
        for e in (jbe, be, off):
            a = _jobs_run(e, [(first, 40, (0.0,), {})])
            # the hit: the first request's prompt and 24 of its tokens, then a new tail;
            # a displacing prompt takes the first request's slot (not a rewind)
            _jobs_run(e, [([1, 2, 3, 4] * 9, 4, (0.0,), {}), ([1, 4, 2] * 7, 4, (0.0,), {})])
            b = _jobs_run(e, [(first + a[0][0][:24] + [60, 61], 24, (0.0,), {})])
            runs.append((a[:3], b[:3]))
        assert runs[0] == runs[1] == runs[2]
        assert be.spec_accepted > 0
        with be._slock:
            assert be.prefix_cache.stats()["hits"] >= 1
    finally:
        for e in (be, off, jbe):
            e.close()


# ------------------------------------------------ the sampler-resync race


class _SnapEvent(threading.Event):
    """A request's done event that records the sampler's state at the moment the
    engine sets it: what a waiter woken by wait() can read."""

    def __init__(self, smp):
        super().__init__()
        self.smp = smp
        self.seen = None

    def set(self):
        self.seen = int(self.smp.state)
        super().set()


@pytest.mark.parametrize("kind", ["super_step", "super_step_pipelined", "verify"])
def test_sampler_state_final_before_done(models, kind):
    """A stochastic request that stops inside a delivered block: its sampler state is
    final (the delivered tokens' coins only) when done is set, not written after the
    waiter wakes. The event is swapped in while the scheduler is held off the request
    (its lock), so the check does not depend on timing."""
    spec_k = K if kind == "verify" else 0
    be = BatchEngine.load(models[256], device="cpu", slots=2, superstep=4,
                          pipeline=kind != "super_step", speculative=spec_k,
                          prefix_cache=False)
    try:
        prompt = [1] + REP * 6
        temp = (0.02, 0.9, 42) if kind == "verify" else (0.9, 0.9, 99)
        j = 5
        if kind == "verify":
            probe = _jobs_run(be, [(prompt, 48, temp, {})])[3][0]
            j = next(t[0] for t in probe.stats.spec_turns if t[2] >= 2) + 1
        smp = Sampler(V, *temp)
        with be._slock:
            req = be.submit(prompt, 48, smp, stop_check=_stop_at(j))
            req.done = _SnapEvent(smp)
        out = req.wait(timeout=300)
        assert len(out) == j + 1 and req.finish == "stop"
        assert req.done.seen == int(smp.state)
        want = Sampler(V, *temp)
        for _ in out:
            want.next_coin()
        assert int(smp.state) == int(want.state)
        if kind == "verify":
            assert req.stats.spec_accepted >= 1
        else:
            assert be.super_steps >= 1
    finally:
        be.close()
