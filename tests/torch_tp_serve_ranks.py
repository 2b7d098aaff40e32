"""Rank-side work of tests/test_torch_tp_serve.py, run on every rank of a world that
distributed_llama_tpu_torch.parallel.launch starts. Imports torch and the port only: a
rank never imports jax or the JAX package.

The request scripts (`staggered`, `prefix_cycle`, `dense_cycle`, `spec_jobs`,
`grammar_jobs`) take an
engine and its Sampler class, so the test runs the same requests on the JAX BatchEngine
in its own process. On a rank, `batch_cases` builds one BatchEngine(tp=) per case: rank 0
runs the script and closes the engine, every other rank follows it; each rank returns
its device-sampled token blocks in issue order (BatchEngine.token_log) for the test to
hold against rank 0's."""

from __future__ import annotations

import time

from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 256
EOS = 2
PROMPTS = [[1, 7, 23, 5], [1, 9, 2, 40, 41, 42, 43, 44, 45, 46, 47], [1, 3, 5]]
MAX_TOKENS = [17, 6, 11]  # mixed budgets: rows park mid-block at different steps
SHARED = [1] + [10 + (i * 7) % 90 for i in range(33)]  # 34 tokens: 4 blocks of 8
REP = [5, 9, 17, 3, 44, 9, 17, 3]
REP2 = [7, 31, 5, 102, 9, 31, 5, 77]
SCHEMA = {"type": "object", "properties": {
    "name": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}


def staggered(be, smp_cls, temp, seed=100):
    """PROMPTS[0], then PROMPTS[i+1] from request i's callback after 3 tokens (on the
    scheduler thread, so every engine sees one schedule). Returns the outputs and each
    sampler's final state."""
    reqs, samplers = [None] * len(PROMPTS), [None] * len(PROMPTS)

    def submit(i):
        n = [0]

        def on_token(_t):
            n[0] += 1
            if n[0] == 3 and i + 1 < len(PROMPTS):
                submit(i + 1)
        samplers[i] = smp_cls(V, temp, 0.9, seed=seed + i)
        reqs[i] = be.submit(PROMPTS[i], MAX_TOKENS[i], samplers[i], on_token=on_token)
    submit(0)
    reqs[0].wait(timeout=300)
    outs = [r.wait(timeout=300) for r in reqs]
    return outs, [int(s.state) for s in samplers]


def concurrent(be, smp_cls):
    """Two greedy prompts submitted together (tests/test_batch_engine.py's): outputs."""
    reqs = [be.submit(list(p), 10, smp_cls(V, 0.0)) for p in ([1, 7, 23, 5], [1, 9, 2])]
    return [r.wait(timeout=300) for r in reqs]


def _settle(be):
    """Every lease released and the last finish's harvest landed (it runs just after
    done.set() on the scheduler thread)."""
    t0 = time.time()
    while be.prefix_cache.total_refs() and time.time() - t0 < 30:
        time.sleep(0.01)
    lock = getattr(be, "_slock", None)
    if lock is None:
        time.sleep(0.2)
    else:
        with lock:
            pass


def _run(be, smp_cls, prompt, n):
    return be.submit(list(prompt), n, smp_cls(V, 0.0)).wait(timeout=300)


def prefix_cycle(be, smp_cls):
    """A warm request; a prompt of three full directory blocks (a remap whose boundary
    block is copied: copy-on-write); the whole directory demoted and a hit that promotes
    it back; two requests admitted together on the warm prefix. Returns the outputs and
    the cache's counters."""
    outs = [_run(be, smp_cls, SHARED + [148], 6)]
    _settle(be)
    outs.append(_run(be, smp_cls, SHARED[:24], 5))
    _settle(be)
    lock = getattr(be, "_slock", None)
    if lock is None:
        be._paged_reclaim(be.kv_pool.n_blocks)
    else:
        with lock:
            be._paged_reclaim(be.kv_pool.n_blocks)
    outs.append(_run(be, smp_cls, SHARED[:17] + [240], 5))
    _settle(be)
    reqs = []

    def on_token(_t):
        if not reqs and len(lead.out) == 3:
            reqs.extend(be.submit(SHARED + [150 + i], 6, smp_cls(V, 0.0)) for i in range(2))
    lead = be.submit(SHARED + [149], 3, smp_cls(V, 0.0), on_token=on_token)
    lead.wait(timeout=300)
    outs += [lead.out] + [r.wait(timeout=300) for r in reqs]
    _settle(be)
    st = be.prefix_cache.stats()
    counters = {k: st[k] for k in ("hits", "hit_tokens", "unused_hits", "demoted_blocks",
                                   "promoted_blocks")}
    counters.update(prefilled=be.prefilled_tokens, seed_bytes=be.seed_bytes)
    return outs, counters


def dense_cycle(be, smp_cls):
    """Dense caches with the host PrefixCache: a warm request, one that takes the other
    slot, then seeded and greedy requests the pool seeds (copy-in). Returns the outputs
    and the cache's counters."""
    prompts = [SHARED + [200 + i] for i in range(3)] + [[1, 99, 98]]
    plans = [(0.0,), (0.8, 0.9, 7), (0.8, 0.9, 7), (0.0,)]
    outs = []
    for i in (0, 3, 1, 2):
        outs.append(be.submit(list(prompts[i]), 8, smp_cls(V, *plans[i])).wait(300))
        _settle(be)
    st = be.prefix_cache.stats()
    counters = {k: st[k] for k in ("hits", "hit_tokens", "unused_hits", "misses")}
    counters.update(prefilled=be.prefilled_tokens, seed_bytes=be.seed_bytes)
    return outs, counters


SPEC_JOBS = [([1] + REP * 6, 40, (0.0,)), ([1, 2] + REP2 * 5, 40, (0.8, 0.9, 7))]


def spec_jobs(be, smp_cls):
    """The greedy and the seeded-stochastic speculative requests together: outputs,
    final sampler states, verify dispatches run."""
    reqs = [be.submit(list(p), n, smp_cls(V, *sargs)) for p, n, sargs in SPEC_JOBS]
    outs = [r.wait(timeout=300) for r in reqs]
    return (outs, [int(r.sampler.state) for r in reqs],
            sum(r.stats.spec_steps for r in reqs))


def grammar_jobs(be, smp_cls, constrain):
    """A grammar-masked row (a JSON schema, greedy) beside an unconstrained one, and a
    seeded constrained row: `constrain` is the package's constrain module."""
    aut, gh = constrain.compile_grammar("json_schema", SCHEMA, constrain.byte_vocab(V),
                                        EOS)
    jobs = [([1, 5, 9], 28, (0.0,), False), ([1, 5, 9], 28, (0.0,), True),
            ([1, 6, 9], 20, (0.8, 0.9, 23), True)]
    reqs = [be.submit(list(p), n, smp_cls(V, *sargs),
                      **(dict(constraint=aut, constraint_hash=gh) if g else {}))
            for p, n, sargs, g in jobs]
    outs = [r.wait(timeout=300) for r in reqs]
    return outs, [int(r.sampler.state) for r in reqs]


def _script(name: str, arg, be):
    if name == "concurrent":
        return concurrent(be, Sampler)
    if name == "staggered":
        return staggered(be, Sampler, *arg)
    if name == "prefix":
        return prefix_cycle(be, Sampler)
    if name == "dense":
        return dense_cycle(be, Sampler)
    if name == "spec":
        return spec_jobs(be, Sampler)
    if name == "grammar":
        from distributed_llama_tpu_torch import constrain

        return grammar_jobs(be, Sampler, constrain)
    raise ValueError(name)


def _refusals(be) -> list[str]:
    """What a tp engine refuses, each message (rank 0, before its first request)."""
    out = []
    for call in (lambda: be.submit([1, 2], 2, Sampler(V, 0.0), export_kv=True),
                 lambda: be.import_kv_blocks([1, 2], []), be.recover_wedged):
        try:
            call()
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    return out


def batch_cases(mesh, model_path, cases):
    """Each (name, engine kwargs, [(script, argument), ...]): BatchEngine.load(tp=) on
    this rank; rank 0 runs the scripts in turn and closes, the others follow. Returns
    per case the rank's token blocks, and on rank 0 the scripts' results, what the engine
    refuses, its counted collectives and its dispatch counters."""
    out = []
    for name, kw, scripts in cases:
        be = BatchEngine.load(model_path, tp=mesh.tp, device=mesh.device, **kw)
        be.token_log = []
        row = {"name": name}
        if mesh.rank == 0:
            try:
                row["refused"] = _refusals(be)
                row["result"] = [_script(script, arg, be) for script, arg in scripts]
                row["collectives"] = be.collective_stats()
                if be.kv_pool is not None:
                    row["cow"] = be.kv_pool.cow_blocks
                    row["remapped"] = be.remapped_blocks
                    row["drained"] = be.release_idle() == be.kv_pool.n_blocks - 1
                row["counts"] = {"super_steps": be.super_steps, "chained": be.chained,
                                 "verify_steps": be.verify_steps,
                                 "mixed_steps": be.mixed_steps}
            finally:
                be.close()
        else:
            row["replayed"] = be.follow()
        row["blocks"] = be.token_blocks()
        out.append(row)
    return out


def engine_cases(mesh, model_path, prompt, rep_prompt):
    """Engine(tp=) on every rank: the device loop greedy and seeded, a stop inside a
    chunk decided on rank 0 alone, and generate_speculative. Every rank returns its
    tokens and final positions."""
    eng = Engine.load(model_path, tp=mesh.tp, device=mesh.device)
    out = {}
    eng.reset()
    out["loop_greedy"] = eng.generate_chunked(list(prompt), 12, Sampler(V, 0.0),
                                              chunk=5)[0], eng.pos
    eng.reset()
    out["loop_sampled"] = eng.generate_chunked(list(prompt), 12, Sampler(V, 0.8, 0.9, 5),
                                               chunk=4)[0], eng.pos
    seen = []

    def stop_at_7(t):
        seen.append(t)
        return len(seen) == 7
    eng.reset()
    out["loop_stop"] = eng.generate_chunked(
        list(prompt), 12, Sampler(V, 0.0), chunk=5,
        stop_check=stop_at_7 if mesh.rank == 0 else None)[0], eng.pos
    eng.reset()
    out["spec"] = eng.generate_speculative(list(rep_prompt), 24, Sampler(V, 0.0),
                                           k=8)[0], eng.pos
    return out
