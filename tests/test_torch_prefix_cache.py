"""PyTorch port: the shared-prefix KV cache (distributed_llama_tpu_torch/cache/) and its
use in the BatchEngine and the single-sequence Engine, held against the JAX package.

- The data structures under one seeded random sequence of operations each, against the
  JAX classes: RadixIndex, KVBlockPool (hot and Q80), PrefixCache and PagedPrefixCache
  (over DeviceKVPool, with a fake device store), compared after every operation
  (returns, handles, refcounts, LRU stamps, evictions, stats()).
- The wire codec: encode_blocks byte-identical to JAX's (raw and Q80, f32, f16 and
  bf16), q80_compress codes equal, bf16 rows kept bit-exact by the hot tier.
- The BatchEngine with the cache on (paged at superstep 1 and at superstep 4 pipelined;
  dense) against the JAX BatchEngine with the cache on, on the cases of the JAX
  package's tests/test_prefix_cache.py and tests/test_paged_kv.py: identical tokens and
  identical hits, hit_tokens, unused_hits, prefilled_tokens and seed_bytes.
- SingleSlotCache over the port's Engine against the JAX one.

A tiny model (dim 64, 2 layers, Q40, blocks of 8) keeps the module well under a minute.
Requests that must be admitted together are submitted from a token callback on the
scheduler thread, so both engines admit them in the same pass.
"""

import random
import time

import numpy as np
import pytest
import torch

from distributed_llama_tpu.cache import wire as jwire
from distributed_llama_tpu.cache.block_pool import KVBlockPool as JPool
from distributed_llama_tpu.cache.device_pool import DeviceKVPool as JDevPool
from distributed_llama_tpu.cache.device_pool import PagedPrefixCache as JPaged
from distributed_llama_tpu.cache.prefix_cache import PrefixCache as JPrefix
from distributed_llama_tpu.cache.radix import RadixIndex as JRadix
from distributed_llama_tpu.cache.single_slot import SingleSlotCache as JSingle
from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.cache import wire
from distributed_llama_tpu_torch.cache.block_pool import KVBlockPool
from distributed_llama_tpu_torch.cache.device_pool import DeviceKVPool, PagedPrefixCache
from distributed_llama_tpu_torch.cache.prefix_cache import PrefixCache
from distributed_llama_tpu_torch.cache.radix import RadixIndex
from distributed_llama_tpu_torch.cache.single_slot import SingleSlotCache
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 256
SHARED = [1] + [10 + (i * 7) % 90 for i in range(33)]  # 34 tokens: 4 blocks of 8


def _dump(radix) -> list:
    """Every node as (chain of keys, handle, refs, stamp), in key order."""
    out, stack = [], [(radix.root, ())]
    while stack:
        node, chain = stack.pop()
        for key, child in node.children.items():
            out.append((chain + (key,), child.handle, child.refs, child.stamp))
            stack.append((child, chain + (key,)))
    return sorted(out, key=lambda r: r[0])


def _same_radix(t, j) -> None:
    assert _dump(t) == _dump(j)
    assert (t.nodes, t.total_refs(), t._clock) == (j.nodes, j.total_refs(), j._clock)


def _tokens(rng: random.Random, seen: list, n: int) -> list[int]:
    """Random tokens of a small alphabet; mostly a prefix of a recently inserted
    sequence with a random tail, so lookups and inserts share chains."""
    toks = [rng.randrange(1, 4) for _ in range(rng.randrange(1, n))]
    if seen and rng.random() < 0.7:
        base = rng.choice(seen[-4:])
        toks = base[:rng.randrange(0, len(base) + 1)] + toks[:rng.randrange(0, 6)]
    return toks or [1]


def _eq(got: torch.Tensor, want: np.ndarray) -> None:
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# data structures against the JAX classes
# ---------------------------------------------------------------------------


def test_radix_index_matches_jax_under_random_operations():
    rng = random.Random(0)
    t, j = RadixIndex(4), JRadix(4)
    held: list[tuple[list, list]] = []
    for step in range(800):
        op = rng.choice(["insert", "insert", "match", "acquire", "release", "evict"])
        toks = [rng.randrange(1, 4) for _ in range(rng.randrange(0, 19))]
        if op == "insert":
            stop, base = rng.randrange(0, 6), 100 * step

            def make(i, stop=stop, base=base):
                return base + i if i < stop else None
            got, want = t.insert(toks, make), j.insert(toks, make)
            assert [n.handle for n in got] == [n.handle for n in want], step
        elif op == "match":
            assert ([n.handle for n in t.match(toks)]
                    == [n.handle for n in j.match(toks)]), step
        elif op == "acquire":
            tn, jn = t.match(toks), j.match(toks)
            t.acquire(tn)
            j.acquire(jn)
            held.append((tn, jn))
        elif op == "release" and held:
            tn, jn = held.pop(rng.randrange(len(held)))
            t.release(tn)
            j.release(jn)
        elif op == "evict":
            n = rng.randrange(0, 5)
            assert t.evict(n) == j.evict(n), step
        _same_radix(t, j)
        assert sorted(t.chains()) == sorted(j.chains())


@pytest.mark.parametrize("q80", [False, True])
def test_block_pool_matches_jax_under_random_operations(q80):
    rng = np.random.default_rng(1)
    t, j = KVBlockPool(7, q80=q80), JPool(7, q80=q80)
    live: list[int] = []
    for step in range(300):
        op = rng.choice(["put", "put", "get", "free"])
        if op == "put":
            shape = (2, 2, 8, 16) if rng.random() < 0.8 else (1, 1, 3, 5)
            k = rng.normal(size=shape).astype(np.float32)
            v = (k * 2 + 0.5).astype(np.float32)
            h = t.put(torch.from_numpy(k), torch.from_numpy(v))
            assert h == j.put(k, v), step
            if h is not None:
                live.append(h)
        elif op == "get" and live:
            h = live[rng.integers(len(live))]
            (tk, tv), (jk, jv) = t.get(h), j.get(h)
            _eq(tk, jk)
            _eq(tv, jv)
            assert tk.dtype == torch.float32
        elif op == "free" and live:
            h = live.pop(rng.integers(len(live)))
            t.free(h)
            j.free(h)
        assert [t.is_cold(h) for h in live] == [j.is_cold(h) for h in live]
        assert (len(t), t.hot_count(), t.nbytes(), t.demoted_blocks, t.full) == (
            len(j), j.hot_count(), j.nbytes(), j.demoted_blocks, j.full), step
    assert t.demoted_blocks > 0 if q80 else t.demoted_blocks == 0


@pytest.mark.parametrize("q80", [False, True])
def test_prefix_cache_matches_jax_under_random_operations(q80):
    rng = random.Random(2)
    nrng = np.random.default_rng(2)
    t, j = PrefixCache(10, block_tokens=4, q80=q80), JPrefix(10, block_tokens=4, q80=q80)
    leases: list = []
    seen: list[list[int]] = []
    for step in range(400):
        op = rng.choice(["insert", "insert", "lookup", "lookup", "lookup", "fetch",
                         "seed", "unused", "release", "shrink", "resident"])
        toks = _tokens(rng, seen, 22)
        if op == "insert":
            rows = nrng.normal(size=(2, 2, 2, len(toks), 8)).astype(np.float32)
            tcalls, jcalls = [], []

            def t_harvest(a, b, rows=rows, calls=tcalls):
                calls.append((a, b))
                return tuple(torch.from_numpy(r[:, :, a:b]) for r in rows)

            def j_harvest(a, b, rows=rows, calls=jcalls):
                calls.append((a, b))
                return rows[0][:, :, a:b], rows[1][:, :, a:b]
            assert t.insert(toks, t_harvest) == j.insert(toks, j_harvest), step
            assert tcalls == jcalls
            seen.append(toks)
        elif op == "lookup":
            cap = rng.choice([None, 7])
            tl, jl = t.lookup(toks, cap=cap), j.lookup(toks, cap=cap)
            assert (tl is None) == (jl is None), step
            if tl is not None:
                assert tl.tokens == jl.tokens, step
                assert [n.handle for n in tl.nodes] == [n.handle for n in jl.nodes]
                leases.append((tl, jl))
        elif op == "fetch" and leases:
            tl, jl = leases[rng.randrange(len(leases))]
            if tl.tokens:
                skip = rng.randrange(0, tl.tokens)
                (tk, tv), (jk, jv) = t.fetch(tl, skip), j.fetch(jl, skip)
                _eq(tk.contiguous(), np.ascontiguousarray(jk))
                _eq(tv.contiguous(), np.ascontiguousarray(jv))
        elif op in ("seed", "unused", "release", "shrink") and leases:
            i = rng.randrange(len(leases))
            tl, jl = leases[i]
            if op == "seed":
                t.mark_seeded(tl, tl.tokens)
                j.mark_seeded(jl, jl.tokens)
            elif op == "shrink":
                n = rng.randrange(0, tl.tokens + 2)
                t.shrink(tl, n)
                j.shrink(jl, n)
            else:
                leases.pop(i)
                getattr(t, "mark_unused" if op == "unused" else "release")(tl)
                getattr(j, "mark_unused" if op == "unused" else "release")(jl)
        elif op == "resident":
            t.note_resident(len(toks))
            j.note_resident(len(toks))
        assert t.stats() == j.stats(), step
        _same_radix(t.radix, j.radix)
    assert t.stats()["evicted_blocks"] > 0 and t.stats()["hits"] > 0


@pytest.mark.parametrize("q80", [False, True])
def test_paged_prefix_cache_matches_jax_under_random_operations(q80):
    """The directory over two identical DeviceKVPools and one fake device store (block
    id -> rows): zero-copy inserts, leases, demotion into the cold tier under reclaim,
    promotion of cold nodes, cold imports, and the slots' own refs dropped."""
    rng = random.Random(3)
    nrng = np.random.default_rng(3)
    tp, jp = DeviceKVPool(20, 4), JDevPool(20, 4)
    t = PagedPrefixCache(tp, 4, cold_blocks=6, q80=q80)
    j = JPaged(jp, 4, cold_blocks=6, q80=q80)
    store: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    slots: list[list[int]] = []
    leases: list = []
    seen: list[list[int]] = []

    def rows():
        k = nrng.normal(size=(2, 2, 4, 8)).astype(np.float32)
        return k, (k - 1.0).astype(np.float32)

    def read_t(bid):
        return tuple(torch.from_numpy(a) for a in store[bid])

    for step in range(500):
        op = rng.choice(["harvest", "harvest", "drop_slot", "lookup", "seed", "unused",
                         "release", "shrink", "reclaim", "promote", "insert_cold"])
        toks = _tokens(rng, seen, 20)
        if op == "harvest":
            n = len(toks) // 4
            ids = tp.alloc(n) if n else None
            assert ids == (jp.alloc(n) if n else None), step
            if ids:
                for b in ids:
                    store[b] = rows()
                assert t.insert_blocks(toks, ids) == j.insert_blocks(toks, ids), step
                slots.append(ids)
                seen.append(toks)
        elif op == "drop_slot" and slots:
            ids = slots.pop(rng.randrange(len(slots)))
            assert tp.decref(ids) == jp.decref(ids), step
        elif op == "lookup":
            tl, jl = t.lookup(toks), j.lookup(toks)
            assert (tl is None) == (jl is None), step
            if tl is not None:
                assert tl.tokens == jl.tokens
                assert [n.handle for n in tl.nodes] == [n.handle for n in jl.nodes]
                leases.append((tl, jl))
        elif op in ("seed", "unused", "release", "shrink") and leases:
            i = rng.randrange(len(leases))
            tl, jl = leases[i]
            if op == "seed":
                t.mark_seeded(tl, tl.tokens)
                j.mark_seeded(jl, jl.tokens)
            elif op == "shrink":
                n = rng.randrange(0, tl.tokens + 2)
                t.shrink(tl, n)
                j.shrink(jl, n)
            else:
                leases.pop(i)
                getattr(t, "mark_unused" if op == "unused" else "release")(tl)
                getattr(j, "mark_unused" if op == "unused" else "release")(jl)
        elif op == "reclaim":
            n = rng.randrange(1, 6)
            assert t.reclaim(n, read_t) == j.reclaim(n, lambda b: store[b]), step
        elif op == "promote" and leases:
            tl, jl = leases[rng.randrange(len(leases))]
            for tn, jn in zip(tl.nodes, jl.nodes):
                if tn.handle[0] != "cold":
                    continue
                (tk, tv), (jk, jv) = t.fetch_cold(tn.handle[1]), j.fetch_cold(jn.handle[1])
                _eq(tk, jk)
                _eq(tv, jv)
                nb = tp.alloc(1)
                assert nb == jp.alloc(1)
                if nb is None:
                    break
                store[nb[0]] = (jk, jv)
                t.promote(tn, nb[0])
                j.promote(jn, nb[0])
                tp.decref(nb)
                jp.decref(nb)
        elif op == "insert_cold":
            blocks = [rows() for _ in range(len(toks) // 4)]
            tb = [tuple(torch.from_numpy(a) for a in b) for b in blocks]
            assert t.insert_cold(toks, tb) == j.insert_cold(toks, blocks), step
        st = t.stats()
        assert st == j.stats(), step
        np.testing.assert_array_equal(tp.refcounts(), jp.refcounts())
        assert tp._free == jp._free and t.total_refs() == j.total_refs(), step
        _same_radix(t.radix, j.radix)
    assert st["demoted_blocks"] > 0 and st["promoted_blocks"] > 0
    assert st["evicted_blocks"] > 0


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------


def _blocks(seed: int, dtype):
    rng = np.random.default_rng(seed)
    shapes = [(2, 2, 4, 8), (1, 1, 3, 5), (2, 1, 8, 16)]
    return [tuple(rng.normal(size=s).astype(dtype) for _ in range(2)) for s in shapes]


@pytest.mark.parametrize("q80", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_wire_framing_byte_identical_to_jax(q80, dtype):
    blocks = _blocks(4, dtype)
    tblocks = [tuple(torch.from_numpy(a) for a in b) for b in blocks]
    data = wire.encode_blocks(tblocks, q80=q80)
    assert data == jwire.encode_blocks(blocks, q80=q80)
    assert wire.encode_blocks(blocks, q80=q80) == data  # numpy rows frame the same
    assert len(data) == wire.block_wire_bytes(tblocks, q80) == jwire.block_wire_bytes(
        blocks, q80)
    for (tk, tv), (jk, jv) in zip(wire.decode_blocks(data), jwire.decode_blocks(data)):
        _eq(tk, jk)
        _eq(tv, jv)
    for cut in (3, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError):
            wire.decode_blocks(data[:cut])


def test_q80_codes_and_bf16_rows_are_exact():
    """q80_compress gives JAX's codes (also on bf16 rows, which it upcasts exactly); a
    bf16 block keeps its bits through the hot tier and the raw wire, and frames as the
    JAX package frames the same bits."""
    import ml_dtypes

    x = np.random.default_rng(5).normal(size=(2, 2, 8, 16)).astype(np.float32)
    for a, b in zip(wire.q80_compress(torch.from_numpy(x)), jwire.q80_compress(x)):
        np.testing.assert_array_equal(a, b)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jb = xb.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    for a, b in zip(wire.q80_compress(xb), jwire.q80_compress(jb)):
        np.testing.assert_array_equal(a, b)
    pool = KVBlockPool(2)
    h = pool.put(xb, -xb)
    k, v = pool.get(h)
    assert k.dtype == torch.bfloat16 and torch.equal(k.view(torch.int16),
                                                     xb.view(torch.int16))
    assert torch.equal(v.view(torch.int16), (-xb).view(torch.int16))
    data = wire.encode_blocks([(xb, xb)])
    assert data == jwire.encode_blocks([(jb, jb)])
    (dk, _), = wire.decode_blocks(data)
    assert dk.dtype == torch.bfloat16 and torch.equal(dk.view(torch.int16),
                                                      xb.view(torch.int16))
    # Q80 cold tier on bf16: the restore is back in bf16, within the Q80 bound
    cold = KVBlockPool(4, hot_blocks=1, q80=True)
    hs = [cold.put(xb, xb) for _ in range(2)]
    assert cold.is_cold(hs[0]) and cold.get(hs[0])[0].dtype == torch.bfloat16
    err = (cold.get(hs[0])[0].float() - xb.float()).abs().max().item()
    assert err <= xb.float().abs().max().item() / 127 * 1.01 + 2 ** -7 * 4


# ---------------------------------------------------------------------------
# the BatchEngine with the cache on, against the JAX BatchEngine
# ---------------------------------------------------------------------------


def _files(tmp, seq_len: int, seed: int) -> str:
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=V, seq_len=seq_len).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=seed)
    path = str(tmp / f"model_{seq_len}_{seed}.m")
    write_model(path, spec, params_file_order(spec, params), FloatType.Q40)
    return path


CONFIGS = {"paged1": dict(superstep=1, pipeline=False, kv_block_tokens=8),
           "paged4": dict(superstep=4, pipeline=True, kv_block_tokens=8),
           "dense": dict(superstep=4, pipeline=True, paged_kv=False,
                         prefix_block_tokens=8)}


@pytest.fixture(scope="module")
def model128(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("torch_prefix"), 128, 17)


@pytest.fixture(scope="module")
def pairs(model128):
    """(JAX engine, port engine), cache on, per configuration, built on first use."""
    made: dict = {}

    def get(name):
        if name not in made:
            kw = CONFIGS[name]
            made[name] = (JBatchEngine.load(model128, slots=2, tp=1, **kw),
                          BatchEngine.load(model128, slots=2, device="cpu", **kw))
        return made[name]
    yield get
    for jbe, be in made.values():
        jbe.close()
        be.close()


def _smp(cls, temperature=0.0, seed=0):
    return cls(V, temperature=temperature, seed=seed)


def _run(be, prompt, n, temperature=0.0, seed=0):
    cls = JSampler if isinstance(be, JBatchEngine) else Sampler
    return be.submit(list(prompt), n, _smp(cls, temperature, seed)).wait(timeout=240)


def _together(be, prompts, n, lead, lead_n=4):
    """Run `lead`, and from its last token submit every prompt: one admission pass
    sees them all, on either engine. Returns the requests' tokens."""
    cls = JSampler if isinstance(be, JBatchEngine) else Sampler
    reqs = []

    def on_token(_t):
        if len(reqs) == 0 and len(box[0].out) == lead_n:
            reqs.extend(be.submit(list(p), n, _smp(cls)) for p in prompts)
    box = [be.submit(list(lead), lead_n, _smp(cls), on_token=on_token)]
    box[0].wait(timeout=240)
    return [r.wait(timeout=240) for r in reqs]


def _settle(pred, timeout=10):
    """wait() returns at done.set(); the harvest lands just after on the scheduler
    thread: poll for the settled state."""
    t0 = time.time()
    while not pred() and time.time() - t0 < timeout:
        time.sleep(0.01)
    assert pred()


def _counters(be) -> dict:
    st = be.prefix_cache.stats()
    out = {k: st[k] for k in ("hits", "hit_tokens", "unused_hits", "misses",
                              "resident_tokens", "prompt_tokens", "evicted_blocks")}
    out.update(prefilled_tokens=be.prefilled_tokens, seed_bytes=be.seed_bytes)
    return out


def _settled(*engines) -> None:
    """Every lease released and the last finish's harvest landed: the port's scheduler
    harvests inside the pass that holds _slock; the JAX engine is given the pause its
    own tests give it."""
    for be in engines:
        _settle(lambda be=be: be.prefix_cache.total_refs() == 0)
        if isinstance(be, BatchEngine):
            with be._slock:
                pass
        else:
            time.sleep(0.2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cache_on_matches_jax_greedy_and_stochastic(model128, pairs, name):
    """The JAX package's on/off identity sequence: a warm request, one that dirties
    both slots, then requests the pool serves, greedy and seeded-stochastic — the JAX
    engine's tokens and counters, and the port's own cache-off tokens with more
    prefill."""
    prompts = [SHARED + [200 + i] for i in range(3)] + [[1, 99, 98]]
    plans = [(0.0, 0), (0.8, 7), (0.8, 7), (0.0, 0)]
    order = [0, 3, 1, 2]
    jbe, be = pairs(name)
    base = be.prefilled_tokens
    outs = [[_run(e, prompts[i], 8, *plans[i]) for i in order] for e in (jbe, be)]
    _settled(jbe, be)
    assert outs[0] == outs[1]
    assert _counters(be) == _counters(jbe)
    st = be.prefix_cache.stats()
    assert st["hits"] >= 1 and st["hit_tokens"] >= 30 and st["unused_hits"] >= 1
    if be.kv_pool is not None:
        assert be.seed_bytes == 0 and be.remapped_blocks >= 4
    off = BatchEngine.load(model128, slots=2, device="cpu", prefix_cache=False,
                           **CONFIGS[name])
    try:
        assert [_run(off, prompts[i], 8, *plans[i]) for i in order] == outs[1]
        assert off.prefilled_tokens - (be.prefilled_tokens - base) >= 30
    finally:
        off.close()


@pytest.mark.parametrize("name", ["paged4", "dense"])
def test_concurrent_shared_prefix_requests_match_jax(pairs, name):
    """Four requests sharing the warm prefix, admitted together (two slots: two wait):
    the JAX engine's tokens and counters."""
    prompts = [SHARED + [150 + i] for i in range(4)]
    outs = [_together(be, prompts, 6, SHARED + [149]) for be in pairs(name)]
    _settled(*pairs(name))
    assert outs[0] == outs[1] and all(len(o) == 6 for o in outs[1])
    jbe, be = pairs(name)
    assert _counters(be) == _counters(jbe)
    assert be.prefix_cache.stats()["hit_tokens"] >= 32


def test_tiny_pool_eviction_matches_jax(model128):
    """A dense host pool of 3 blocks under a working set far larger: every miss just
    prefills, eviction churns, and both engines agree on tokens and counters."""
    kw = dict(slots=2, superstep=4, pipeline=True, paged_kv=False, prefix_block_tokens=8,
              prefix_cache_blocks=3)
    prompts = [SHARED + [140 + i] for i in range(2)] + [[1, 77] + [30 + i for i in range(20)]]
    jbe = JBatchEngine.load(model128, tp=1, **kw)
    be = BatchEngine.load(model128, device="cpu", **kw)
    try:
        outs = [[_run(e, p, 6) for p in prompts * 2] for e in (jbe, be)]
        _settled(jbe, be)
        assert outs[0] == outs[1]
        assert _counters(be) == _counters(jbe) and be.prefix_cache.stats()["evicted_blocks"]
        assert len(be.prefix_cache.pool) <= 3
    finally:
        jbe.close()
        be.close()


@pytest.fixture(scope="module")
def model32(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("torch_prefix32"), 32, 5)


@pytest.fixture(scope="module")
def model64(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("torch_prefix64"), 64, 7)


def test_context_end_clamp_keeps_the_directory_intact(model32):
    """Rows driven to the context end park clamped over their own tail rows: in the pool
    those rows may back directory blocks, which copy-on-write keeps intact — the re-run
    of the warm prompt remaps them and still gets the JAX engine's tokens, no chain
    covers the clamped row, and every lease shrinks back to zero."""
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [1, 2, 3, 4, 5, 6, 7, 8, 11]]
    kw = dict(slots=2, superstep=4, pipeline=True, kv_block_tokens=4)
    jbe = JBatchEngine.load(model32, tp=1, **kw)
    be = BatchEngine.load(model32, device="cpu", **kw)
    try:
        outs = []
        for e in (jbe, be):
            warm = _run(e, prompts[0], 30)
            outs.append([warm] + _together(e, prompts, 30, [1, 60, 61], lead_n=2))
        _settled(jbe, be)
        assert outs[0] == outs[1]
        assert _counters(be) == _counters(jbe) and be.prefix_cache.stats()["hit_tokens"]
        assert max(len(c) for c in be.prefix_cache.radix.chains()) <= 7  # never [0, 32)
        off = BatchEngine.load(model32, device="cpu", prefix_cache=False, **kw)
        try:
            assert [_run(off, p, 30) for p in prompts] == outs[1][1:]
        finally:
            off.close()
    finally:
        jbe.close()
        be.close()


def test_cold_promotion_does_not_leak_pool_blocks(model64):
    """The same prefix cycled through the cold tier three times (the whole directory
    demoted, then a hit promotes it back): the used blocks stay flat, the promoted
    bytes match the JAX engine's, and the pool drains to all but the scratch block."""
    prompt = SHARED[:17]
    kw = dict(slots=2, superstep=4, kv_block_tokens=8)
    jbe = JBatchEngine.load(model64, tp=1, **kw)
    be = BatchEngine.load(model64, device="cpu", **kw)
    try:
        used, outs = {}, {}
        for e in (jbe, be):
            outs[e] = [_run(e, prompt, 4)]
            used[e] = []
            for i in range(3):
                _settled(e)
                if e is be:
                    with be._slock:
                        be._paged_reclaim(be.kv_pool.n_blocks)
                else:
                    e._paged_reclaim(e.kv_pool.n_blocks)
                outs[e].append(_run(e, prompt + [240 + i], 4))
                _settled(e)
                used[e].append(e.kv_pool.used_blocks())
        assert outs[jbe] == outs[be] and used[jbe] == used[be]
        assert used[be][2] <= used[be][0]
        st, jst = be.prefix_cache.stats(), jbe.prefix_cache.stats()
        assert st["promoted_blocks"] == jst["promoted_blocks"] >= 2
        assert st["demoted_blocks"] == jst["demoted_blocks"]
        assert _counters(be) == _counters(jbe) and be.seed_bytes > 0
        assert be.release_idle() == be.kv_pool.n_blocks - 1
    finally:
        jbe.close()
        be.close()


def test_pool_exhaustion_fails_only_the_starving_request(model64):
    """A pool of one context plus scratch and a spare, the cache on: of two long
    requests the one that starves fails with KVPoolExhausted as in the JAX engine, the
    other gets the JAX engine's tokens, the scheduler keeps serving, every lease is
    released and the pool drains."""
    from distributed_llama_tpu.cache.device_pool import KVPoolExhausted as JExhausted
    from distributed_llama_tpu_torch.cache.device_pool import KVPoolExhausted

    kw = dict(slots=2, superstep=4, kv_block_tokens=8, kv_pool_blocks=64 // 8 + 2)
    jbe = JBatchEngine.load(model64, tp=1, **kw)
    be = BatchEngine.load(model64, device="cpu", **kw)
    try:
        res = []
        for e, exc in ((jbe, JExhausted), (be, KVPoolExhausted)):
            reqs = _together_reqs(e, [[1, 2, 3], [1, 2, 4]], 56, [1, 5, 5])
            res.append([("exhausted" if isinstance(r.error, exc) else
                         r.error if r.error else r.out) for r in reqs])
            assert len(_run(e, [1, 9, 9], 6)) == 6
        assert res[0] == res[1] and "exhausted" in res[1]
        _settled(jbe, be)
        assert _counters(be) == _counters(jbe)
        assert be.release_idle() == be.kv_pool.n_blocks - 1
    finally:
        jbe.close()
        be.close()


def _together_reqs(be, prompts, n, lead):
    """As _together, returning the settled requests instead of their tokens."""
    cls = JSampler if isinstance(be, JBatchEngine) else Sampler
    reqs = []

    def on_token(_t):
        if not reqs:
            reqs.extend(be.submit(list(p), n, _smp(cls)) for p in prompts)
    be.submit(list(lead), 1, _smp(cls), on_token=on_token).wait(timeout=240)
    for r in reqs:
        r.done.wait(240)
    return reqs


# ---------------------------------------------------------------------------
# SingleSlotCache over the single-sequence Engine
# ---------------------------------------------------------------------------


def test_single_slot_cross_conversation_reuse_matches_jax(model128):
    """Conversation A, an unrelated B that displaces it, A again (a radix seed, not the
    resident rewind), C sharing A's system prompt and a follow-up turn of C (both
    resident rewinds): the JAX SingleSlotCache's reuse lengths, tokens and stats; a
    fresh Engine's prefill gives C's tokens; invalidate drops the resident record and
    the reservation."""
    jeng = JEngine.load(model128, tp=1)
    eng = Engine.load(model128, device="cpu")
    jssc = JSingle(jeng, JPrefix(max_blocks=64, block_tokens=8))
    ssc = SingleSlotCache(eng, PrefixCache(max_blocks=64, block_tokens=8))
    convs = [SHARED + [201], [1, 60, 61, 62], SHARED + [201], SHARED + [222],
             SHARED + [222, 5]]
    res = []
    for e, c, cls in ((jeng, jssc, JSampler), (eng, ssc, Sampler)):
        runs = []
        for conv in convs:
            reuse = c.begin(conv)
            out, _ = e.generate(conv[reuse:], 6, cls(V, temperature=0.0))
            c.end((conv + out)[:e.pos])
            runs.append((reuse, out))
        res.append(runs)
        assert c.cache.total_refs() == 0
    assert res[0] == res[1]
    assert [r for r, _ in res[1]] == [0, 1, 32, 34, 35]  # A' from the pool, C resident
    assert ssc.stats() == jssc.stats()
    cold = Engine.load(model128, device="cpu")
    assert cold.generate(convs[3], 6, Sampler(V))[0] == res[1][3][1]
    prompt = SHARED + [205]
    assert ssc.begin(prompt) == jssc.begin(prompt) == 34  # the resident rewind
    ssc.invalidate()
    jssc.invalidate()
    assert ssc.resident == jssc.resident == [] and ssc.cache.total_refs() == 0
    eng.reset()
    out, _ = eng.generate(prompt, 4, Sampler(V))
    ssc.end((prompt + out)[:eng.pos])
    assert ssc.cache.radix.nodes >= 4
