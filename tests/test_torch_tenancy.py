"""PyTorch port: tenancy in the BatchEngine (resilience/tenancy.py, the weighted-fair wait
queue, quotas, SLO shedding and batch preemption) and on the server (X-Tenant, "class",
429 with Retry-After), against the JAX package on one tiny `.m`/`.t` pair.

The tenancy copy is held against the JAX module on the same seeded operation sequences
and the same clock. The engine cases mirror tests/test_tenancy.py: a batch request
preempted by an interactive arrival resumes with the tokens of its uninterrupted run —
greedy and seeded, paged and dense, pipelined and not — and that run's tokens are the
JAX BatchEngine's. Preemptions are set off from the victim's token callback (the
scheduler thread), and slots are held by callbacks that wait on an event: no timing race.
"""

import json
import threading
import time

import numpy as np
import pytest

from distributed_llama_tpu.resilience import tenancy as jtenancy
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.resilience import tenancy
from distributed_llama_tpu_torch.resilience.errors import (EngineSaturated, InvalidRequest,
                                                           QuotaExceeded)
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler, _random_u32, _xorshift_back
from distributed_llama_tpu_torch.tokenizer import TemplateType

from test_torch_resilience import V, _call, _Hold, _wait_until, files  # noqa: F401

PROMPT = [1] + list(range(30, 50))  # 21 tokens: its first block joins the directory
GEN = 40
SPECS = ["gold:weight=4,rate=100,burst=200;free:weight=1;default:rate=50",
         "alpha:weight=4;beta:weight=2;flood:weight=1", "", "capped:weight=1,rate=8,burst=40",
         "a:weight=0.5;b:weight=1.5,burst=3;c:rate=2"]


def _smp(temp=0.0, seed=0):
    return Sampler(V, temp, 0.9, seed)


# ------------------------------------------------------------------
# the copy against the JAX module
# ------------------------------------------------------------------

class _Item:
    def __init__(self, i, tenant, klass, cost):
        self.i, self.tenant, self.klass, self.wfq_cost = i, tenant, klass, cost


def _wfq_trace(mod, seed: int) -> list:
    """A seeded random sequence of every WeightedFairQueue operation; returns what each
    one answered (items by their index)."""
    rng = np.random.default_rng(seed)
    q = mod.WeightedFairQueue(mod.TenantRegistry.parse("t0:weight=3;t1:weight=1;t2:weight=2"))
    items, out = [], []

    def key(x):
        return None if x is None else x.i
    for step in range(400):
        op = rng.integers(0, 9)
        if op <= 2:
            it = _Item(step, f"t{rng.integers(0, 4)}", mod.CLASSES[rng.integers(0, 2)],
                       float(rng.integers(1, 50)))
            items.append(it)
            if op == 0:
                q.append(it)
            else:
                q.push(it, cost=float(rng.integers(1, 9)) if op == 2 else None)
            out.append(("push", len(q)))
        elif op == 3:
            out.append(("pop", key(q.pop_next())))
        elif op == 4:
            out.append(("peek", key(q.peek_next())))
        elif op == 5:
            k = mod.CLASSES[rng.integers(0, 2)]
            out.append(("evict", key(q.evict_last(k)), q.last_tag(k)))
        elif op == 6 and items:
            it = items[rng.integers(0, len(items))]
            out.append(("remove", q.remove(it)))
        elif op == 7:
            out.append(("tag", q.entry_tag(f"t{rng.integers(0, 4)}", "batch", 7.0),
                        q.class_depth("batch"), sorted(x.i for x in q)))
        elif rng.integers(0, 20) == 0:
            q.clear()
            out.append(("clear", len(q)))
    while len(q):
        out.append(("drain", key(q.pop_next())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wfq_orders_match_jax(seed):
    assert _wfq_trace(tenancy, seed) == _wfq_trace(jtenancy, seed)


@pytest.mark.parametrize("spec", SPECS)
def test_registry_matches_jax(spec):
    ours, theirs = tenancy.TenantRegistry.parse(spec), jtenancy.TenantRegistry.parse(spec)
    assert ours.tenants() == theirs.tenants()
    assert ours.stats() == theirs.stats()
    for name in ("gold", "free", "alpha", "capped", "a", "c", "nobody", None, ""):
        assert ours.canonical(name) == theirs.canonical(name)
        assert ours.weight(name) == theirs.weight(name)
        p, q = ours.resolve(name), theirs.resolve(name)
        assert (p.name, p.rate, p.burst, p.bucket is None) == (
            q.name, q.rate, q.burst, q.bucket is None)


@pytest.mark.parametrize("bad", ["bad:velocity=9", ":weight=2", "x:weight", "x:rate=abc"])
def test_registry_rejects_as_jax(bad):
    with pytest.raises(ValueError):
        jtenancy.TenantRegistry.parse(bad)
    with pytest.raises(ValueError):
        tenancy.TenantRegistry.parse(bad)


def test_sanitize_tenant_matches_jax():
    for raw in ("acme-prod.v2", None, "  ", "x" * 64, "x" * 65, "bad tenant\n", "a:b_c",
                "ünï", " gold "):
        assert tenancy.sanitize_tenant(raw) == jtenancy.sanitize_tenant(raw)


def test_buckets_and_drain_rate_match_jax(monkeypatch):
    """TokenBucket, the registry's quota path and DrainRate on one injected clock."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    rng = np.random.default_rng(7)
    pairs = [(tenancy.TokenBucket(10.0, 25.0), jtenancy.TokenBucket(10.0, 25.0)),
             (tenancy.TokenBucket(3.0), jtenancy.TokenBucket(3.0))]
    regs = (tenancy.TenantRegistry.parse("tiny:rate=10,burst=10"),
            jtenancy.TenantRegistry.parse("tiny:rate=10,burst=10"))
    drains = (tenancy.DrainRate(tau=2.0), jtenancy.DrainRate(tau=2.0))
    for _ in range(300):
        now[0] += float(rng.exponential(0.3))
        cost = float(rng.integers(0, 40))
        for ours, theirs in pairs:
            assert ours.try_acquire(cost) == theirs.try_acquire(cost)
            if rng.integers(0, 4) == 0:
                ours.refund(cost)
                theirs.refund(cost)
            assert ours.available() == theirs.available()
        got = []
        for reg in regs:
            try:
                reg.acquire("tiny", cost)
                got.append(None)
            except Exception as e:
                got.append((type(e).__name__, e.retry_after, e.tenant))
        assert got[0] == got[1]
        if rng.integers(0, 3):
            for d in drains:
                d.note()
        depth = float(rng.integers(0, 100))
        assert [(d.rate(), d.queue_wait(depth), d.retry_after(depth)) for d in drains][0] \
            == [(d.rate(), d.queue_wait(depth), d.retry_after(depth)) for d in drains][1]
    assert regs[0].stats() == regs[1].stats()


def test_fair_gate_admits_in_fair_order_as_jax():
    """Three waiters behind a one-place gate leave in the same (interactive first, then
    by weight) order in both copies."""
    def order(mod):
        gate = mod.FairGate(1, mod.TenantRegistry.parse("hi:weight=4;lo:weight=1"))
        assert gate.acquire()
        got, threads = [], []
        for tenant, klass in (("lo", "batch"), ("hi", "batch"), ("lo", "interactive")):
            def wait(t=tenant, k=klass):
                assert gate.acquire(t, k, timeout=30)
                got.append((t, k))
                gate.release()
            threads.append(threading.Thread(target=wait))
            threads[-1].start()
            _wait_until(lambda n=len(threads): gate.waiting() == n, msg="waiter parked")
        gate.release()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        return got
    assert order(tenancy) == order(jtenancy) == [("lo", "interactive"), ("hi", "batch"),
                                                 ("lo", "batch")]


def test_xorshift_back_inverts_the_step():
    rng = np.random.default_rng(3)
    for _ in range(500):
        s = np.uint64(int(rng.integers(0, 1 << 62)) * 4 + 1)
        assert _xorshift_back(_random_u32(s)[0]) == s


# ------------------------------------------------------------------
# preemption: the resumed request against its uninterrupted run and JAX's
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_solo(files):  # noqa: F811
    """The JAX solo engine of tests/test_tenancy.py: one slot, superstep 4."""
    jbe = JBatchEngine.load(*files, slots=1, tp=1, superstep=4)
    memo = {}

    def ref(temp):
        if temp not in memo:
            memo[temp] = jbe.submit(list(PROMPT), GEN, JSampler(V, temp, 0.9, 1234),
                                    klass="batch").wait(timeout=300)
        return memo[temp]
    yield ref
    jbe.close()


@pytest.fixture(scope="module")
def solos(files):  # noqa: F811
    engines = {}

    def get(paged, pipeline):
        if (paged, pipeline) not in engines:
            engines[paged, pipeline] = BatchEngine.load(
                *files, slots=1, device="cpu", superstep=4, paged_kv=paged,
                pipeline=pipeline)
        return engines[paged, pipeline]
    yield get
    for be in engines.values():
        be.close()


def _preempted_run(be, temp, at=9):
    """The victim (batch) submits an interactive request from its token callback once it
    has `at` tokens; returns (victim, interactive)."""
    inter = []

    def on_token(_t, n=[0]):
        n[0] += 1
        if n[0] == at:
            inter.append(be.submit([1, 2, 3], 4, _smp(), klass="interactive"))
    victim = be.submit(list(PROMPT), GEN, _smp(temp, 1234), on_token=on_token,
                       klass="batch")
    victim.wait(timeout=300)
    inter[0].wait(timeout=300)
    return victim, inter[0]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "unpipelined"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "seeded"])
def test_preempted_batch_resumes_identical(solos, jax_solo, temp, paged, pipeline):
    """The interactive arrival takes the only slot at the next super-step boundary; the
    victim re-admits as prompt plus delivered tokens, its first block from the prefix
    cache (dense: rows copied out before the interactive request overwrote them), and
    finishes with its uninterrupted run's tokens, which are JAX's."""
    be = solos(paged, pipeline)
    ref = be.submit(list(PROMPT), GEN, _smp(temp, 1234), klass="batch").wait(timeout=300)
    assert ref == jax_solo(temp) and len(ref) == GEN
    p0, r0 = be.preempted, be.rollback_tokens
    victim, inter = _preempted_run(be, temp)
    assert victim.preemptions == 1 and be.preempted == p0 + 1
    assert victim.out == ref, (temp, paged, pipeline)
    assert len(inter.out) == 4 and inter.preemptions == 0
    # the re-admission took the prompt's full block from the cache, not a prefill
    assert victim.stats.reused_tokens >= 16
    if pipeline:
        # the chained super-step in flight over the victim's row was rolled back
        assert be.rollback_tokens > r0


def test_interactive_rows_never_preempted(solos):
    be = solos(True, True)
    b = []

    def on_token(_t, n=[0]):
        n[0] += 1
        if n[0] == 4:
            b.append(be.submit([1, 2, 3], 4, _smp(), klass="interactive"))
    a = be.submit([1, 9, 9, 2], GEN, _smp(), klass="interactive", on_token=on_token)
    assert len(a.wait(timeout=300)) == GEN and a.preemptions == 0
    assert len(b[0].wait(timeout=300)) == 4


def test_unknown_class_is_invalid(solos):
    with pytest.raises(InvalidRequest):
        solos(True, True).submit([1, 2], 2, _smp(), klass="express")


# ------------------------------------------------------------------
# fairness, shedding and quotas (tests/test_tenancy.py's engine cases)
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(files):  # noqa: F811
    reg = tenancy.TenantRegistry.parse("alpha:weight=4;beta:weight=2;flood:weight=1")
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4, tenants=reg)
    be.generate([1, 7, 23, 5], 4, _smp())
    yield be
    be.close()


def test_no_starvation_under_flooding_tenant(engine):
    be = engine
    flood = [be.submit([1, 40 + i, 23, 5], 12, _smp(), tenant="flood", klass="batch")
             for i in range(10)]
    victims = [be.submit([1, 60 + i, 3], 6, _smp(), tenant=t, klass="interactive")
               for i, t in enumerate(("alpha", "beta", "alpha", "beta"))]
    for r in victims:
        r.wait(timeout=120)
    flood_unfinished = sum(1 for r in flood if not r.done.is_set())
    for r in flood:
        r.wait(timeout=120)
    assert all(len(r.out) == 12 for r in flood)
    assert all(len(r.out) == 6 for r in victims)
    assert flood_unfinished >= 1 or sum(r.preemptions for r in flood) >= 1


def test_slo_shed_requires_backlog(engine):
    """An engine idle long enough for the drain EMA to decay to ~0 still admits a batch
    request on an empty queue: the projection applies to a real backlog only."""
    be = engine
    old_drain, old_tgt = be._drain, dict(be.slo_ttft)
    decayed = tenancy.DrainRate()
    decayed.note()
    with decayed._lock:
        decayed._t -= 600.0
    assert 0.0 <= decayed.rate() < 1e-3
    be._drain = decayed
    be.slo_ttft["batch"] = 0.5
    try:
        assert len(be.submit([1, 8, 8], 4, _smp(), klass="batch").wait(timeout=120)) == 4
        # with a backlog the same projection sheds
        hold = _Hold(be)
        try:
            queued = be.submit([1, 8, 9], 4, _smp(), klass="batch")
            with pytest.raises(EngineSaturated, match="slo_ttft"):
                be.submit([1, 8, 10], 4, _smp(), klass="batch")
            queued.cancel()
        finally:
            hold.release()
    finally:
        be._drain, be.slo_ttft = old_drain, old_tgt


def test_tpot_gate_refuses_batch_only(engine):
    be = engine
    old = be.slo_tpot_interactive, be._tpot_ema_ms
    be.slo_tpot_interactive, be._tpot_ema_ms = 0.001, 50.0
    try:
        with pytest.raises(EngineSaturated, match="slo_tpot"):
            be.submit([1, 5], 2, _smp(), klass="batch")
        assert len(be.submit([1, 5], 2, _smp()).wait(timeout=120)) == 2
    finally:
        be.slo_tpot_interactive, be._tpot_ema_ms = old


def test_interactive_evicts_queued_batch_when_saturated(engine):
    be = engine
    hold = _Hold(be)
    try:
        be.max_queue = 2
        queued = [be.submit([1, 50 + i, 5], 8, _smp(), klass="batch") for i in range(2)]
        inter = be.submit([1, 2, 3], 4, _smp(), klass="interactive")
        shed = [r for r in queued if r.done.is_set()]
        assert len(shed) == 1 and isinstance(shed[0].error, EngineSaturated)
        assert shed[0].error.retry_after >= 1.0
        # the least entitled resident (the newer arrival of the same tenant) went
        assert shed[0] is queued[1]
        # a batch arrival as entitled as the worst resident is refused itself
        with pytest.raises(EngineSaturated, match="queue"):
            be.submit([1, 60, 5], 8, _smp(), klass="batch")
    finally:
        be.max_queue = 0
        hold.release()
    assert len(inter.wait(timeout=300)) == 4
    assert len(queued[0].wait(timeout=300)) == 8


def test_weighted_displacement_of_batch_by_batch(engine):
    """At max_queue a batch arrival more entitled (a smaller virtual finish tag) than the
    queue's worst batch resident displaces it."""
    be = engine
    hold = _Hold(be)
    try:
        be.max_queue = 2
        flood = [be.submit([1, 70 + i, 5], 8, _smp(), tenant="flood", klass="batch")
                 for i in range(2)]
        gold = be.submit([1, 80, 5], 8, _smp(), tenant="alpha", klass="batch")
        assert flood[1].done.is_set() and isinstance(flood[1].error, EngineSaturated)
        assert not flood[0].done.is_set() and not gold.done.is_set()
    finally:
        be.max_queue = 0
        hold.release()
    assert len(gold.wait(timeout=300)) == 8 and len(flood[0].wait(timeout=300)) == 8


def test_engine_saturated_retry_after_is_drain_derived(engine):
    be = engine

    class StubDrain:
        floor = 1.0

        def note(self, n=1.0):
            pass

        def rate(self):
            return 0.125  # one completion every 8 s

        def queue_wait(self, depth):
            return depth / 0.125

        def retry_after(self, depth):
            return min(max(depth / 0.125, 1.0), 60.0)

    old = be._drain
    hold = _Hold(be)
    try:
        be._drain, be.max_queue = StubDrain(), 1
        queued = be.submit([1, 77], 4, _smp(), klass="batch")
        with pytest.raises(EngineSaturated) as ei:
            be.submit([1, 78], 4, _smp(), klass="batch")
        assert 16.0 <= ei.value.retry_after <= 60.0  # depth 1 + 1 at 0.125/s
        queued.cancel()
    finally:
        be._drain, be.max_queue = old, 0
        hold.release()


def test_quota_throttles_at_the_engine_and_refunds_a_shed(engine):
    be = engine
    be.tenants._policies["capped"] = tenancy.TenantPolicy("capped", weight=1.0, rate=20.0,
                                                          burst=40.0)
    try:
        with pytest.raises(QuotaExceeded) as ei:
            for _ in range(8):
                be.submit([1, 4, 4], 30, _smp(), tenant="capped").wait(timeout=120)
        assert ei.value.retry_after > 0.0 and ei.value.tenant == "capped"
        assert be.tenants.stats()["capped"]["throttled"] >= 1
        # a request shed after its debit gets the debit back
        bucket = be.tenants.resolve("capped").bucket
        bucket._tokens = bucket.burst
        hold = _Hold(be)
        try:
            be.max_queue = 1
            # interactive both: no queued batch request to evict, so the arrival sheds
            queued = be.submit([1, 5], 4, _smp())
            before = bucket.available()
            with pytest.raises(EngineSaturated):
                be.submit([1, 6], 4, _smp(), tenant="capped")
            assert bucket.available() >= before
            queued.cancel()
        finally:
            be.max_queue = 0
            hold.release()
    finally:
        del be.tenants._policies["capped"]


# ------------------------------------------------------------------
# the server: X-Tenant, "class", 429
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tenant_server(files):  # noqa: F811
    reg = tenancy.TenantRegistry.parse("gold:weight=4;capped:weight=1,rate=8,burst=40")
    be = BatchEngine.load(*files, slots=2, device="cpu", superstep=4, tenants=reg)
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, be, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    be.close()


BODY = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 2,
        "temperature": 0}


def test_api_tenant_and_class_reach_the_engine(tenant_server, monkeypatch):
    _srv, be, port = tenant_server
    seen = []
    submit = be.submit

    def spy(*a, **kw):
        req = submit(*a, **kw)
        seen.append((req.tenant, req.klass))
        return req
    monkeypatch.setattr(be, "submit", spy)
    assert _call(port, {**BODY, "class": "batch"}, {"X-Tenant": "gold"})[0] == 200
    assert _call(port, BODY, {"X-Tenant": "gold", "X-Class": "batch"})[0] == 200
    assert _call(port, {**BODY, "class": "interactive"}, {"X-Class": "batch"})[0] == 200
    assert _call(port, BODY, {"X-Tenant": "bad tenant!"})[0] == 200
    assert seen == [("gold", "batch"), ("gold", "batch"), ("default", "interactive"),
                    ("default", "interactive")]
    code, _, raw = _call(port, {**BODY, "class": "express"})
    assert code == 400 and json.loads(raw)["error"]["type"] == "invalid_request_error"


def test_api_quota_429_with_retry_after(tenant_server):
    _srv, _be, port = tenant_server
    saw = None
    for _ in range(8):
        code, headers, raw = _call(port, {**BODY, "max_tokens": 16}, {"X-Tenant": "capped"})
        if code == 429:
            saw = headers, json.loads(raw)
            break
    assert saw is not None, "the quota never throttled"
    headers, payload = saw
    assert payload["error"]["type"] == "rate_limit_error"
    assert int(headers["Retry-After"]) >= 1
    # the throttle is the tenant's, not the server's: gold is served
    assert _call(port, BODY, {"X-Tenant": "gold"})[0] == 200


def test_single_engine_debits_the_tenant(files):  # noqa: F811
    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = Engine.load(*files, device="cpu")
    reg = tenancy.TenantRegistry.parse("capped:rate=8,burst=40")
    srv = api_server.serve(eng, "127.0.0.1", 0, TemplateType.CHATML, tenants=reg)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        codes = [_call(port, {**BODY, "max_tokens": 16}, {"X-Tenant": "capped"})[0]
                 for _ in range(4)]
        assert codes[0] == 200 and 429 in codes
        assert _call(port, BODY, {"X-Tenant": "other"})[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()


def test_tenants_flags_parse_and_validate():
    p = api_server.build_parser()
    args = p.parse_args(["--model", "m", "--tokenizer", "t", "--tenants",
                         "gold:weight=4;free:rate=50", "--slo-ttft-interactive", "0.5",
                         "--slo-ttft-batch", "4", "--slo-tpot", "0.05"])
    assert (args.tenants, args.slo_ttft_interactive, args.slo_ttft_batch,
            args.slo_tpot) == ("gold:weight=4;free:rate=50", 0.5, 4.0, 0.05)
    defaults = p.parse_args(["--model", "m", "--tokenizer", "t"])
    assert (defaults.tenants, defaults.slo_ttft_interactive, defaults.slo_ttft_batch,
            defaults.slo_tpot) == (None, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        api_server.build_server(p.parse_args(["--model", "m", "--tokenizer", "t",
                                              "--tenants", "x:speed=3"]))
