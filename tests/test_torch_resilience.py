"""PyTorch port: request control and recovery (resilience/, the BatchEngine's admission,
retry, drain and recovery paths, the server's error mapping, drain and resume) against
the JAX package's resilience layer and BatchEngine on one tiny `.m`/`.t` pair.

The cases mirror tests/test_resilience.py, the supervisor units of tests/test_durable.py
and the fleet's mid-stream wedge: the copies (the DLLAMA_FAULTS grammar, classify,
retriable, the seeded fault RNG) are held against the JAX modules; every token list
that the JAX tests compare (survivors of a killed co-batched request, a transient retry,
the tokens after a recovery) is held against the JAX BatchEngine in the same
configuration (2 slots, superstep 4, pipelined, paged KV with the prefix cache). Slots
are held by token callbacks that wait on an event, never by a timing race: a callback
runs on the scheduler thread, so while it waits nothing is admitted, reaped or
dispatched, and every TTL or deadline below has passed ten times over when it is
released.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.resilience import errors as jerrors
from distributed_llama_tpu.resilience import faults as jfaults
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.cache.device_pool import DeviceKVPool, KVPoolExhausted
from distributed_llama_tpu_torch.resilience import errors, faults
from distributed_llama_tpu_torch.resilience.errors import (DeadlineExceeded, EngineClosed,
                                                           EngineDraining,
                                                           EngineSaturated, EngineWedged,
                                                           FaultInjected,
                                                           TransientDispatchError,
                                                           classify)
from distributed_llama_tpu_torch.resilience.faults import FaultSpec
from distributed_llama_tpu_torch.resilience.supervisor import EngineSupervisor
from distributed_llama_tpu_torch.resilience.tenancy import DrainRate
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler
from distributed_llama_tpu_torch.runtime.step_graph import StepGraphs
from distributed_llama_tpu_torch.tokenizer import TemplateType

V = 262
SURVIVOR = [1, 7, 23, 5]
HOLD = 0.5  # seconds a held scheduler waits past a TTL or deadline of HOLD / 10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    """Every test leaves both processes' fault injectors empty."""
    yield
    faults.uninstall()
    jfaults.uninstall()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_resil")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=V, seq_len=192).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=11)
    mpath = str(tmp / "m.m")
    write_model(mpath, spec, params_file_order(spec, params), FloatType.Q40)
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [
        b"<|im_start|>", b"<|im_end|>", b" "]
    tpath = str(tmp / "t.t")
    write_tokenizer(tpath, TokenizerData(
        vocab=vocab, scores=[0.0] * 259 + [-1.0, -1.0, -1.5], bos_id=1, eos_id=2,
        chat_eos_id=260, max_token_length=12, chat_template="{{<|im_start|>}}"))
    return mpath, tpath


def _port(files, **kw):
    return BatchEngine.load(*files, slots=2, device="cpu", superstep=4, **kw)


@pytest.fixture(scope="module")
def be(files):
    eng = _port(files)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def jax_ref(files):
    """Solo runs of the JAX BatchEngine in the port's configuration, memoized by
    (prompt, max_tokens, temperature, seed)."""
    jbe = JBatchEngine.load(*files, slots=2, tp=1, superstep=4)
    memo = {}

    def ref(prompt, n, temp=0.0, seed=0):
        key = (tuple(prompt), n, temp, seed)
        if key not in memo:
            memo[key] = jbe.submit(list(prompt), n,
                                   JSampler(V, temp, 0.9, seed)).wait(timeout=300)
        return memo[key]
    yield ref
    jbe.close()


def _smp(temp=0.0, seed=0):
    return Sampler(V, temp, 0.9, seed)


def _wait_until(cond, timeout=60.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


class _Hold:
    """Blockers that occupy every slot of an engine: each one's token callback waits on
    an event once all slots hold a request, which parks the scheduler thread (the
    callback runs on it) until release()."""

    def __init__(self, be, n_tokens=150):
        self.be = be
        self.event = threading.Event()
        self.parked = threading.Event()

        def on_token(_t):
            if all(s.req is not None for s in be._slots):
                self.parked.set()
                self.event.wait(60)
        self.reqs = [be.submit([1, 2, 3 + i], n_tokens, _smp(), on_token=on_token)
                     for i in range(be.slots_n)]
        assert self.parked.wait(60), "the blockers never held every slot"

    def release(self):
        self.event.set()
        for r in self.reqs:
            r.cancel()
        for r in self.reqs:
            r.done.wait(60)


# ------------------------------------------------------------------
# the copies against the JAX modules
# ------------------------------------------------------------------

GOOD_SPECS = ["batch.dispatch:transient:0.01", "batch.prefill:error",
              "paged.*:latency:1.0:3:50", "p:latency:1::800:45", "p:error:1:2:3:4",
              "p:error:1:2:3", "a:error,b:transient:0.5:inf", " x:latency:0.25:: ,"]
BAD_SPECS = ["point-only", "p:unknownkind", "p:error:notaprob", "p:error:1:2:3:notasecs",
             "p:error:1:2:3:4:5", "p:error:1:x"]
FIELDS = ("point", "kind", "prob", "count", "after", "delay_ms", "scope", "match",
          "duration_s")


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_parse_faults_matches_jax(text):
    got = [[getattr(s, f) for f in FIELDS] for s in faults.parse_faults(text)]
    want = [[getattr(s, f) for f in FIELDS] for s in jfaults.parse_faults(text)]
    assert got == want and got


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_faults_rejects_as_jax(text):
    with pytest.raises(ValueError) as jei:
        jfaults.parse_faults(text)
    with pytest.raises(ValueError) as ei:
        faults.parse_faults(text)
    assert str(ei.value) == str(jei.value)


ERRORS = [("EngineClosed", ("x",)), ("EngineDraining", ("x",)),
          ("EngineSaturated", ("x", 2.0)), ("QuotaExceeded", ("x", 2.0, "t")),
          ("DeadlineExceeded", ("x",)), ("InvalidRequest", ("x",)),
          ("TransientDispatchError", ("x",)), ("EngineWedged", ("x",)),
          ("FaultInjected", ("x", "request")), ("FaultInjected", ("x", "engine"))]


@pytest.mark.parametrize("name,args", ERRORS, ids=[f"{n}-{a[-1]}" for n, a in ERRORS])
def test_classify_and_retriable_match_jax(name, args):
    e, je = getattr(errors, name)(*args), getattr(jerrors, name)(*args)
    assert errors.classify(e) == jerrors.classify(je)
    assert errors.retriable(e) == jerrors.retriable(je)
    # the class tree matches too (which handler catches what)
    assert ([c.__name__ for c in type(e).__mro__]
            == [c.__name__ for c in type(je).__mro__])
    assert set(errors.__all__) == set(jerrors.__all__)
    assert classify(KVPoolExhausted("x")) == "request"
    assert classify(RuntimeError("x")) == "engine"


def test_fault_prob_stream_matches_jax():
    """The seeded plan fires on the same hits as the JAX plan."""
    def run(mod, err, seed):
        plan = mod.FaultPlan([mod.FaultSpec("p", kind="transient", prob=0.5)], seed=seed)
        out = []
        for _ in range(64):
            try:
                plan.fire("p")
                out.append(0)
            except err:
                out.append(1)
        return out

    a = run(faults, TransientDispatchError, 7)
    assert a == run(jfaults, jerrors.TransientDispatchError, 7) and 0 < sum(a) < 64
    assert run(faults, TransientDispatchError, 8) != a


def test_fault_spec_count_after_match_and_env():
    with faults.active(FaultSpec("pt", kind="error", after=2, count=1)) as plan:
        faults.fire("pt")
        faults.fire("pt")
        with pytest.raises(FaultInjected):
            faults.fire("pt")
        faults.fire("pt")  # count exhausted
        assert plan.fired() == 1
    with faults.active(FaultSpec("pt", match={"slot": 1})):
        faults.fire("pt", slot=0)
        with pytest.raises(FaultInjected):
            faults.fire("pt", slot=1)
    assert faults.current() is None
    plan = faults.install_from_env({"DLLAMA_FAULTS": "x:error:0.5",
                                    "DLLAMA_FAULT_SEED": "9"})
    assert plan is not None and plan.seed == 9
    assert faults.install_from_env({"DLLAMA_FAULTS": "y:error"}) is plan
    faults.uninstall()
    assert faults.install_from_env({}) is None


def test_latency_fault_sleeps_and_release_wakes():
    with faults.active(FaultSpec("slow", kind="latency", delay_ms=30)):
        t0 = time.perf_counter()
        faults.fire("slow")
        assert time.perf_counter() - t0 >= 0.025
    with faults.active(FaultSpec("park", kind="latency", delay_ms=600_000)) as plan:
        t = threading.Thread(target=faults.fire, args=("park",), daemon=True)
        t.start()
        _wait_until(lambda: plan.fired() == 1, msg="parked")
        faults.release()
        t.join(10)
        assert not t.is_alive()


def test_drain_rate():
    d = DrainRate(floor=1.0, cap=60.0, tau=10.0)
    assert d.rate() == 0.0 and d.queue_wait(5) == 0.0 and d.retry_after(5) == 1.0
    for _ in range(20):
        d.note()
    assert d.rate() > 0 and 1.0 <= d.retry_after(1000) <= 60.0


class _StubEngine:
    def __init__(self, age=99.0, reinit_ok=True):
        self.age = age
        self.reinit_ok = reinit_ok
        self.recovers = 0
        self.decode_steps = 0

    def dispatch_age(self):
        return self.age

    def scheduler_alive(self):
        return True

    def recover_wedged(self):
        self.recovers += 1
        return self.reinit_ok


def test_supervisor_failed_when_reinit_fails():
    sup = EngineSupervisor(_StubEngine(reinit_ok=False), threshold=1.0, poll=0.05)
    sup.check_once()
    assert sup.state == "failed" and not sup.healthy
    sup.check_once()  # failed is terminal
    assert sup.engine.recovers == 1


def test_supervisor_gives_up_after_max_recoveries():
    eng = _StubEngine()
    sup = EngineSupervisor(eng, threshold=1.0, poll=0.05, max_recoveries=2)
    for _ in range(5):
        sup.check_once()  # no dispatch progress between escalations
    assert sup.state == "failed" and eng.recovers == 2
    # progress between isolated wedges resets the count
    eng2 = _StubEngine()
    sup2 = EngineSupervisor(eng2, threshold=1.0, poll=0.05, max_recoveries=2)
    for _ in range(4):
        sup2.check_once()
        eng2.age, eng2.decode_steps = 0.0, eng2.decode_steps + 1
        sup2.check_once()
        eng2.age = 99.0
    assert sup2.state == "ok" and eng2.recovers == 4


def test_pool_and_graph_resets():
    pool = DeviceKVPool(8, 16)
    ids = pool.alloc(5)
    pool.incref(ids[:2])
    pool.reset()
    assert pool.free_blocks() == 7 and pool.refcounts().tolist() == [1] + [0] * 7
    g = StepGraphs("cpu", False)
    g.captures, g.replays = 3, 9
    g.reset()
    assert g.keys() == [] and (g.captures, g.replays) == (3, 9)


# ------------------------------------------------------------------
# blast radius: one co-batched request killed, the survivor the JAX engine's
# ------------------------------------------------------------------

@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "seeded"])
def test_victim_killed_mid_prefill_survivor_identical(be, jax_ref, temp):
    want = jax_ref(SURVIVOR, 24, temp, 5)
    surv = be.submit(SURVIVOR, 24, _smp(temp, 5))
    _wait_until(lambda: len(surv.out) >= 1, msg="survivor decoding")
    faults.install([FaultSpec("batch.prefill", kind="error", count=1)])
    victim = be.submit([1] + list(range(2, 42)), 8, _smp(temp, 6))
    with pytest.raises(FaultInjected):
        victim.wait(timeout=120)
    assert victim.finish == "error"
    assert surv.wait(timeout=120) == want and surv.finish == "length"
    assert be.scheduler_alive()


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "seeded"])
def test_victim_killed_mid_superstep_survivor_identical(be, jax_ref, temp):
    prompt = [1, 9, 2]
    want = jax_ref(prompt, 24, temp, 7)
    surv = be.submit(prompt, 24, _smp(temp, 7))
    victim = be.submit([1, 30, 31, 32], 64, _smp(temp, 8))
    _wait_until(lambda: len(victim.out) >= 1 and len(surv.out) >= 1, msg="both decoding")
    vslot = next(s for s in be._slots if s.req is victim)
    faults.install([FaultSpec("batch.emit", kind="error", count=1,
                              match={"slot": vslot.index})])
    with pytest.raises(FaultInjected):
        victim.wait(timeout=120)
    assert victim.finish == "error"
    assert surv.wait(timeout=120) == want
    assert be.scheduler_alive()


def test_radix_lookup_failure_degrades_not_kills(be, jax_ref, monkeypatch):
    prompt = [1, 17, 18, 19]
    inflight = be.submit(SURVIVOR, 24, _smp())
    _wait_until(lambda: len(inflight.out) >= 1, msg="in-flight decoding")

    def boom(*a, **k):
        raise RuntimeError("radix lookup boom")

    monkeypatch.setattr(be.prefix_cache, "lookup", boom)
    poisoned = be.submit(prompt, 8, _smp())
    assert poisoned.wait(timeout=120) == jax_ref(prompt, 8) and poisoned.error is None
    assert inflight.wait(timeout=120) == jax_ref(SURVIVOR, 24)
    assert be.scheduler_alive()


def test_cache_seed_fault_degrades_to_prefill(be, jax_ref):
    prompt = [1] + list(range(40, 60))
    want = jax_ref(prompt, 4)
    assert be.submit(prompt, 4, _smp()).wait(timeout=120) == want
    before = be.prefilled_tokens
    with faults.active(FaultSpec("batch.cache_seed", kind="error")) as plan:
        out = be.submit(prompt, 4, _smp()).wait(timeout=120)
        assert plan.fired() >= 1
    assert out == want and be.prefilled_tokens >= before


# ------------------------------------------------------------------
# transient dispatch failures: retried before the first launch
# ------------------------------------------------------------------

def test_transient_dispatch_retried(be, jax_ref):
    r0 = be.retries
    with faults.active(FaultSpec("batch.dispatch", kind="transient", count=2)) as plan:
        req = be.submit(SURVIVOR, 10, _smp())
        out = req.wait(timeout=120)
        assert plan.fired() == 2
    assert out == jax_ref(SURVIVOR, 10)
    assert req.error is None and req.finish == "length"
    assert be.retries == r0 + 2


def test_transient_after_the_first_launch_is_not_retried(be):
    """A transient failure raised after the dispatch's first launch (here from inside
    the super-step's device loop, once its guard passed) propagates: engine scope."""
    r0 = be.retries
    with faults.active(FaultSpec("device_loop.batched_dispatch", kind="transient",
                                 count=1)):
        out = be.submit([1, 2, 3], 12, _smp()).wait(timeout=120)
    assert len(out) == 12 and be.retries == r0 + 1  # before the guard: retried
    real = be._before_launch

    def launched_then_fail():
        real()
        raise TransientDispatchError("after the first launch")

    be._before_launch = launched_then_fail
    try:
        req = be.submit([1, 2, 4], 6, _smp())
        with pytest.raises(TransientDispatchError):
            req.wait(timeout=120)
    finally:
        del be._before_launch
    assert be.retries == r0 + 1 and be.scheduler_alive()
    assert len(be.submit([1, 2, 3], 4, _smp()).wait(timeout=120)) == 4


def test_transient_exhausted_fails_requests_but_scheduler_survives(be):
    with faults.active(FaultSpec("batch.dispatch", kind="transient")):
        req = be.submit([1, 2, 3], 8, _smp())
        with pytest.raises(TransientDispatchError):
            req.wait(timeout=120)
        assert req.finish == "error"
    assert be.scheduler_alive()
    assert len(be.submit([1, 2, 3], 4, _smp()).wait(timeout=120)) == 4
    assert all(s.req is None for s in be._slots)


# ------------------------------------------------------------------
# admission control: TTL, deadline, shedding
# ------------------------------------------------------------------

def test_queue_ttl_expires_every_queued_request(be):
    hold = _Hold(be)
    try:
        victims = [be.submit([1, 4, 5 + i], 8, _smp(), ttl=HOLD / 10) for i in range(2)]
        time.sleep(HOLD)
    finally:
        hold.release()
    for v in victims:
        with pytest.raises(DeadlineExceeded):
            v.wait(timeout=60)
        assert v.finish == "deadline" and v.out == []


def test_deadline_before_first_token_errors(be):
    hold = _Hold(be)
    try:
        victim = be.submit([1, 6, 7], 8, _smp(), deadline=HOLD / 10)
        time.sleep(HOLD)
    finally:
        hold.release()
    with pytest.raises(DeadlineExceeded):
        victim.wait(timeout=60)
    assert victim.finish == "deadline" and victim.out == []


def test_generation_deadline_keeps_partial_output(be):
    """The request's own first token waits until its deadline has passed (the token
    comes tens of times sooner than the deadline): the next pass ends it with finish
    "deadline" and the tokens it had."""
    held = []
    past = time.perf_counter() + 4 * HOLD + HOLD / 10  # the deadline, and some

    def on_token(_t):
        if not held:
            held.append(1)
            time.sleep(max(past - time.perf_counter(), 0.0))
    req = be.submit([1, 2, 3], 150, _smp(), on_token=on_token, deadline=4 * HOLD)
    out = req.wait(timeout=120)  # no error: there was output
    assert req.finish == "deadline" and req.error is None
    # the host-sampled first token, then at most the one super-step dispatched in the
    # same pass (a chain past the deadline is not planned)
    assert 1 <= len(out) <= 1 + be.superstep


def test_admission_shedding(be):
    hold = _Hold(be)
    try:
        be.max_queue = 1
        queued = be.submit([1, 8, 9], 8, _smp())
        with pytest.raises(EngineSaturated) as ei:
            be.submit([1, 10, 11], 8, _smp())
        assert ei.value.retry_after > 0
        stats = be.load_stats()
        assert stats == {"slots": 2, "free_slots": 0, "queue_depth": 1, "draining": False}
        assert be.dispatch_age() > 0
        queued.cancel()
    finally:
        be.max_queue = 0
        hold.release()
    queued.done.wait(60)
    _wait_until(lambda: be.dispatch_age() == 0.0, msg="idle")


# ------------------------------------------------------------------
# close, drain
# ------------------------------------------------------------------

def test_close_aborts_with_typed_errors(files):
    eng = _port(files, prefix_cache=False)
    hold = _Hold(eng)
    queued = eng.submit([1, 4, 5], 8, _smp())
    threading.Timer(HOLD, hold.event.set).start()
    eng.close()
    for r in hold.reqs + [queued]:
        with pytest.raises(EngineClosed):
            r.wait(timeout=60)
    with pytest.raises(EngineClosed):
        eng.submit([1], 1, _smp())


def test_drain_lets_inflight_and_queued_finish(files, jax_ref):
    eng = _port(files, prefix_cache=False)
    gate = threading.Event()
    reqs = [eng.submit([1, 2, 3 + i], 8, _smp(), on_token=lambda _t: gate.wait(60))
            for i in range(3)]  # two in slots, one queued
    done = threading.Event()
    t = threading.Thread(target=lambda: (eng.close(drain=True, timeout=120), done.set()))
    t.start()
    try:
        _wait_until(lambda: eng.draining, msg="drain engaged")
        with pytest.raises(EngineDraining):
            eng.submit([1], 1, _smp())
        gate.set()
        for i, r in enumerate(reqs):
            assert r.wait(timeout=120) == jax_ref([1, 2, 3 + i], 8)
            assert r.finish == "length"
        _wait_until(done.is_set, msg="drain close completed")
    finally:
        gate.set()
        t.join(timeout=120)
    with pytest.raises(EngineClosed):
        eng.submit([1], 1, _smp())


# ------------------------------------------------------------------
# recovery
# ------------------------------------------------------------------

def _park_scheduler(eng):
    """Install a 600 s latency fault at batch.dispatch and submit two requests; returns
    (plan, requests, the parked scheduler thread) once it sleeps in the fault."""
    plan = faults.install([FaultSpec("batch.dispatch", kind="latency",
                                     delay_ms=600_000, count=1)])
    reqs = [eng.submit([1, 9, 9, 2], 8, _smp()), eng.submit([1, 3, 3], 8, _smp())]
    _wait_until(lambda: plan.fired() == 1, msg="scheduler parked")
    return plan, reqs, eng._thread


def test_recover_wedged_fails_inflight_and_serves_after(files, jax_ref):
    """The supervisor detects the parked dispatch; recover_wedged fails every request
    (retriable EngineWedged), the abandoned thread makes no dispatch when it wakes, and
    the engine then serves the JAX engine's tokens with its pool whole."""
    eng = _port(files)
    try:
        want = jax_ref([1, 5, 6, 7], 10)
        assert eng.submit([1, 5, 6, 7], 10, _smp()).wait(timeout=120) == want
        k0 = eng.engine.k_cache
        plan, reqs, zombie = _park_scheduler(eng)
        queued = eng.submit([1, 4], 4, _smp())
        sup = EngineSupervisor(eng, threshold=0.05, poll=1.0)
        _wait_until(lambda: eng.dispatch_age() > 0.1, msg="age past the threshold")
        d0 = eng.dispatches
        sup.check_once()
        assert sup.recoveries == 1 and sup.healthy and eng.wedge_recoveries == 1
        for r in reqs + [queued]:
            with pytest.raises(EngineWedged):
                r.wait(timeout=10)
            assert errors.retriable(r.error)
        faults.release()  # wake the abandoned thread: it must unwind with no launch
        zombie.join(10)
        assert not zombie.is_alive() and eng.dispatches == d0
        faults.uninstall()
        assert eng.engine.k_cache is k0 and float(k0.abs().sum()) == 0.0
        assert eng.kv_pool.free_blocks() == eng.kv_pool.n_blocks - 1
        assert eng.submit([1, 5, 6, 7], 10, _smp()).wait(timeout=120) == want
        assert eng.release_idle() == eng.kv_pool.n_blocks - 1
    finally:
        faults.release()
        eng.close()


def test_recover_wedged_reinit_failure(files, jax_ref):
    """A re-initialization that raises returns False and the supervisor fails for good
    (a device whose every launch fails must not cycle through recoveries); a later
    recovery that succeeds serves again."""
    eng = _port(files)
    try:
        plan, reqs, zombie = _park_scheduler(eng)
        with faults.active(FaultSpec("engine.reinit", kind="error", scope="engine")):
            sup = EngineSupervisor(eng, threshold=0.01, poll=1.0)
            _wait_until(lambda: eng.dispatch_age() > 0.02, msg="age past the threshold")
            sup.check_once()
        assert sup.state == "failed" and not sup.healthy
        for r in reqs:
            with pytest.raises(EngineWedged):
                r.wait(timeout=10)
        faults.release()
        zombie.join(10)
        assert not zombie.is_alive()
        assert eng.recover_wedged() is True
        assert eng.submit([1, 5, 6, 7], 10, _smp()).wait(timeout=120) == jax_ref(
            [1, 5, 6, 7], 10)
    finally:
        faults.release()
        eng.close()


def test_submit_racing_recover_wedged_is_served(files, jax_ref):
    """A request submitted while recover_wedged waits for the abandoned thread (asleep
    in a dispatch, holding the scheduler lock of its epoch) starts a scheduler that
    waits for the recovery alone: it is served, with the JAX engine's seeded tokens,
    while that thread still sleeps, and the requests queued before the recovery fail
    with EngineWedged."""
    eng = _port(files)
    try:
        want = jax_ref([1, 5, 6, 7], 10, 0.8, 3)
        plan, reqs, zombie = _park_scheduler(eng)
        queued = eng.submit([1, 4], 4, _smp())
        late = []
        join = zombie.join

        def join_after_a_submit(timeout=None):  # the submit lands inside the join
            late.append(eng.submit([1, 5, 6, 7], 10, _smp(0.8, 3)))
            return join(timeout)
        zombie.join = join_after_a_submit
        assert eng.recover_wedged() is True
        assert len(late) == 1 and late[0].wait(timeout=120) == want
        assert late[0].finish == "length" and zombie.is_alive()
        for r in reqs + [queued]:
            with pytest.raises(EngineWedged):
                r.wait(timeout=10)
        faults.release()
        zombie.join(10)
        assert not zombie.is_alive()
    finally:
        faults.release()
        eng.close()


def test_engine_fault_points_fire_outside_the_steps(files):
    """engine.dispatch fires per single-sequence dispatch, device_loop.* once per loop
    call on the host (never inside a captured step)."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = Engine.load(*files, device="cpu")
    spec = FaultSpec("engine.dispatch", kind="latency", delay_ms=0)
    loop = FaultSpec("device_loop.dispatch", kind="latency", delay_ms=0)
    with faults.active(spec, loop):
        eng.generate([1, 2, 3] + list(range(4, 14)), 3, _smp())  # 13 = 8 + 1 x 5
        assert spec.fired == 6 + 3 and loop.fired == 0  # 6 prefill chunks, 3 steps
        eng.reset()
        eng.generate_chunked([1, 2, 3], 8, _smp(), chunk=4)
        assert loop.fired == 2
    k0 = eng.k_cache.data_ptr()
    eng.reset_backend()
    assert eng.k_cache.data_ptr() == k0 and eng.pos == 0 and not eng._decode_loops


def test_batched_fault_points(be):
    specs = [FaultSpec(p, kind="latency", delay_ms=0) for p in
             ("batch.submit", "batch.dispatch", "batch.prefill", "batch.emit",
              "device_loop.batched_dispatch")]
    with faults.active(*specs):
        out = be.submit([1, 2, 3], 9, _smp()).wait(timeout=120)
    fired = {s.point: s.fired for s in specs}
    assert fired["batch.submit"] == 1 and fired["batch.emit"] == len(out) == 9
    assert fired["batch.prefill"] >= 1 and fired["device_loop.batched_dispatch"] >= 1
    assert fired["batch.dispatch"] >= 1 + fired["device_loop.batched_dispatch"]


# ------------------------------------------------------------------
# the server: error mapping, deadlines, health, drain
# ------------------------------------------------------------------

def _server(files, **be_kw):
    eng = BatchEngine.load(*files, device="cpu", **be_kw)
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=eng)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, eng, srv.server_address[1]


@pytest.fixture(scope="module")
def resil_server(files):
    srv, eng, port = _server(files, slots=1, superstep=4)
    yield srv, eng, port
    srv.shutdown()
    srv.server_close()
    eng.close()


def _call(port, body=None, headers=None, path="/v1/chat/completions"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


HI = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0}


def test_server_validation_400(resil_server):
    _, _, port = resil_server
    for body in ({"messages": [{"role": "user", "content": "ab" * 400}], "max_tokens": 4},
                 {**HI, "max_tokens": -1}, {**HI, "max_tokens": 2.5},
                 {**HI, "max_tokens": True}, {**HI, "resume": {"tokens": ["no"]}},
                 {"messages": [{"role": "user", "content": "ab" * 400}], "stream": True}):
        code, _, raw = _call(port, body)
        assert code == 400, body
        assert json.loads(raw)["error"]["type"] == "invalid_request_error"
    for bad in ("nan", "inf", "-inf", "soon"):
        assert _call(port, HI, {"X-Deadline-Ms": bad})[0] == 400
    code, _, raw = _call(port, HI, {"X-Deadline-Ms": "0"})
    assert code == 408 and json.loads(raw)["error"]["type"] == "timeout_error"


def test_server_sheds_503_and_expires_408(resil_server):
    _, eng, port = resil_server
    hold = _Hold(eng)
    try:
        eng.max_queue = 1
        queued = eng.submit([1, 4, 5], 4, _smp())
        code, headers, raw = _call(port, HI)
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert json.loads(raw)["error"]["type"] == "overloaded_error"
        code, _, raw = _call(port, path="/healthz")
        replica = json.loads(raw)["replica"]
        assert code == 200 and replica["queue_depth"] == 1 and replica["free_slots"] == 0
        assert replica["pid"] == os.getpid() and replica["uptime_s"] >= 0
        queued.cancel()
        eng.max_queue = 0
        eng.queue_ttl = HOLD / 10
        got = {}
        t = threading.Thread(target=lambda: got.update(r=_call(port, HI)))
        t.start()
        _wait_until(lambda: len(eng._queue) == 2, msg="the request queued")
        time.sleep(HOLD)
    finally:
        eng.max_queue = 0
        hold.release()
    t.join(60)
    eng.queue_ttl = 0.0
    code, _, raw = got["r"]
    assert code == 408 and json.loads(raw)["error"]["type"] == "timeout_error"


def test_server_maps_wedge_and_deadline(resil_server):
    assert api_server._map_error(EngineWedged("x"))[:2] == (503, "server_wedged")
    assert api_server._map_error(EngineDraining("x"))[0] == 503
    assert api_server._map_error(errors.QuotaExceeded("x", 3.0)) == (
        429, "rate_limit_error", 3.0)
    assert api_server._map_error(RuntimeError("x"))[0] == 500
    _, eng, port = resil_server
    # a deadline landing mid-generation (its first token stalls past it): 200 with the
    # partial output
    with faults.active(FaultSpec("batch.emit", kind="latency", delay_ms=3 * HOLD * 1000,
                                 after=1, count=1)):
        code, _, raw = _call(port, {**HI, "max_tokens": 100},
                             {"X-Deadline-Ms": str(2 * HOLD * 1000)})
    assert code == 200
    assert json.loads(raw)["choices"][0]["finish_reason"] == "deadline"


def test_single_engine_request_deadline(files):
    from distributed_llama_tpu_torch.runtime.engine import Engine

    srv = api_server.serve(Engine.load(*files, device="cpu"), "127.0.0.1", 0,
                           TemplateType.CHATML, request_deadline=HOLD / 10)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with faults.active(FaultSpec("engine.dispatch", kind="latency",
                                     delay_ms=HOLD * 1000, after=1, count=1)):
            code, _, raw = _call(srv.server_address[1], {**HI, "max_tokens": 100})
        assert code == 200
        assert json.loads(raw)["choices"][0]["finish_reason"] == "deadline"
    finally:
        srv.shutdown()
        srv.server_close()


def test_server_supervisor_in_healthz(files):
    srv, eng, port = _server(files, slots=2, superstep=4)
    try:
        srv.api_state.supervisor = sup = EngineSupervisor(eng, threshold=0.05, poll=1.0)
        code, _, raw = _call(port, path="/healthz")
        assert code == 200 and json.loads(raw)["supervisor"]["state"] == "ok"
        sup.state = "recovering"
        code, _, raw = _call(port, path="/healthz")
        assert code == 503 and "supervisor" in json.loads(raw)["reason"]
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def test_server_sigterm_drain_round_trip(files):
    """SIGTERM against `python -m distributed_llama_tpu_torch.apps.api_server --device
    cpu`: /healthz answers 503 "draining", a new request 503, the in-flight request
    completes 200, and the process exits 0. DLLAMA_FAULTS paces each dispatch at 100 ms
    so the in-flight request outlives the checks by seconds."""
    env = dict(os.environ, DLLAMA_FAULTS="batch.dispatch:latency:1::100",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "distributed_llama_tpu_torch.apps.api_server",
         "--model", files[0], "--tokenizer", files[1], "--device", "cpu", "--batch", "2",
         "--superstep", "1", "--host", "127.0.0.1", "--port", "0",
         "--chat-template", "chatml", "--drain-timeout", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
    try:
        port = None
        for line in proc.stdout:
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port is not None, "the server never listened"
        threading.Thread(target=lambda: [None for _ in proc.stdout], daemon=True).start()
        got = {}
        t = threading.Thread(target=lambda: got.update(
            r=_call(port, {**HI, "max_tokens": 40})))
        t.start()
        _wait_until(lambda: json.loads(_call(port, path="/healthz")[2])["replica"]
                    ["free_slots"] == 1, msg="in flight")
        proc.send_signal(signal.SIGTERM)
        _wait_until(lambda: _call(port, path="/healthz")[0] == 503, msg="draining")
        code, _, raw = _call(port, path="/healthz")
        assert json.loads(raw)["status"] == "draining"
        assert _call(port, HI)[0] == 503
        t.join(120)
        code, _, raw = got["r"]
        assert code == 200
        assert json.loads(raw)["choices"][0]["finish_reason"] in ("length", "stop")
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
