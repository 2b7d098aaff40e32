"""PyTorch port: the model drafter (draft/, ProposerMux in runtime/speculative.py and the
BatchEngine's drafter side) against the JAX package, on the cases of
tests/test_model_drafter.py (a 2-layer dim-64 Q40 target, weight seed 11, drafting for
itself, and a 1-layer dim-32 drafter, seed 5), each engine loading the same `.m` files.

Tolerances: drafter-backed tokens token for token against the JAX BatchEngine with the
same drafter and against the speculation-off run (greedy, and seeded sampling with equal
final sampler states); the drafter's scan exactly the drafter model's own sequential
greedy stream and the JAX drafter's drafts; verify turns of a serialized engine equal
to the JAX engine's. On the CPU the scans run eagerly: the step a CUDA graph captures
on the card.
"""

import pytest

from distributed_llama_tpu.draft.drafter import ModelDrafter as JModelDrafter
from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.runtime import speculative as jspec
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.engine import Engine as JEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu_torch.draft.drafter import ModelDrafter
from distributed_llama_tpu_torch.formats.mfile import load_model
from distributed_llama_tpu_torch.resilience import faults
from distributed_llama_tpu_torch.runtime import speculative as spec_mod
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler

V = 256
K = 8
REP = [5, 9, 17, 3, 44, 9, 17, 3]
OPEN = [1, 17, 93, 4, 55, 201, 8, 41, 113, 29]


def _write(path, seed: int, seq_len=256, dim=64, n_layers=2, heads=4):
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=dim, hidden_dim=2 * dim,
                     n_layers=n_layers, n_heads=heads, n_kv_heads=heads,
                     vocab_size=V, seq_len=seq_len).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=seed)
    write_model(str(path), spec, params_file_order(spec, params), FloatType.Q40)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_drafter")
    return {"target": _write(d / "t.m", 11),
            # the target's weights under a 48-token context: a drafter shorter than it
            "short": _write(d / "s.m", 11, seq_len=48),
            "tiny": _write(d / "d.m", 5, dim=32, n_layers=1, heads=2)}


def _pair(files, draft="target", **kw):
    kw.setdefault("prefix_cache", False)
    return (JBatchEngine.load(files["target"], tp=1, draft_model=files[draft], **kw),
            BatchEngine.load(files["target"], device="cpu", draft_model=files[draft], **kw))


@pytest.fixture(scope="module")
def self_draft(files):
    """Both engines drafting for themselves (2 slots, superstep K, speculative K)."""
    jbe, be = _pair(files, slots=2, superstep=K, speculative=K)
    assert jbe.drafter is not None and be.drafter is not None
    yield jbe, be
    be.close()
    jbe.close()


def _run(be, jobs, timeout=300):
    smp_cls = JSampler if isinstance(be, JBatchEngine) else Sampler
    reqs = [be.submit(list(p), n, smp_cls(V, *s), **kw) for p, n, s, kw in jobs]
    return [r.wait(timeout=timeout) for r in reqs], reqs


def _ab(be, jobs):
    """The same jobs speculation off, then on (the drafter live), on one engine."""
    k = be.spec_k
    try:
        be.spec_k = 0
        off = _run(be, jobs)
    finally:
        be.spec_k = k
    return off, _run(be, jobs)


# ------------------------------------------------------------------ identity


def test_greedy_identity_with_model_drafter(self_draft):
    jbe, be = self_draft
    jobs = [(OPEN, 24, (0.0,), {}), ([1] + REP * 4, 24, (0.0,), {})]
    (off, _), (on, reqs) = _ab(be, jobs)
    want, _ = _run(jbe, jobs)
    assert on == off == want
    assert sum(r.stats.spec_steps for r in reqs) >= 2
    assert sum(r.stats.spec_accepted for r in reqs) >= 8, "vacuous identity"


def test_seeded_stochastic_identity_with_model_drafter(self_draft):
    """Stochastic rows sample with the request's own coins; the drafts are the
    drafter's greedy argmax. Identity and the final sampler states hold whatever was
    proposed."""
    jbe, be = self_draft
    jobs = [(OPEN, 24, (0.8, 0.9, 42), {}), ([1] + REP * 4, 24, (0.02, 0.9, 7), {})]
    (off, off_reqs), (on, reqs) = _ab(be, jobs)
    want, jreqs = _run(jbe, jobs)
    assert on == off == want
    assert ([int(r.sampler.state) for r in reqs] == [int(r.sampler.state) for r in off_reqs]
            == [int(r.sampler.state) for r in jreqs])


def test_self_draft_accepts_every_greedy_draft(files):
    """When the drafter IS the target every draft is the target's greedy choice, so a
    greedy row accepts every draft of every turn — any miss is a frontier or catch-up
    defect; the turns equal the JAX engine's."""
    from distributed_llama_tpu_torch.obs import metrics

    jbe, be = _pair(files, slots=1, superstep=K, speculative=K, pipeline=False)
    try:
        hits0 = metrics.snapshot().get("batch_draft_frontier_hits_total", 0)
        (out, reqs), (want, jreqs) = (_run(e, [(OPEN, 32, (0.0,), {})]) for e in (be, jbe))
        req = reqs[0]
        assert out == want and req.stats.spec_turns == jreqs[0].stats.spec_turns
        assert req.stats.spec_steps >= 3 and req.stats.spec_accepted >= 18
        for _n, drafted, accepted in req.stats.spec_turns:
            assert accepted == drafted
        assert metrics.snapshot()["batch_draft_frontier_hits_total"] > hits0
    finally:
        be.close()
        jbe.close()


def test_drafter_scan_matches_sequential_greedy(files):
    """The catch-up + draft scan emits the draft model's own sequential greedy stream
    (and the JAX drafter's drafts); accepted pushes advance the frontier for free and a
    fresh proposal continues the same stream."""
    dspec, dparams = load_model(files["tiny"])
    drafter = ModelDrafter(dspec, dparams, slots=2, target_spec=dspec, k_cap=K)
    jeng = JEngine.load(files["tiny"], tp=1)
    jdrafter = JModelDrafter(jeng.spec, jeng.params, mesh=jeng.mesh, slots=2,
                             target_spec=jeng.spec, k_cap=K)
    prompt = list(OPEN)
    for d in (drafter, jdrafter):
        d.attach(0, prompt)
    drafts = drafter.propose_batch({0: 6})[0]
    assert drafts == jdrafter.propose_batch({0: 6})[0]
    seq, _ = Engine(dspec, dparams, device="cpu").generate(list(prompt), 6, Sampler(V, 0.0))
    assert drafts == seq
    for t in seq:
        drafter.push(0, t)
        jdrafter.push(0, t)
    assert drafter._rows[0].frontier == len(prompt) + 5 == jdrafter._rows[0].frontier
    drafts2 = drafter.propose_batch({0: 4})[0]
    assert drafts2 == jdrafter.propose_batch({0: 4})[0]
    seq2, _ = Engine(dspec, dparams, device="cpu").generate(prompt + seq, 4,
                                                            Sampler(V, 0.0))
    assert drafts2 == seq2
    # a long prompt rides the chunked prefill first
    long = [1] + REP * 8
    drafter.attach(1, long)
    jdrafter.attach(1, long)
    assert drafter.propose_batch({1: 4}) == jdrafter.propose_batch({1: 4})
    assert drafter.prefill_tokens == jdrafter.prefill_tokens > 0


def test_mixed_model_and_ngram_rows_one_batch(files):
    """A row whose context passes the drafter's (shorter) seq_len falls back to n-gram
    drafting while its neighbour keeps model drafts, in the same verify dispatches:
    tokens equal the JAX engine's and the speculation-off run's."""
    jbe, be = _pair(files, draft="short", slots=2, superstep=K, speculative=K)
    try:
        seen: set[str] = set()
        orig = be.proposer.propose_batch

        def spy(want):
            out = orig(want)
            seen.update(be.proposer.last_src[r] for r in out)
            return out

        be.proposer.propose_batch = spy
        jobs = [(OPEN, 24, (0.0,), {}), ([1, 2] + REP * 6, 24, (0.0,), {})]
        (off, _), (on, _) = _ab(be, jobs)
        assert on == off == _run(jbe, jobs)[0]
        assert "model" in seen and "ngram" in seen, seen
    finally:
        be.close()
        jbe.close()


def test_drafter_vocab_mismatch_degrades_to_ngram(tmp_path, files):
    """A drafter of another vocabulary does not load: the engine serves with n-gram
    drafting, as the JAX engine does."""
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=32, hidden_dim=64, n_layers=1,
                     n_heads=2, n_kv_heads=2, vocab_size=128, seq_len=256).resolved()
    path = str(tmp_path / "v128.m")
    write_model(path, spec, params_file_order(spec, init_random_params(
        spec, FloatType.Q40, seed=5)), FloatType.Q40)
    kw = dict(slots=2, superstep=4, speculative=4, prefix_cache=False, draft_model=path)
    jbe = JBatchEngine.load(files["target"], tp=1, **kw)
    be = BatchEngine.load(files["target"], device="cpu", **kw)
    try:
        assert be.drafter is None and jbe.drafter is None
        jobs = [([1] + REP * 3, 16, (0.0,), {})]
        assert _run(be, jobs)[0] == _run(jbe, jobs)[0]
        assert be.spec_stats()["proposer"]["model"] is False
    finally:
        be.close()
        jbe.close()


# ------------------------------------------------------------------ resume, preemption


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_durable_resume_with_live_drafter(self_draft, temperature):
    """A mid-stream failover re-admission (prompt ⊕ delivered, the sampler fast-
    forwarded) continues byte-identical with the drafter live: the proposer re-attaches
    whole and the drafter re-prefills its own KV."""
    jbe, be = self_draft
    prompt, gen, cut = list(OPEN), 36, 11
    ref = _run(be, [(prompt, gen, (temperature, 0.9, 77), {})])[0][0]
    assert ref == _run(jbe, [(prompt, gen, (temperature, 0.9, 77), {})])[0][0]
    smp = Sampler(V, temperature, 0.9, 77)
    smp.fast_forward(cut if temperature else 0)
    resumed = be.submit(prompt + ref[:cut], gen - cut, smp, resume_tokens=cut)
    assert resumed.wait(timeout=300) == ref[cut:]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preemption_resumes_byte_identical_with_drafter(files, temperature):
    """The tenancy preemption (the slot handed to an interactive arrival, the batch
    request re-admitted later) composes with a live drafter. The interactive request is
    submitted from the victim's 9th token callback, on the scheduler thread."""
    be = BatchEngine.load(files["target"], device="cpu", slots=1, superstep=4,
                          speculative=4, prefix_cache=False, draft_model=files["target"])
    try:
        prompt, gen = [1, 9, 9, 2], 48
        ref = be.submit(list(prompt), gen, Sampler(V, temperature, 0.9, 1234),
                        klass="batch").wait(timeout=300)
        inter = []

        def on_token(_t, n=[0]):
            n[0] += 1
            if n[0] == 9:
                inter.append(be.submit([1, 2, 3], 4, Sampler(V, 0.0), klass="interactive"))
        victim = be.submit(list(prompt), gen, Sampler(V, temperature, 0.9, 1234),
                           on_token=on_token, klass="batch")
        out = victim.wait(timeout=300)
        assert inter and inter[0].wait(timeout=300) is not None
        assert victim.preemptions >= 1, "the preemption never engaged"
        assert out == ref
    finally:
        be.close()


# ------------------------------------------------------------------ the mux and stats


def test_spec_stats_reports_proposer_and_per_row_k(self_draft):
    jbe, be = self_draft
    jobs = [(OPEN, 16, (0.0,), {})]
    _run(be, jobs)
    _run(jbe, jobs)
    s, js = be.spec_stats(), jbe.spec_stats()
    assert set(s) == set(js) and set(s["proposer"]) == set(js["proposer"])
    assert set(s["proposer"]["drafter"]) == set(js["proposer"]["drafter"])
    assert s["proposer"]["drafter"]["model"] == js["proposer"]["drafter"]["model"]
    assert s["k"] == K and s["proposer"]["model"] is True
    assert s["proposer"]["disabled"] is False and s["proposer"]["errors"] == 0
    assert s["adaptive"]["k_cap"] == K and s["adaptive"]["buckets"] == [1, 2, 4, 8]


class _Stub:
    """A drafter stub: proposes [row] * k, or raises `err`."""

    name = "model"

    def __init__(self, err=None):
        self.err = err

    def attach(self, row, tokens):
        pass

    def detach(self, row):
        pass

    def push(self, row, tok):
        pass

    def observe(self, row, accepted):
        pass

    def can_serve(self, row, k):
        return True

    def stats(self):
        return {}

    def propose_batch(self, want):
        if self.err is not None:
            raise self.err
        return {r: [r] * k for r, k in want.items()}


@pytest.mark.parametrize("err", [None, spec_mod.DrafterError("bad drafter state")])
def test_proposer_mux_matches_jax(err):
    """ProposerMux routing against JAX's on the same stubs: the same drafts, sources,
    readiness and failure counting, disabled after max_failures consecutive errors."""
    mux = spec_mod.ProposerMux(spec_mod.NgramProposer(), _Stub(err), max_failures=3)
    jmux = jspec.ProposerMux(jspec.NgramProposer(), _Stub(err), max_failures=3)
    for m in (mux, jmux):
        m.attach(0, [1] + REP * 3)
        m.attach(1, [1, 2, 3])
    for _ in range(5):
        assert mux.propose_batch({0: 4, 1: 3}) == jmux.propose_batch({0: 4, 1: 3})
        assert mux.last_src == jmux.last_src
        assert mux.ready(1, 3, 1) == jmux.ready(1, 3, 1)
    assert mux.describe() == jmux.describe()
    assert mux.disabled == (err is not None)


def test_device_faults_propagate_through_the_mux():
    """A CUDA error out of the drafter is not the drafter's to hide: it propagates."""
    mux = spec_mod.ProposerMux(
        spec_mod.NgramProposer(),
        _Stub(RuntimeError("CUDA error: an illegal memory access was encountered")))
    mux.attach(0, [1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA error"):
        mux.propose_batch({0: 2})
    assert mux.errors == 0
    assert not spec_mod.drafter_failure(RuntimeError("q4_matmul: CUDA launch failed"))
    assert not spec_mod.drafter_failure(ValueError("q4_matmul needs 2-D i4p weights"))
    assert spec_mod.drafter_failure(spec_mod.DrafterError("draft model vocab 128 != 256"))


def test_kernel_wrapper_refusal_in_the_drafter_propagates(files):
    """A kernel wrapper refusing its inputs inside the drafter's scan (here q4_matvec,
    handed a classifier weight that is not 2-D) is not the drafter's own failure: its
    ValueError propagates through the mux, which counts no error and stays enabled."""
    from distributed_llama_tpu_torch.quants import QTensor

    spec, params = load_model(files["target"])
    dr = ModelDrafter(spec, params, slots=1, target_spec=spec, device="cpu",
                      use_kernels="fused", k_cap=4)
    w = dr.params["wcls"]
    assert w.layout == "i4p" and w.groups == 1  # a one-row product routes to q4_matvec
    dr.params["wcls"] = QTensor(w.ftype, w.data[None], w.scales, w.layout, w.groups,
                                w.row_groups)
    mux = spec_mod.ProposerMux(spec_mod.NgramProposer(), dr)
    mux.attach(0, [1] + REP)
    with pytest.raises(ValueError, match="q4_matvec needs 2-D i4p weights"):
        mux.propose_batch({0: 4})
    assert mux.errors == 0 and not mux.disabled


@pytest.mark.parametrize("point", ["draft.propose", "draft.dispatch"])
def test_injected_drafter_faults_degrade_then_disable(files, point):
    """Every drafter turn failing at an injected fault: each dispatch's rows fall back
    to n-gram drafts, the tokens stay the speculation-off run's, and after max_failures
    consecutive failures the drafter is disabled for the engine's lifetime."""
    be = BatchEngine.load(files["target"], device="cpu", slots=2, superstep=K,
                          speculative=K, prefix_cache=False, draft_model=files["tiny"])
    try:
        jobs = [([1] + REP * 4, 40, (0.0,), {}), (OPEN, 40, (0.8, 0.9, 5), {})]
        k = be.spec_k
        be.spec_k = 0
        off = _run(be, jobs)[0]
        be.spec_k = k
        with faults.active(faults.FaultSpec(point, scope="engine")):
            on = _run(be, jobs)[0]
        d = be.spec_stats()["proposer"]
        assert on == off
        assert d["disabled"] is True and d["errors"] >= be.proposer.max_failures
    finally:
        be.close()


def test_injected_load_fault_degrades_to_ngram(files):
    with faults.active(faults.FaultSpec("draft.load")):
        be = BatchEngine.load(files["target"], device="cpu", slots=2, superstep=4,
                              speculative=4, draft_model=files["tiny"])
    try:
        assert be.drafter is None
        assert len(be.generate([1] + REP * 3, 8, Sampler(V, 0.0))[0]) == 8
    finally:
        be.close()


def test_steps_built_lie_in_the_bucket_sets(self_draft):
    """Every verify step and drafter scan the engines built over these runs is one of
    the bucket lengths (verify T in the verify buckets of spec_k, scan lengths in the
    buckets of catchup_cap + k_cap - 1): adaptive k and the catch-up never mint
    another."""
    jbe, be = self_draft
    _run(be, [(OPEN, 24, (0.8, 0.9, 3), {}), ([1] + REP * 4, 24, (0.0,), {})])
    verify = {spec_mod.verify_block_bucket(1 + d, 1 + be.spec_k)
              for d in range(1, be.spec_k + 1)}
    dr = be.drafter
    cap = dr.catchup_cap + dr.k_cap - 1
    scans = {spec_mod.verify_block_bucket(max(n, 2), cap) for n in range(1, cap + 1)}
    built_v = {k[1] for k in be._loops if k[0] == "verify"}
    built_s = {steps for steps, _w in dr._loops}
    assert built_v and built_v <= verify, (built_v, verify)
    assert built_s and built_s <= scans, (built_s, scans)
    assert set(spec_mod.draft_buckets(be.spec_k)) == {1, 2, 4, 8}


def test_entry_point_flags(files, tmp_path, capsys):
    """api_server --draft-model (implying --speculative 8) loads the drafter at --batch 2
    and warns at --batch 1, where --prefill-kernel reaches the Engine; dllama
    --draft-model warns and keeps prompt lookup."""
    from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
    from distributed_llama_tpu_torch.apps import api_server, dllama

    tpath = str(tmp_path / "t.t")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(3, V)]
    write_tokenizer(tpath, TokenizerData(vocab=vocab, scores=[0.0] * V, bos_id=1,
                                         eos_id=2, max_token_length=1))
    common = ["--model", files["target"], "--tokenizer", tpath, "--device", "cpu",
              "--host", "127.0.0.1", "--port", "0", "--chat-template", "llama2",
              "--draft-model", files["tiny"]]
    srv = api_server.build_server(api_server.build_parser().parse_args(
        common + ["--batch", "2", "--draft-k", "4"]))
    try:
        be = srv.api_state.batch_engine
        assert be.spec_k == 4 and be.drafter is not None and be.drafter.k_cap == 4
    finally:
        srv.server_close()
        srv.api_state.batch_engine.close()
    args = api_server.build_parser().parse_args(common + ["--prefill-kernel"])
    assert api_server.engine_kwargs(args)["prefill_kernel"] is True
    srv = api_server.build_server(args)
    srv.server_close()
    assert srv.api_state.batch_engine is None
    assert "needs the batched verify path" in capsys.readouterr().err
    dllama.main(["generate", "--model", files["target"], "--tokenizer", tpath, "--device",
                 "cpu", "--steps", "2", "--prompt", "ab", "--temperature", "0",
                 "--draft-model", files["tiny"], "--draft-k", "2"])
    assert "keeps prompt-lookup drafting" in capsys.readouterr().err
