"""PyTorch port: grammar-constrained decoding (constrain/, the masked builds of
runtime/device_loop.py, the BatchEngine's constraint side and api_server's
response_format) against the JAX package, on the grammars and engine cases of
tests/test_constrain.py (a 2-layer dim-64 Q40 model, weight seed 11, a byte vocab).

Tolerances: the copied automaton and table arrays, the token mask and the loops'
constraint states exactly; the masked loops' tokens, carries and sampler states exactly;
every engine case token for token against the JAX BatchEngine on the same weights, with
every constrained output grammar-valid. On the CPU the masked steps run eagerly: the
step functions a CUDA graph captures on the card.
"""

import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu import constrain as jcon
from distributed_llama_tpu.apps.api_server import serve as jserve
from distributed_llama_tpu.constrain.table import ConstraintTable as JTable
from distributed_llama_tpu.formats.mfile import params_file_order, write_model
from distributed_llama_tpu.formats.tfile import TokenizerData, write_tokenizer
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.resilience import faults as jfaults
from distributed_llama_tpu.runtime import device_loop as jdl
from distributed_llama_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu.tokenizer import TemplateType as JTemplateType
from distributed_llama_tpu_torch import constrain as con
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.constrain.table import ConstraintTable
from distributed_llama_tpu_torch.resilience import faults
from distributed_llama_tpu_torch.resilience.errors import InvalidRequest
from distributed_llama_tpu_torch.runtime import device_loop as dl
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.sampler import Sampler
from distributed_llama_tpu_torch.tokenizer import TemplateType

EOS = 2
V = 256
K = 8
VOCAB = con.byte_vocab(V)
JVOCAB = jcon.byte_vocab(V)
REP = [7, 31, 5, 102, 9, 31, 5, 77]
SCHEMA = {"type": "object", "properties": {
    "name": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}

GRAMMARS = [
    ("regex", "[ab]{3}"), ("regex", "(a|bc)d"), ("regex", "a?b?c?"),
    ("regex", "(ab|ba){1,2}"), ("regex", "[a-c]{1,3}"), ("regex", "aa|ab|b"),
    ("regex", "abc(x|y)"), ("regex", "[a-z]{24}"), ("regex", r"\d+\.\d{2}"),
    ("json_schema", SCHEMA),
    ("json_schema", {"type": "object", "properties": {
        "id": {"type": "integer"}, "tags": {"type": "array", "items": {"type": "string"},
                                            "maxItems": 2},
        "score": {"type": "number"}, "who": {"type": "string", "maxLength": 4}}}),
    ("grammar", 'root ::= "a" "b" | "c"'),
    ("grammar", 'root ::= greet " " name\ngreet ::= "hi" | "yo"\nname ::= [a-z]+'),
]

BAD = [
    ("regex", "[unclosed"), ("regex", "(ab"), ("regex", "a{3,1}"), ("regex", r"\q"),
    ("json_schema", {"type": "float64"}), ("json_schema", {"$ref": "#/x"}),
    ("json_schema", "not json"), ("grammar", "root ::= root"), ("grammar", ""),
    ("grammar", 'root ::= "a" undefined'), ("xml", "<a/>"),
]


# ------------------------------------------------------------------ the copies


@pytest.mark.parametrize("which", range(len(GRAMMARS)))
def test_automaton_matches_jax(which):
    """compile_grammar: identical mask, delta and forced arrays and grammar hash; the
    same forced chains from every state, and the same validation of sample outputs."""
    kind, src = GRAMMARS[which]
    aut, gh = con.compile_grammar(kind, src, VOCAB, EOS)
    jaut, jgh = jcon.compile_grammar(kind, src, JVOCAB, EOS)
    assert gh == jgh == con.grammar_hash(kind, src)
    for name in ("mask", "delta", "forced"):
        got, want = getattr(aut, name), getattr(jaut, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for st in range(aut.n_states):
        assert aut.forced_chain(st, 8) == jaut.forced_chain(st, 8)
        assert np.array_equal(aut.mask_bool(st), jaut.mask_bool(st))
    rng = np.random.RandomState(which)
    for _ in range(20):
        toks = rng.randint(0, V, size=rng.randint(0, 6)).tolist()
        assert aut.validate(toks) == jaut.validate(toks)


@pytest.mark.parametrize("which", range(len(BAD)))
def test_compile_errors_match_jax(which):
    kind, src = BAD[which]
    with pytest.raises(con.CompileError) as got:
        con.compile_grammar(kind, src, VOCAB, EOS)
    with pytest.raises(jcon.CompileError) as want:
        jcon.compile_grammar(kind, src, JVOCAB, EOS)
    assert str(got.value) == str(want.value)


def test_compile_cache_and_stats():
    """The LRU cache: a repeated grammar compiles once (the same automaton object), and
    compile_stats counts the hit."""
    src = 'root ::= "q" [0-9]'
    aut, gh = con.compile_grammar("grammar", src, VOCAB, EOS)
    h0 = con.compile_stats()["hits"]
    aut2, gh2 = con.compile_grammar("grammar", src, VOCAB, EOS)
    assert aut2 is aut and gh2 == gh and con.compile_stats()["hits"] == h0 + 1
    assert set(con.compile_stats()) == set(jcon.compile_stats())


def test_vocab_bytes_matches_jax(tmp_path):
    from distributed_llama_tpu.tokenizer.bpe import Tokenizer as JTokenizer
    from distributed_llama_tpu_torch.tokenizer.bpe import Tokenizer

    path = str(tmp_path / "t.t")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)] + [
        b" w", b"ab"]
    write_tokenizer(path, TokenizerData(vocab=vocab, scores=[0.0] * len(vocab), bos_id=1,
                                        eos_id=2, max_token_length=6))
    assert con.vocab_bytes(Tokenizer.load(path)) == jcon.vocab_bytes(JTokenizer.load(path))
    assert VOCAB == JVOCAB


def test_constraint_table_matches_jax():
    """ConstraintTable regions under a seeded attach/detach sequence: the same offsets,
    host arrays and regions as the JAX table; the device buffers hold the host arrays
    after device() and never change address."""
    auts = [(con.compile_grammar(k, s, VOCAB, EOS)[0],
             jcon.compile_grammar(k, s, JVOCAB, EOS)[0]) for k, s in GRAMMARS[:10]]
    tbl, jtbl = ConstraintTable(V, 96), JTable(V, 96)
    ptrs = (tbl.mask_dev.data_ptr(), tbl.delta_dev.data_ptr())
    rng = np.random.RandomState(4)
    for _ in range(120):
        row = int(rng.randint(0, 6))
        if row in tbl._regions:
            tbl.free(row), jtbl.free(row)
        else:
            a, ja = auts[rng.randint(len(auts))]
            assert tbl.alloc(row, a) == jtbl.alloc(row, ja)
        assert tbl._regions == jtbl._regions and tbl.active_rows == jtbl.active_rows
        assert np.array_equal(tbl._mask, jtbl._mask)
        assert np.array_equal(tbl._delta, jtbl._delta)
        if rng.rand() < 0.3:
            mask, delta = tbl.device()
            assert np.array_equal(mask.numpy().view(np.uint32), tbl._mask)
            assert np.array_equal(delta.numpy(), tbl._delta)
            assert (mask.data_ptr(), delta.data_ptr()) == ptrs
    uploads = tbl.uploads
    tbl.device()
    tbl.device()
    assert tbl.uploads <= uploads + 1  # at most once per attach or detach


def test_apply_token_mask_matches_jax():
    """The token mask on (B, T, V) f32 rows and random packed words (all-ones rows
    included): the same logits, exactly, as the JAX function's."""
    rng = np.random.RandomState(2)
    for v in (256, 262, 1000):
        w = (v + 31) // 32
        rows = rng.randn(3, 4, v).astype(np.float32)
        words = rng.randint(0, 2**32, size=(3, 4, w), dtype=np.uint64).astype(np.uint32)
        words[1, 2] = 0xFFFFFFFF
        want = np.asarray(jdl._apply_token_mask(jnp.asarray(rows), jnp.asarray(words)))
        got = dl._apply_token_mask(torch.from_numpy(rows),
                                   torch.from_numpy(words.view(np.int32))).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got[1, 2], rows[1, 2])
    assert dl.MASK_NEG == jdl.MASK_NEG


# ------------------------------------------------------------------ the loops


def _write(path, seq_len: int = 256) -> str:
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=V, seq_len=seq_len).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=11)
    write_model(str(path), spec, params_file_order(spec, params), FloatType.Q40)
    return str(path)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("torch_constrain") / "m.m")


@pytest.fixture(scope="module")
def engines(model):
    """The shared engines of tests/test_constrain.py (2 slots, superstep 4, speculative
    8): JAX's and the port's on the same file."""
    kw = dict(slots=2, superstep=4, speculative=K, prefix_cache=False)
    jbe = JBatchEngine.load(model, tp=1, **kw)
    be = BatchEngine.load(model, device="cpu", **kw)
    yield jbe, be
    be.close()
    jbe.close()


def _tables():
    """One table per package with the schema and the branchy regex attached to rows 0
    and 1: (port table, JAX table, the port's (mask, delta), global states)."""
    pa = [con.compile_grammar(*g, VOCAB, EOS)[0] for g in (GRAMMARS[9], GRAMMARS[7])]
    ja = [jcon.compile_grammar(*g, JVOCAB, EOS)[0] for g in (GRAMMARS[9], GRAMMARS[7])]
    tbl, jtbl = ConstraintTable(V, 128), JTable(V, 128)
    offs = [tbl.alloc(i, a) for i, a in enumerate(pa)]
    assert offs == [jtbl.alloc(i, a) for i, a in enumerate(ja)]
    return tbl, jtbl, offs


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_masked_decode_loop_matches_jax(engines, mode):
    """The masked K-step loop against JAX's on the same zeroed paged pools: rows 0 and 1
    under two grammars (one starting mid-automaton), row 2 unconstrained on the
    universal state, two chained calls; tokens, carries, xorshift* states and the final
    constraint states equal. The unconstrained row decodes the unmasked loop's
    tokens."""
    jbe, be = engines
    tbl, jtbl, offs = _tables()
    cmask, cdelta = tbl.device()
    jmask, jdelta = jtbl.device()
    with be._slock:
        jeng, eng = jbe._eng, be.engine
        starts = [9, 5]
        for sl, jsl, n in zip(be._slots, jbe._slots, starts):
            be._paged_ensure(sl, n + 12)
            jbe._paged_ensure(jsl, n + 12)
        tables, jtables = be._tables(), jbe._tables()
        jeng.k_cache = jnp.zeros_like(jeng.k_cache)
        jeng.v_cache = jnp.zeros_like(jeng.v_cache)
        eng.k_cache.zero_(), eng.v_cache.zero_()
        temps = [0.8, 0.0] if mode == "sample" else [0.0, 0.0]
        rng = np.array([[0x12345678, 0x9ABCDEF0], [3, 99]], np.int64)
        cstate = np.array([offs[0] + 1, offs[1]], np.int64)
        jloop = jbe._batched_loop(4, mode, None, True)
        loop = be._batched_loop(4, mode, None, True)
        toks_in, pos_in, rng_in, cs_in = [5, 6], starts, rng, cstate
        jtok, jpos, jrng, jcs = toks_in, pos_in, rng.astype(np.uint32), cstate
        for _ in range(2):
            want = jloop(jeng.params, jeng.rope, jtok, jeng.k_cache, jeng.v_cache, jpos,
                         jrng, temps, [0.9] * 2, [4, 3], jtables,
                         constrain=(jcs, jmask, jdelta))
            jeng.k_cache, jeng.v_cache = want[4], want[5]
            got = loop(eng.rope, toks_in, eng.k_cache, eng.v_cache, pos_in, rng_in, temps,
                       [0.9] * 2, [4, 3], tables, constrain=(cs_in, cmask, cdelta))
            for g, w in zip(got[:4] + (got[6],), want[:4] + (want[6],)):
                assert g.tolist() == np.asarray(w).astype(np.int64).tolist()
            toks_in, pos_in, rng_in, cs_in = got[1], got[2], got[3], got[6]
            jtok, jpos, jrng, jcs = want[1], want[2], want[3], want[6]
        # the loops read this test's tables: the engines build their own afterwards
        be._loops.pop((4, mode, None, "mask"))
        jbe._loops.pop((4, mode, None, "mask"))
        for sl, jsl in zip(be._slots, jbe._slots):
            be._paged_release_slot(sl)
            jbe._paged_release_slot(jsl)


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_masked_verify_loop_matches_jax(engines, mode):
    """The masked verify step against JAX's: two live rows under grammars (one
    proposing the grammar's own forced chain, one a draft the grammar forbids at its
    second position) and a parked row; targets, accepted lengths, carries and frontier
    states equal."""
    jbe, be = engines
    tbl, jtbl, offs = _tables()
    pa = con.compile_grammar(*GRAMMARS[9], VOCAB, EOS)[0]
    chain = pa.forced_chain(0, 4)
    cmask, cdelta = tbl.device()
    jmask, jdelta = jtbl.device()
    with be._slock:
        jeng, eng = jbe._eng, be.engine
        t = 5
        starts = [9, 5]
        for sl, jsl, n in zip(be._slots, jbe._slots, starts):
            be._paged_ensure(sl, n + t)
            jbe._paged_ensure(jsl, n + t)
        tables, jtables = be._tables(), jbe._tables()
        jeng.k_cache = jnp.zeros_like(jeng.k_cache)
        jeng.v_cache = jnp.zeros_like(jeng.v_cache)
        eng.k_cache.zero_(), eng.v_cache.zero_()
        temps = [0.8, 0.0] if mode == "sample" else [0.0, 0.0]
        rng = np.array([[0x12345678, 0x9ABCDEF0], [3, 99]], np.int64)
        props = [[7] + chain, [8, ord("q"), 1, 0, 0]]
        for ndraft in ([4, 2], [4, -1]):
            cstate = np.array([offs[0], offs[1] + 2], np.int64)
            want = jbe._verify_loop(t, mode, None, True)(
                jeng.params, jeng.rope, props, jeng.k_cache, jeng.v_cache, starts,
                rng.astype(np.uint32), temps, [0.9] * 2, ndraft, jtables,
                constrain=(cstate, jmask, jdelta))
            jeng.k_cache, jeng.v_cache = want[5], want[6]
            got = be._verify_loop(t, mode, None, True)(
                eng.rope, props, eng.k_cache, eng.v_cache, starts, rng, temps, [0.9] * 2,
                ndraft, tables, constrain=(cstate, cmask, cdelta))
            for g, w in zip(got[:5] + (got[7],), want[:5] + (want[7],)):
                assert g.tolist() == np.asarray(w).astype(np.int64).tolist()
        assert int(got[1][0]) == 4  # the forced chain is accepted whole
        be._loops.pop(("verify", t, mode, None, "mask"))
        jbe._loops.pop(("verify", t, mode, None, "mask"))
        for sl, jsl in zip(be._slots, jbe._slots):
            be._paged_release_slot(sl)
            jbe._paged_release_slot(jsl)


# ------------------------------------------------------------------ the engine


def _valid(aut, out):
    """Grammar validity of an engine output: the stream up to the first EOS must be
    accepted; EOS then repeats (the done state's self-loop)."""
    if EOS in out:
        i = out.index(EOS)
        assert set(out[i:]) == {EOS}, "post-EOS tokens escaped the mask"
        ok, complete = aut.validate(out[:i + 1])
        assert ok and complete, bytes(out[:i])
    else:
        assert aut.validate(out)[0], bytes(out)


def _both(engines, jobs, spec_off=False):
    """Run jobs [(prompt, n, sampler args, grammar or None)] on both engines, all
    submitted together; returns (port outputs, JAX outputs, port final sampler
    states)."""
    outs = []
    for be, smp_cls, mod in zip(engines[::-1], (Sampler, JSampler), (con, jcon)):
        vocab = VOCAB if mod is con else JVOCAB
        k = be.spec_k
        if spec_off:
            be.spec_k = 0
        try:
            reqs = []
            for p, n, sargs, g in jobs:
                kw = {}
                if g is not None:
                    aut, gh = mod.compile_grammar(*g, vocab, EOS)
                    kw = dict(constraint=aut, constraint_hash=gh)
                reqs.append(be.submit(list(p), n, smp_cls(V, *sargs), **kw))
            outs.append(([r.wait(timeout=300) for r in reqs],
                         [int(r.sampler.state) for r in reqs]))
        finally:
            be.spec_k = k
    return outs[0][0], outs[1][0], outs[0][1]


def test_greedy_constrained_valid_and_minimal_intervention(engines):
    """Constrained greedy output is the JAX engine's, grammar-valid, and agrees with the
    unconstrained stream up to the first position the grammar vetoed."""
    aut = con.compile_grammar(*GRAMMARS[9], VOCAB, EOS)[0]
    got, want, _ = _both(engines, [([1, 5, 9], 28, (0.0,), None),
                                   ([1, 5, 9], 28, (0.0,), GRAMMARS[9])])
    assert got == want
    plain, cons = got
    _valid(aut, cons)
    st = 0
    for c, u in zip(cons, plain):
        if c != u:
            assert not aut.allows(st, u)
            break
        st = aut.advance(st, c)
        if c == EOS:
            break


def test_stochastic_constrained_matches_jax_and_repeats(engines):
    aut = con.compile_grammar(*GRAMMARS[9], VOCAB, EOS)[0]
    jobs = [([1, 5, 9], 28, (0.8, 0.9, 23), GRAMMARS[9])]
    got, want, states = _both(engines, jobs)
    again, _, states2 = _both(engines, jobs)
    assert got == want == again and states == states2
    _valid(aut, got[0])


def test_cobatched_rows_are_isolated(engines):
    """One constrained and one unconstrained row in the same dispatches: both equal the
    JAX engine's and their own solo runs."""
    jobs = [([1, 5, 9], 24, (0.0,), GRAMMARS[9]), (list(REP), 24, (0.0,), None)]
    solo = [_both(engines, [j])[0][0] for j in jobs]
    got, want, _ = _both(engines, jobs)
    assert got == want == solo


def test_speculation_on_off_identity_with_grammar_proposer(engines):
    """Speculation off against on (the grammar proposer drafting forced chains into the
    masked verify): byte-identical, greedy and seeded, equal to the JAX engine's, and the
    grammar proposer drafted."""
    from distributed_llama_tpu_torch.obs import metrics

    def drafted():
        c = metrics.snapshot().get("batch_spec_proposer_drafted_total", {})
        return sum(v for k, v in c.items() if "grammar" in k) if isinstance(c, dict) else 0

    jobs = [([1, 5, 9], 26, (0.0,), GRAMMARS[9]), ([1, 5, 9], 26, (0.8, 0.9, 31),
                                                   GRAMMARS[9])]
    off, _, soff = _both(engines, jobs, spec_off=True)
    d0 = drafted()
    on, want, son = _both(engines, jobs)
    assert on == off == want and son == soff
    assert drafted() > d0, "vacuous: the grammar proposer never drafted"
    aut = con.compile_grammar(*GRAMMARS[9], VOCAB, EOS)[0]
    for out in on:
        _valid(aut, out)


def test_branchy_grammar_rides_masked_scan(engines):
    """A grammar with no forced chains is served by the masked super-step: the JAX
    engine's tokens, valid, no degradation, no table region left behind."""
    jbe, be = engines
    aut = con.compile_grammar(*GRAMMARS[7], VOCAB, EOS)[0]
    deg0, d0 = be.constrain_degraded, be.super_steps
    got, want, _ = _both(engines, [([1, 9], 30, (0.0,), GRAMMARS[7])])
    assert got == want
    _valid(aut, got[0])
    assert be.constrain_degraded == deg0 and be.super_steps > d0
    assert be.constrain_stats()["active_rows"] == 0
    assert any(k[-1] == "mask" for k in be._loops)


def test_grammar_too_large_is_an_honest_reject(model):
    aut, gh = con.compile_grammar(*GRAMMARS[9], VOCAB, EOS)
    be = BatchEngine.load(model, device="cpu", slots=2, superstep=4, prefix_cache=False,
                          constrain_states=4)
    try:
        with pytest.raises(InvalidRequest):
            be.submit([1, 5, 9], 8, Sampler(V, 0.0), constraint=aut, constraint_hash=gh)
        assert len(be.submit([1, 5, 9], 8, Sampler(V, 0.0)).wait(timeout=300)) == 8
    finally:
        be.close()


def test_capacity_and_mask_fault_degrade_as_jax(model):
    """A table with room for one grammar: the second concurrent constrained row
    degrades ("capacity"); an injected constrain.mask fault degrades the first row it
    reaches ("mask"). Both engines degrade the same rows and give the same tokens."""
    n = con.compile_grammar(*GRAMMARS[9], VOCAB, EOS)[0].n_states
    kw = dict(slots=2, superstep=4, prefix_cache=False, constrain_states=n + 1)
    jbe = JBatchEngine.load(model, tp=1, **kw)
    be = BatchEngine.load(model, device="cpu", **kw)
    try:
        jobs = [([1, 5, 9], 20, (0.0,), GRAMMARS[9]), ([1, 4], 20, (0.0,), GRAMMARS[9])]
        got, want, _ = _both((jbe, be), jobs)
        assert got == want and be.constrain_degraded == jbe.constrain_degraded == 1
        with faults.active(faults.FaultSpec("constrain.mask", count=1)), \
                jfaults.active(jfaults.FaultSpec("constrain.mask", count=1)):
            got, want, _ = _both((jbe, be), jobs[:1])
        assert got == want and be.constrain_degraded == jbe.constrain_degraded == 2
        assert be.constrain_stats() == jbe.constrain_stats()
    finally:
        be.close()
        jbe.close()


# ------------------------------------------------------------------ the server


@pytest.fixture(scope="module")
def server_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_constrain_srv")
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=4, vocab_size=262, seq_len=192).resolved()
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


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _stats(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/v1/stats")
    return json.loads(conn.getresponse().read())


def test_response_format_over_the_server(server_files):
    """The port's server: a malformed grammar is a 400 invalid_request_error, a
    json_schema completion is grammar-valid and equals the JAX server's, and the
    /v1/stats constrain block has the JAX server's keys."""
    be = BatchEngine.load(*server_files, slots=2, device="cpu", superstep=4)
    jbe = JBatchEngine.load(*server_files, slots=2, tp=1, superstep=4)
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.CHATML, batch_engine=be)
    jsrv = jserve(None, "127.0.0.1", 0, JTemplateType.CHATML, batch_engine=jbe)
    ports = []
    for s in (srv, jsrv):
        threading.Thread(target=s.serve_forever, daemon=True).start()
        ports.append(s.server_address[1])
    try:
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 40,
                "temperature": 0,
                "response_format": {"type": "json_schema",
                                    "json_schema": {"schema": SCHEMA}}}
        texts = []
        for port in ports:
            code, out = _post(port, body)
            assert code == 200, out
            texts.append(out["choices"][0]["message"]["content"])
        assert texts[0] == texts[1]
        assert texts[0].startswith('{"name":"')
        code, out = _post(ports[0], dict(body, response_format={"type": "regex",
                                                                "regex": "[unclosed"}))
        assert code == 400 and out["error"]["type"] == "invalid_request_error"
        code, out = _post(ports[0], dict(body, response_format={"type": "yaml"}))
        assert code == 400
        st, jst = _stats(ports[0]), _stats(ports[1])
        assert set(st["constrain"]) == set(jst["constrain"])
        assert set(st["constrain"]["compile"]) == set(jst["constrain"]["compile"])
        assert st["constrain"]["active_rows"] == 0 and st["constrain"]["degraded"] == 0
    finally:
        for s in (srv, jsrv):
            s.shutdown()
            s.server_close()
        be.close()
        jbe.close()


def test_response_format_needs_the_batched_engine(server_files):
    """At --batch 1 a response_format is a 400, as in the JAX server."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    eng = Engine.load(*server_files, device="cpu")
    srv = api_server.serve(eng, "127.0.0.1", 0, TemplateType.CHATML)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, out = _post(srv.server_address[1], {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "response_format": {"type": "regex", "regex": "[a-z]+"}})
        assert code == 400 and "batch" in out["error"]["message"]
    finally:
        srv.shutdown()
        srv.server_close()
