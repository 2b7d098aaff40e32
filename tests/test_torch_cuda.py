"""PyTorch port on the card: each CUDA kernel against its plain torch version on the same
CUDA tensors, and a tiny engine with kernels against the CPU plain path. Marked `cuda`;
skips where no GPU is present (the kernels have no CPU mode). Run on a GPU machine with
`python -m pytest -q -m cuda tests/test_torch_cuda.py`.

Tolerances, relative to max|reference|: q4_matvec, q4_matvec_q80, q8_matvec (int8 and
precise) and q8_matvec_q80 1e-4 (exact integer block dots, or f32 block sums of the same
products; the f32 sum over blocks in another order), with bf16 output one bf16 ulp more
and equal to the kernel's f32 result rounded once, one launch per call in a CUDA graph
that replays after the row is overwritten in place; the prologue's quantize_q80 exact,
its rmsnorm_q80 at most 4 xq values one step off (the sum of squares in another order
can move a value within an ulp of a rounding tie) with sx within rtol 1e-6; q4_matmul and its residual mode 1e-3 (identical bf16
operands, tensor-core f32 accumulation order), q4_gated_matmul 1e-3 (the same products,
the activation on the same f32 sums), decode_attention and paged_attention 1e-4 (q and
p enter the bf16 tensor cores as hi/lo pairs against exact bf16 K/V, ~2^-16 relative;
f32 softmax; split merge order). The Q40 dequant-matmuls also decode bit for bit (one-hot
X rows), repeat bit for bit, write bf16 within one ulp of the plain result rounded, and
run as one launch per call. The serving tests hold the fused BatchEngine on the card
against the CPU plain versions: identical greedy tokens per request, logits step by step
within 2e-3·max|logits| (`chip_smoke.serving_parity`). The prefix-cache tests hold the
bf16 host tier bit-exact through a demotion and a promotion, the pools' storage fixed
through copy-on-write and promotion, captured super-steps against eager ones after a
remap and a copy, and the single-slot seed against a fresh prefill, bit for bit. The
recovery test holds recover_wedged to its contract on the card: the pool's storage kept,
no launch from the abandoned thread, every graph captured again, the same tokens. The
tenancy and disaggregation tests hold a preempted request and an imported prompt to the
tokens of their uninterrupted, monolithic runs at the same batch shape, exactly. The
constrained-decoding tests hold a masked step's graph replay to the eager step bit for
bit (a grammar attached after the capture included, its table's buffers at the same
addresses) and a constrained engine's tokens with graphs to those without; the drafter
test holds the scan's graph replay to the eager scan's drafts, exactly."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.params import init_random_params
from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec
from distributed_llama_tpu_torch.ops import attention_plan
from distributed_llama_tpu_torch.ops import decode_attention as da
from distributed_llama_tpu_torch.ops import mv_plan, prologue_plan
from distributed_llama_tpu_torch.ops import paged_attention as pa
from distributed_llama_tpu_torch.ops import prologue as pro
from distributed_llama_tpu_torch.ops import q4_gated_matmul as gm
from distributed_llama_tpu_torch.ops import q4_matmul as mm
from distributed_llama_tpu_torch.ops import q4_matvec as mv
from distributed_llama_tpu_torch.ops import q8_matvec as q8
from distributed_llama_tpu_torch.quants import FloatType
from distributed_llama_tpu_torch.runtime.batch_engine import BatchEngine
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.sampler import Sampler


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(n, k, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=g, device=dev)
    scales = (torch.rand((n, k // 32), generator=g, device=dev) * 0.01).to(torch.float16)
    return packed, scales


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _matvec_close(got, want, got32=None):
    """A matvec output against its plain version's f32 result: f32 within 1e-4·max|want|;
    bf16 within that plus one bf16 ulp of the plain result rounded (chip_smoke._bf16_err),
    and equal to the kernel's own f32 result rounded once (got32)."""
    import chip_smoke

    if got.dtype == torch.float32:
        assert _rel_err(got, want) < 1e-4
        return
    chip_smoke._bf16_err(got, want, 1e-4)
    assert torch.equal(got, got32.to(torch.bfloat16))


# ragged N: 300, 777 and 12289 are no multiple of any plan's rows per block or grid
@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(300, 704), (4096, 11008), (32000, 4096), (12289, 4096),
                                 (777, 32768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_q4_matvec_kernel_matches_plain(cuda, n, k, dtype, out_dtype):
    packed, scales = _planes(n, k, cuda, seed=n)
    x = torch.randn(k, device=cuda).to(dtype)
    before = mv.launches
    got = mv._launch(x, packed, scales, out_dtype)
    got32 = mv._launch(x, packed, scales)
    torch.cuda.synchronize()
    assert mv.launches == before + 2 and got.dtype == out_dtype
    _matvec_close(got, mv.q4_matvec_plain(x, packed, scales), got32)


def _i8_planes(n, k, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g, device=dev)
    scales = torch.rand((n, k // 32), generator=g, device=dev) * 1e-3
    return w8, scales


def _q80_row(k, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(k, generator=g, device=dev)
    x[32:64] = 0.0  # an all-zero block
    return mv.quantize_row(x)


# the precise mode takes K <= 12288
_Q8_CASES = [(n, k, precise) for n, k in ((300, 96), (4096, 11008), (32000, 4096),
                                          (12288, 4096), (12289, 4096), (777, 12288))
             for precise in (False, True)] + [(777, 32768, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,precise", _Q8_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_q8_matvec_kernel_matches_plain(cuda, n, k, dtype, precise, out_dtype):
    w8, scales = _i8_planes(n, k, cuda, seed=n + k)
    x = torch.randn(k, device=cuda).to(dtype)
    x[32:64] = 0.0
    before = (q8.launches, q8.precise_launches)
    got = q8._launch(x, w8, scales, precise, out_dtype)
    got32 = q8._launch(x, w8, scales, precise)
    torch.cuda.synchronize()
    assert (q8.launches, q8.precise_launches) == (before[0] + 2 * (not precise),
                                                  before[1] + 2 * precise)
    assert got.dtype == out_dtype
    plain = q8.q8_matvec_precise_plain if precise else q8.q8_matvec_plain
    _matvec_close(got, plain(x, w8, scales), got32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(300, 128), (12288, 4096), (4096, 11008), (32000, 4096),
                                 (12289, 4096), (777, 32768)])
@pytest.mark.parametrize("layout", ["i8", "i4p"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_q80_matvec_kernels_match_plain(cuda, n, k, layout, out_dtype):
    xq, sx = _q80_row(k, cuda, seed=k)
    if layout == "i8":
        w = _i8_planes(n, k, cuda, seed=n)
        before = q8.q80_launches
        got = q8._launch_q80(xq, sx, *w, out_dtype)
        got32 = q8._launch_q80(xq, sx, *w)
        want = q8.q8_matvec_q80_plain(xq, sx, *w)
        counted = q8.q80_launches - before
    else:
        w = _planes(n, k, cuda, seed=n)
        before = mv.q80_launches
        got = mv._launch_q80(xq, sx, *w, out_dtype)
        got32 = mv._launch_q80(xq, sx, *w)
        want = mv.q4_matvec_q80_plain(xq, sx, *w)
        counted = mv.q80_launches - before
    torch.cuda.synchronize()
    assert counted == 2 and got.dtype == out_dtype
    _matvec_close(got, want, got32)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["q4_matvec", "q4_matvec_q80", "q8_matvec",
                                   "q8_matvec_precise", "q8_matvec_q80"])
def test_matvec_entries_are_one_launch_and_replay(cuda, entry):
    """A CUDA graph captured around one bf16 call holds exactly one node, the kernel (no
    cast), and replays correctly after the row is overwritten in place; repeated calls
    are bit-identical (each row's sum in a fixed order)."""
    import chip_smoke

    n, k = 4096, 11008
    g = torch.Generator(device=cuda).manual_seed(21)
    bf = torch.bfloat16
    x = torch.randn(k, generator=g, device=cuda).to(bf)
    xq, sx = mv.quantize_row(torch.randn(k, generator=g, device=cuda))
    if entry.startswith("q4"):
        w, name = _planes(n, k, cuda, seed=3), "q4_matvec_kernel"
    else:
        w, name = _i8_planes(n, k, cuda, seed=3), "q8_matvec_kernel"
    call, plain = {
        "q4_matvec": (lambda: mv._launch(x, *w, bf), lambda: mv.q4_matvec_plain(x, *w)),
        "q4_matvec_q80": (lambda: mv._launch_q80(xq, sx, *w, bf),
                          lambda: mv.q4_matvec_q80_plain(xq, sx, *w)),
        "q8_matvec": (lambda: q8._launch(x, *w, False, bf), lambda: q8.q8_matvec_plain(x, *w)),
        "q8_matvec_precise": (lambda: q8._launch(x, *w, True, bf),
                              lambda: q8.q8_matvec_precise_plain(x, *w)),
        "q8_matvec_q80": (lambda: q8._launch_q80(xq, sx, *w, bf),
                          lambda: q8.q8_matvec_q80_plain(xq, sx, *w)),
    }[entry]
    assert chip_smoke.graph_launches(lambda i: call(), name) == (1, 1)
    assert torch.equal(call(), call())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for seed in (5, 6):
        g2 = torch.Generator(device=cuda).manual_seed(seed)
        x.copy_(torch.randn(k, generator=g2, device=cuda))
        q, s = mv.quantize_row(torch.randn(k, generator=g2, device=cuda))
        xq.copy_(q)
        sx.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        chip_smoke._bf16_err(out, plain(), 1e-4)


def _cluster_threshold(x_bf16: bool) -> int:
    """The shortest row rmsnorm_q80 splits over a cluster of CTAs."""
    return next(k for k in range(32, prologue_plan.MAX_K + 1, 32)
                if prologue_plan.plan(k, x_bf16, True).ctas > 1)


# the path's rows, the largest, and each dtype's cluster threshold and the rows beside it
PROLOGUE_K = sorted({32, 64, 4096, 11008, 14336, 65536} | {
    t + d for t in (_cluster_threshold(False), _cluster_threshold(True)) for d in (-32, 0, 32)})


@pytest.mark.cuda
@pytest.mark.parametrize("k", PROLOGUE_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prologue_kernels_match_plain(cuda, k, dtype):
    """quantize_q80 bit for bit; rmsnorm_q80 at most 4 xq values one step off over 4 rows
    and sx within rtol 1e-6; both repeat bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(k)
    w = 1.0 + 0.1 * torch.randn(k, generator=g, device=cuda)
    flips = 0
    for row in range(4):
        x = (3.0 * torch.randn(k, generator=g, device=cuda)).to(dtype)
        if k >= 64:
            x[32:64] = 0.0
        before = (pro.rmsnorm_launches, pro.quantize_launches)
        xq, sx = pro._launch(x, None, 0.0)
        rq, rs = pro._launch(x, w, 1e-5)
        torch.cuda.synchronize()
        assert (pro.rmsnorm_launches, pro.quantize_launches) == (before[0] + 1, before[1] + 1)
        wq, ws = pro.quantize_q80_plain(x)
        assert torch.equal(xq, wq) and torch.equal(sx, ws)
        if k >= 64:
            assert sx[1] == 0.0 and (xq[32:64] == 0).all()
        pq, ps = pro.rmsnorm_q80_plain(x, w, 1e-5)
        diff = (rq.int() - pq.int()).abs()
        assert diff.max() <= 1
        flips += int((diff > 0).sum())
        torch.testing.assert_close(rs, ps, rtol=1e-6, atol=0)
        again = pro._launch(x, w, 1e-5)
        assert torch.equal(again[0], rq) and torch.equal(again[1], rs)
    assert flips <= 4


def _chain_weights(layout, n, k, dev, seed):
    return _i8_planes(n, k, dev, seed) if layout == "i8" else _planes(n, k, dev, seed)


def _chain_launch(layout):
    return q8._launch_q80 if layout == "i8" else mv._launch_q80


# seconds of the spin kernel the racing pairs queue behind: the host must queue the m
# prologues ahead and the pair within it. 20 ms was too short for a loaded host (a pair
# queued after the spin had ended, 2 of 439 card tests), so the spin is 100 ms and the
# host's queueing time is measured inside it
PDL_SPIN_S = 0.1


def _pdl_pairs(launch, bases, nw, w, ahead):
    """Each row of `bases` through the prologue and the pre-quantized matvec behind it,
    the row's copy freed between the two launches so that the matvec's output (as many
    bytes) takes its block. ahead None: the card synchronized between the launches.
    ahead m >= 0: the pair queued behind a spin kernel of PDL_SPIN_S, so the card runs
    it back to back, and behind m prologues of a 64k row. Those trigger their dependents
    at entry and wait for their predecessor, so with m > 0 the pair's prologue is
    launched while they run and waits for them, and the matvec, launched once the
    prologue has started, has its blocks resident before the prologue reads x or writes
    xq. The host's time from the spin's launch to the pair's last launch must lie
    inside the spin, and the spin must still run then. Returns (xq, sx, y, whether y
    took the freed block) per row."""
    import time

    import chip_smoke

    junk = torch.randn(1 << 16, device=bases[0].device)
    out = []
    for base in bases:
        torch.cuda.synchronize()
        if ahead is not None:
            torch.cuda._sleep(int(PDL_SPIN_S * chip_smoke.SPIN_HZ))
            t_spin = time.perf_counter()
        x = base.clone()
        ptr = x.data_ptr()
        held = [pro._launch(junk, None, 0.0) for _ in range(ahead or 0)]
        xq, sx = pro._launch(x, nw, 1e-5)
        del x  # back to the allocator while the prologue may still read it
        if ahead is None:
            torch.cuda.synchronize()
        y = launch(xq, sx, *w, torch.bfloat16)
        if ahead is not None:
            end = torch.cuda.Event()
            end.record()
            queued_ms = (time.perf_counter() - t_spin) * 1e3
            assert queued_ms < 1e3 * PDL_SPIN_S and not end.query(), (
                f"the spin ended before the pair was queued: the host took "
                f"{queued_ms:.1f} ms to queue {ahead} prologues and the pair behind a "
                f"{1e3 * PDL_SPIN_S:.0f} ms spin")
        torch.cuda.synchronize()
        del held
        out.append((xq, sx, y, y.data_ptr() == ptr))
    return out


def _pdl_case(layout, norm, dev):
    n = k = 4096  # y (N bf16) has the bytes of x (K bf16)
    g = torch.Generator(device=dev).manual_seed(31)
    w = _chain_weights(layout, n, k, dev, seed=5)
    nw = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev) if norm else None
    bases = [(3.0 * torch.randn(k, generator=g, device=dev)).to(torch.bfloat16)
             for _ in range(4)]
    return _chain_launch(layout), bases, nw, w


def _pdl_differs(layout, norm, dev, ahead, rounds):
    """Pairs over `rounds` runs of _pdl_pairs(ahead) whose xq, sx or y differ from the
    synchronized run's (kept alive, so no queued xq takes a block holding its row's
    bits); every y must take the freed block."""
    launch, bases, nw, w = _pdl_case(layout, norm, dev)
    torch.cuda.empty_cache()
    want = _pdl_pairs(launch, bases, nw, w, None)
    differ = 0
    for _ in range(rounds):
        for got, ref in zip(_pdl_pairs(launch, bases, nw, w, ahead), want):
            assert got[3], "the matvec's output did not take the freed input's block"
            differ += not all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3]))
    return differ, want, bases


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["i4p", "i8"])
@pytest.mark.parametrize("norm", [True, False])
def test_prologue_pdl_chain_matches_synchronized(cuda, layout, norm):
    """The prologue and the pre-quantized matvec behind it, each launched with
    programmatic stream serialization, give the xq, sx and y of the same calls with
    torch.cuda.synchronize() between them: queued back to back, and queued behind
    prologues that hold the pair's prologue at its wait while the matvec's blocks are
    resident. The prologue's input is freed before the matvec allocates its output of
    the same size, so the matvec's output lies in the block the prologue may still be
    reading: a write before the matvec's wait would corrupt xq, and a read of the row
    before it would take a stale one (test_pdl_check_catches_a_broken_wait)."""
    for ahead in (0, 16):
        differ, want, bases = _pdl_differs(layout, norm, cuda, ahead, rounds=2)
        assert differ == 0, f"{differ} pairs differ, {ahead} prologues ahead"
    if not norm:
        for (xq, sx, _, _), base in zip(want, bases):
            plain = pro.quantize_q80_plain(base)
            assert torch.equal(xq, plain[0]) and torch.equal(sx, plain[1])


# Deliberately broken pre-quantized matvecs: one edit of csrc/matvec_stream.cuh each
_WAIT = "    wait_for_predecessor();\n  }\n"
_ROW = ("  load_round<MODE == kPrequantized>(src, pieces, 0, v0);\n"
        "  const float sx0 = MODE == kPrequantized && tid < nb ? __ldcg(p.sx + tid) : 0.f;\n")
_FIRST_SLOTS = "    for (; issued < pre; ++issued) issue(issued);\n"
_BROKEN = {
    # the row's loads ahead of griddepcontrol.wait
    "read_before_wait": (_WAIT + _ROW, "  }\n" + _ROW
                         + "  if constexpr (MODE == kPrequantized) wait_for_predecessor();\n"),
    # the output zeroed ahead of griddepcontrol.wait
    "write_before_wait": (_FIRST_SLOTS, "    for (int i = blockIdx.x * kThreads + tid; "
                          "i < p.n * (p.out_bf16 ? 2 : 4); i += gridDim.x * kThreads)\n"
                          "      static_cast<unsigned char*>(p.y)[i] = 0;\n" + _FIRST_SLOTS),
}


@pytest.fixture(scope="module")
def broken_matvecs(tmp_path_factory):
    """{(edit, layout): the matvec library built from csrc/ with that edit of
    _BROKEN}, one nvcc per library, all started together."""
    import ctypes
    import shutil
    import subprocess

    from distributed_llama_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    jobs = {}
    for edit, (old, new) in _BROKEN.items():
        src = tmp_path_factory.mktemp(edit)
        shutil.copytree(cuda_build.CSRC_DIR, src, dirs_exist_ok=True)
        header = src / "matvec_stream.cuh"
        text = header.read_text()
        assert text.count(old) == 1, f"{edit}: the edit's anchor moved"
        header.write_text(text.replace(old, new))
        for layout, name in (("i4p", "q4_matvec"), ("i8", "q8_matvec")):
            lib = src / f"{name}.so"
            jobs[(edit, layout)] = (lib, name, subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                 str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (path, name, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in (q8 if name == "q8_matvec" else mv)._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = (name, lib)
    return libs


@pytest.mark.cuda
@pytest.mark.parametrize("edit", sorted(_BROKEN))
@pytest.mark.parametrize("layout", ["i4p", "i8"])
def test_pdl_check_catches_a_broken_wait(cuda, broken_matvecs, monkeypatch, layout, edit):
    """The check of test_prologue_pdl_chain_matches_synchronized fails on a matvec that
    reads its row, or writes its output, before griddepcontrol.wait: with prologues
    ahead of the pair, at least one pair differs from the synchronized calls. (Printed
    beside it: the pairs that differ queued with none ahead.)"""
    from distributed_llama_tpu_torch.ops import cuda_build

    name, lib = broken_matvecs[(edit, layout)]
    monkeypatch.setitem(cuda_build._loaded, name, lib)
    differ = {ahead: _pdl_differs(layout, True, cuda, ahead, rounds=3)[0]
              for ahead in (0, 16)}
    print(f"{edit} {layout}: of 12 pairs, {differ[0]} differ queued with no prologue "
          f"ahead, {differ[16]} with 16 ahead")
    assert differ[16] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["i4p", "i8"])
def test_prologue_chain_replays_from_cuda_graph(cuda, layout):
    """A layer's four prologue -> pre-quantized matvec pairs (rmsnorm before the QKV and
    gate/up projections, quantize before wo and w2), each launched with programmatic
    stream serialization, captured in a CUDA graph: the replay bit-identical to the
    eager chain, also after the rows are overwritten in place."""
    g = torch.Generator(device=cuda).manual_seed(41)
    pairs = [(True, 768, 256), (False, 256, 256), (True, 1024, 256), (False, 256, 512)]
    ws = [_chain_weights(layout, n, k, cuda, seed=n + k) for _, n, k in pairs]
    rows = [(3.0 * torch.randn(k, generator=g, device=cuda)).to(torch.bfloat16)
            for _, _, k in pairs]
    nws = [1.0 + 0.1 * torch.randn(k, generator=g, device=cuda) if norm else None
           for norm, _, k in pairs]
    launch = _chain_launch(layout)

    def chain():
        return [launch(*pro._launch(x, nw, 1e-5), *w, torch.bfloat16)
                for x, nw, w in zip(rows, nws, ws)]

    chain()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain()
    for seed in (7, 8):
        g2 = torch.Generator(device=cuda).manual_seed(seed)
        for x in rows:
            x.copy_(3.0 * torch.randn(x.shape[0], generator=g2, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, chain()))


@pytest.mark.cuda
def test_refused_prologue_and_pdl_launches_raise(cuda, monkeypatch):
    """A launch shape the prologue is not built for, and a pre-quantized matvec asked to
    issue no slot before its wait, are refused by the kernels' hosts: the wrappers raise
    and nothing runs in their place."""
    x = torch.randn(4096, device=cuda)
    monkeypatch.setattr(prologue_plan, "plan",
                        lambda k, xb, norm: prologue_plan.Plan(1024, 8, 1, False))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        pro._launch(x, None, 0.0)
    monkeypatch.undo()
    xq, sx = pro._launch(x, None, 0.0)
    monkeypatch.setattr(mv_plan, "PRE_SLOTS", 0)
    mv_plan.ring.cache_clear()
    mv_plan.plan.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            mv._launch_q80(xq, sx, *_planes(256, 4096, cuda, seed=1))
    finally:
        monkeypatch.undo()
        mv_plan.ring.cache_clear()
        mv_plan.plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", [FloatType.Q40, FloatType.Q80])
def test_engine_prologue_matches_cpu_plain(cuda, ftype):
    """A tiny model with the prologue: the card's kernels against the CPU plain versions,
    identical greedy tokens, and the prologue and pre-quantized matvec kernels launched."""
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=300, seq_len=512).resolved()
    params = init_random_params(spec, ftype, seed=6)
    kw = dict(dtype=torch.float32, use_kernels=True, fused_prologue=True)
    gpu = Engine(spec, params, device="cuda", **kw)
    cpu = Engine(spec, params, device="cpu", **kw)
    counters = (lambda: (pro.rmsnorm_launches, pro.quantize_launches,
                         (mv if ftype == FloatType.Q40 else q8).q80_launches))
    before = counters()
    prompt = [1] + list(range(3, 12))
    sampler = lambda: Sampler(spec.vocab_size, temperature=0.0)  # noqa: E731
    got, _ = gpu.generate(prompt, 12, sampler())
    want, _ = cpu.generate(prompt, 12, sampler())
    assert got == want
    assert all(a > b for a, b in zip(counters(), before))


# every tile of csrc/q4_matmul.cu and csrc/q4_gated_matmul.cu and both sides of each
# tile's row limit, with ragged N edges and K = 704 (11 chunks: a trailing stage past
# K/2, zero-filled)
M_ROWS = (2, 3, 8, 9, 16, 17, 64, 70, 128, 256, 512)
_EDGES = [(m, n, k) for m in M_ROWS for n, k in ((130, 256), (96, 704))]


def _with_edges(cases):
    return cases + [e for e in _EDGES if e not in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", _with_edges([(2, 130, 256), (8, 4096, 11008),
                                                (64, 12288, 4096), (512, 32000, 4096),
                                                (70, 96, 704)]))
def test_q4_matmul_kernel_matches_plain(cuda, m, n, k):
    packed, scales = _planes(n, k, cuda, seed=m)
    x = torch.randn(m, k, device=cuda)
    before = (mm.launches, mm.res_launches)
    got = mm._launch(x, packed, scales)
    torch.cuda.synchronize()
    assert (mm.launches, mm.res_launches) == (before[0] + 1, before[1])
    assert _rel_err(got, mm.q4_matmul_plain(x, packed, scales)) < 1e-3


def _one_hot_rows(m, k):
    """x (m, k) bf16 with row r one-hot at column k_r, the k_r spread over both planes."""
    cols = torch.linspace(0, k - 1, m).round().long()
    x = torch.zeros(m, k)
    x[torch.arange(m), cols] = 1.0
    return x.to(torch.bfloat16), cols


@pytest.mark.cuda
@pytest.mark.parametrize("m", M_ROWS)
@pytest.mark.parametrize("n,k", [(130, 704), (300, 4096)])
def test_q4_matmul_decodes_bit_for_bit(cuda, m, n, k):
    """With x rows one-hot in k, y[r, n] = w[n, k_r] exactly: every decoded weight the
    kernel multiplies, low plane and high, equals dequant_bf16 to the bit."""
    packed, scales = _planes(n, k, cuda, seed=m + n)
    x, cols = _one_hot_rows(m, k)
    assert (cols < k // 2).any() and (cols >= k // 2).any()
    got = mm._launch(x.to(cuda), packed, scales)
    want = mm.dequant_bf16(packed, scales)[:, cols.to(cuda)].T.float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(3, 96, 704), (8, 4096, 11008), (64, 4096, 11008),
                                   (512, 4096, 4096)])
def test_q4_mm_family_is_deterministic(cuda, m, n, k):
    """Two calls of each mode give bit-identical output (the splits sum in a fixed
    order), and the counters advance by one per call."""
    w1, w3 = _planes(n, k, cuda, seed=m + 7), _planes(n, k, cuda, seed=m + 8)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    res = torch.randn(m, n, device=cuda)
    calls = {"mm": lambda: mm._launch(x, *w1),
             "res": lambda: mm._launch(x, *w1, res),
             "gated": lambda: gm._launch(x, w1, w3, "silu")}
    counters = lambda: (mm.launches, mm.res_launches, gm.launches)  # noqa: E731
    for i, call in enumerate(calls.values()):
        before = counters()
        a, b = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert [c - p for c, p in zip(counters(), before)] == [2 * (j == i) for j in range(3)]


def _ulps_off(got, want32, got32):
    """How far got (bf16) lies from want32.to(bf16), in bf16 ulps of the larger of the
    two, beyond what the f32 sums before the rounding differ by (the kernel's got32
    against want32): rounding two f32 values that far apart moves them at most 1 ulp
    further apart."""
    want = want32.to(torch.bfloat16).float()
    big = torch.maximum(want.abs(), got.float().abs()).clamp_min(2.0 ** -126)
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return (((got.float() - want).abs() - (got32 - want32).abs()) / ulp).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(8, 4096, 4096), (64, 4096, 11008), (512, 1024, 4096),
                                   (3, 96, 704)])
@pytest.mark.parametrize("mode", ["mm", "res_f32", "res_bf16", "silu", "gelu_tanh"])
def test_q4_mm_family_writes_bf16(cuda, m, n, k, mode):
    """The bf16 output is the kernel's own f32 result rounded once, and within one bf16
    ulp of the plain version's f32 result rounded, with the residual and the activation
    on and off."""
    w1, w3 = _planes(n, k, cuda, seed=m + 9), _planes(n, k, cuda, seed=m + 10)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    if mode == "mm":
        run = lambda dt: mm._launch(x, *w1, out_dtype=dt)  # noqa: E731
        want = mm.q4_matmul_plain(x, *w1)
    elif mode.startswith("res"):
        res = torch.randn(m, n, device=cuda).to(
            torch.float32 if mode == "res_f32" else torch.bfloat16)
        run = lambda dt: mm._launch(x, *w1, res, out_dtype=dt)  # noqa: E731
        want = mm.q4_matmul_res_plain(x, *w1, res)
    else:
        run = lambda dt: gm._launch(x, w1, w3, mode, out_dtype=dt)  # noqa: E731
        want = gm.q4_gated_matmul_plain(x, w1, w3, mode)
    got, got32 = run(torch.bfloat16), run(torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, got32.to(torch.bfloat16))
    assert _ulps_off(got, want, got32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 64, 512])
@pytest.mark.parametrize("mode", ["mm", "res", "gated"])
def test_q4_mm_family_is_one_launch(cuda, m, mode):
    """A CUDA graph captured around one bf16 call holds exactly one launch of the kernel
    and nothing else (no split-sum pass, no cast)."""
    import chip_smoke

    n, k = 4096, 11008
    w1, w3 = _planes(n, k, cuda, seed=m + 11), _planes(n, k, cuda, seed=m + 12)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    res = torch.randn(m, n, device=cuda).to(torch.bfloat16)
    bf = torch.bfloat16
    fn, name = {"mm": (lambda i: mm._launch(x, *w1, out_dtype=bf), "q4_matmul_tc_kernel"),
                "res": (lambda i: mm._launch(x, *w1, res, out_dtype=bf),
                        "q4_matmul_tc_kernel"),
                "gated": (lambda i: gm._launch(x, w1, w3, "silu", out_dtype=bf),
                          "q4_gated_tc_kernel")}[mode]
    named, nodes = chip_smoke.graph_launches(fn, name)
    assert (named, nodes) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk,g,hs", [(4, 1, 64), (2, 4, 128), (3, 8, 32), (2, 2, 96)])
@pytest.mark.parametrize("pos,window", [(0, 256), (1, 256), (130, 256), (256, 256),
                                        (700, 1024)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, hk, g, hs, pos, window):
    s = 1024
    kc = torch.randn(2, 1, hk, s, hs, device=cuda).to(dtype)
    vc = torch.randn(2, 1, hk, s, hs, device=cuda).to(dtype)
    kc[:, :, :, pos:] = float("nan")  # never read: slots >= pos
    vc[:, :, :, pos:] = float("nan")
    q = torch.randn(hk, g, hs, device=cuda)
    kn = torch.randn(hk, 1, hs, device=cuda).to(dtype)
    vn = torch.randn(hk, 1, hs, device=cuda).to(dtype)
    got = da._launch(q, kc, vc, kn, vn, 1, pos, window)
    torch.cuda.synchronize()
    want = da.decode_attention_plain(q, kc, vc, kn, vn, 1, pos, window)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < 1e-4


def _decode_inputs(dev, dtype, hk, g, hs, s=1024, n_layers=2, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    kc = torch.randn(n_layers, 1, hk, s, hs, generator=gen, device=dev).to(dtype)
    vc = torch.randn(n_layers, 1, hk, s, hs, generator=gen, device=dev).to(dtype)
    q = torch.randn(hk, g, hs, generator=gen, device=dev)
    kn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(dtype)
    vn = torch.randn(hk, 1, hs, generator=gen, device=dev).to(dtype)
    return q, kc, vc, kn, vn


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 131, 256])
def test_decode_attention_device_position_matches_int(cuda, pos):
    """Position and layer as device tensors (int64 and int32, as the forward pass hands
    them) give the int call's result bit for bit: one launch either way."""
    q, kc, vc, kn, vn = _decode_inputs(cuda, torch.bfloat16, 32, 1, 128, seed=pos)
    before = da.launches
    got = da._launch(q, kc, vc, kn, vn, torch.ones(1, dtype=torch.int32, device=cuda),
                     torch.full((1,), pos, dtype=torch.int64, device=cuda), 256)
    want = da._launch(q, kc, vc, kn, vn, 1, pos, 256)
    torch.cuda.synchronize()
    assert da.launches == before + 2
    assert torch.equal(got, want)
    ref = da.decode_attention_plain(q, kc, vc, kn, vn, 1, pos, 256)
    assert _rel_err(got, ref) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_replays_from_cuda_graph(cuda, dtype):
    """One launch captured in a CUDA graph replays at two positions of its window after
    the device position is updated in place, matching the plain version at each."""
    q, kc, vc, kn, vn = _decode_inputs(cuda, dtype, 32, 4, 128, seed=7)
    kc[:, :, :, 700:] = float("nan")  # past both positions: never read
    vc[:, :, :, 700:] = float("nan")
    pos = torch.full((1,), 5, dtype=torch.int64, device=cuda)
    layer = torch.ones(1, dtype=torch.int32, device=cuda)
    da._launch(q, kc, vc, kn, vn, layer, pos, 1024)  # warm-up: build, attributes, counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da._launch(q, kc, vc, kn, vn, layer, pos, 1024)
    for p in (131, 699):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, kc, vc, kn, vn, 1, p, 1024)
        assert torch.isfinite(out).all()
        assert _rel_err(out, want) < 1e-4, f"pos {p}"


@pytest.mark.cuda
def test_engine_kernels_match_cpu_plain(cuda):
    import chip_smoke

    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=300, seq_len=512).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=5)
    kw = dict(dtype=torch.float32, use_kernels=True, prefill_kernel=True)
    # eager steps: the recorder below copies each row to the host, which a graph capture
    # cannot hold (test_graph_replay_matches_eager holds the replay to the eager step)
    gpu = Engine(spec, params, device="cuda", cuda_graph=False, **kw)
    cpu = Engine(spec, params, device="cpu", **kw)
    # the activation rows every kernel-path matmul receives, to count the values whose
    # Q80 code (matvec rows) or bf16 rounding (matmul rows) differs between the runs
    rec = chip_smoke._Crossings()
    prompt = [1] + list(range(3, 80))
    before = (mv.launches, mm.launches, da.launches)
    try:
        lg, cg = gpu.prefill(prompt), rec.take()
        lc, cc = cpu.prefill(prompt), rec.take()
        crossed = 0
        for step in range(13):
            crossed += rec.count(cg, cc)
            # 2e-3·max|logits| while no activation has crossed a rounding boundary (only
            # the sum order differs); once one has, the caches carry it and each crossing
            # moves the logits by ~1e-3·max at this width: 2e-2·max (card reading before
            # this check: 3.9e-3 at max 1.25, i.e. 3.1e-3·max, ~90 positions in)
            tol = (2e-2 if crossed else 2e-3) * np.abs(lc).max()
            err = np.abs(lg - lc).max()
            assert err < tol, f"step {step}: max|Δlogits| {err:.3e}, {crossed} crossings"
            tg, tc = int(np.argmax(lg)), int(np.argmax(lc))
            assert tg == tc, f"greedy tokens diverge at step {step}"
            lg, cg = gpu.infer_chunk([tg]), rec.take()
            lc, cc = cpu.infer_chunk([tc]), rec.take()
    finally:
        rec.close()
    assert all(a > b for a, b in zip((mv.launches, mm.launches, da.launches), before))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", _with_edges([(8, 4096, 4096), (64, 4096, 11008),
                                                (512, 4096, 11008), (3, 96, 704)]))
@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
def test_q4_matmul_res_kernel_matches_plain(cuda, m, n, k, res_dtype):
    """The 4096-column shapes split K (one wave of 64-row tiles covers the card several
    times over): the residual enters the last split block's ordered sum once."""
    packed, scales = _planes(n, k, cuda, seed=m + 1)
    x = torch.randn(m, k, device=cuda)
    res = torch.randn(m, n, device=cuda).to(res_dtype)
    before = (mm.launches, mm.res_launches)
    got = mm._launch(x, packed, scales, res)
    torch.cuda.synchronize()
    assert (mm.launches, mm.res_launches) == (before[0], before[1] + 1)
    assert _rel_err(got, mm.q4_matmul_res_plain(x, packed, scales, res)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", _with_edges([(8, 11008, 4096), (64, 11008, 4096),
                                                (512, 11008, 4096), (2, 96, 704)]))
@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_q4_gated_matmul_kernel_matches_plain(cuda, m, n, k, act):
    """M = 8 and 64 split K: the activation must run on the summed partials."""
    w1, w3 = _planes(n, k, cuda, seed=m + 2), _planes(n, k, cuda, seed=m + 3)
    x = torch.randn(m, k, device=cuda)
    before = gm.launches
    got = gm._launch(x, w1, w3, act)
    torch.cuda.synchronize()
    assert gm.launches == before + 1
    assert _rel_err(got, gm.q4_gated_matmul_plain(x, w1, w3, act)) < 1e-3


def _paged_inputs(dev, dtype, t, g, hk, hs, lengths, bt=16, n_layers=2, seed=0):
    """Pools with NaN in the scratch block, in every block no table holds, and in the
    rows of live blocks at or past each row's length."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    w = -(-(max(lengths) + t) // bt)
    n_blocks = b * w + 3
    kc = torch.randn(n_layers, n_blocks, hk, bt, hs, generator=gen, device=dev).to(dtype)
    vc = torch.randn(n_layers, n_blocks, hk, bt, hs, generator=gen, device=dev).to(dtype)
    tables = torch.zeros(b, w, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(seed)) + 1
    used, live = 0, []
    for r, ln in enumerate(lengths):
        nb = -(-ln // bt)
        tables[r, :nb] = perm[used:used + nb].to(torch.int32)
        live += perm[used:used + nb].tolist()
        used += nb
    dead = torch.ones(n_blocks, dtype=torch.bool)
    dead[live] = False
    kc[:, dead.to(dev)] = float("nan")
    vc[:, dead.to(dev)] = float("nan")
    for r, ln in enumerate(lengths):
        if ln % bt:
            kc[:, int(tables[r, ln // bt]), :, ln % bt:] = float("nan")
            vc[:, int(tables[r, ln // bt]), :, ln % bt:] = float("nan")
    q = torch.randn(b, t, hk * g, hs, generator=gen, device=dev)
    kn = torch.randn(b, hk, t, hs, generator=gen, device=dev).to(dtype)
    vn = torch.randn(b, hk, t, hs, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kc, vc, kn, vn, tables.to(dev), lens, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,g,hk,hs", [(1, 1, 32, 128), (5, 4, 2, 64), (8, 1, 32, 128),
                                       (64, 1, 8, 128), (3, 8, 1, 32)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, t, g, hk, hs):
    q, kc, vc, kn, vn, tables, lens, w = _paged_inputs(cuda, dtype, t, g, hk, hs,
                                                       [0, 37, 300, 16], seed=t + g)
    layer = torch.ones(1, dtype=torch.int32, device=cuda)
    before = pa.launches
    got = pa._launch(q, kc, vc, kn, vn, tables, lens, layer, w)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_attention_plain(q, kc, vc, kn, vn, tables, lens, 1, n_read=w)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["rows512", "mid_tile", "one_split"])
def test_paged_attention_kernel_edge_shapes(cuda, dtype, case):
    """R = T·g = 512 query rows (eight 64-row blocks per split), lengths that end inside
    a 64-slot tile with NaN after them, and a window that one split covers (the block
    writes the output itself, no merge)."""
    t, g, hk, hs, lengths = {
        "rows512": (64, 8, 2, 128, [0, 37, 300, 16]),
        "mid_tile": (5, 4, 2, 64, [100, 45, 63, 129]),
        "one_split": (3, 2, 4, 128, [20, 9, 0]),
    }[case]
    q, kc, vc, kn, vn, tables, lens, w = _paged_inputs(cuda, dtype, t, g, hk, hs, lengths,
                                                       seed=len(case))
    layer = torch.ones(1, dtype=torch.int32, device=cuda)
    before = pa.launches
    got = pa._launch(q, kc, vc, kn, vn, tables, lens, layer, w)
    resident = attention_plan.resident_blocks(
        pa.cuda_build.load("paged_attention", pa._SIGNATURES),
        "paged_attention_blocks_per_sm", dtype == torch.bfloat16, hs, t * g, 0)
    plan = attention_plan.split_plan(w * 16, t * g, len(lengths) * hk, resident)
    if case == "one_split":
        assert plan[1] == 1
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_attention_plain(q, kc, vc, kn, vn, tables, lens, 1, n_read=w)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < 1e-4
    # the counters are left zero for the next call
    assert int(attention_plan.merge_counters(cuda, 1).abs().sum()) == 0


@pytest.mark.cuda
def test_batch_engine_fused_kernels_match_cpu_plain(cuda):
    """A tiny fused BatchEngine: the card's kernels against the CPU plain versions on
    staggered requests — identical greedy tokens outside near-ties (the tie rule of
    `chip_smoke.serving_parity`: request 3's step 8 here puts its top two CPU logits
    5.0e-4 apart, under the 2.7e-3 tolerance, and exact sums agree), and every serving
    kernel launched."""
    import chip_smoke

    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=300, seq_len=512).resolved()
    before = (mm.launches, mm.res_launches, gm.launches, pa.launches)
    report = chip_smoke.serving_parity(spec=spec, max_tokens=12)
    print(report)
    assert "tokens identical" in report
    after = (mm.launches, mm.res_launches, gm.launches, pa.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.cuda
def test_batch_engine_7b_width_matches_cpu_plain(cuda):
    """The 2-layer model at Llama-2-7B width in f32 (the chip_smoke parity phase)."""
    import chip_smoke

    assert "tokens identical" in chip_smoke.serving_parity()


# ------------------------------------------------------------------ CUDA graphs, loops


DECODE_PATHS = [("q40", False), ("q40", True), ("q80", False), ("q80", True)]


def _path_engines(dev, fmt: str, prologue: bool, seed: int = 31):
    """A 2-layer model at Llama-2-7B width (bf16, random weights drawn on the card in
    the kernels' layout) behind two Engines on the same weights: CUDA graphs on (the
    default) and off."""
    import chip_smoke

    spec = chip_smoke._llama2_7b(n_layers=2)
    draw = chip_smoke._random_i4p_params if fmt == "q40" else chip_smoke._random_i8_params
    params = draw(spec, dev, seed=seed)
    kw = dict(device="cuda", prefill_kernel=fmt == "q40", fused_prologue=prologue)
    return spec, Engine(spec, params, **kw), Engine(spec, params, cuda_graph=False, **kw)


def _prompt(n: int, seed: int) -> list[int]:
    return [1] + np.random.RandomState(seed).randint(3, 32000, n - 1).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,prologue", DECODE_PATHS)
def test_graph_replay_matches_eager(cuda, fmt, prologue):
    """The one-token step replayed from its CUDA graph gives the eager step's logits bit
    for bit at every step (one graph per window bucket: the prompt and 12 tokens cross
    from window 256 into 512)."""
    import chip_smoke

    spec, graph_eng, eager = _path_engines(cuda, fmt, prologue)
    assert graph_eng.cuda_graph and not eager.cuda_graph
    prompt = _prompt(250, 3)
    runs = []
    for eng in (graph_eng, eager):
        smp = chip_smoke._CheckedSampler(spec.vocab_size, keep=True)
        runs.append((eng.generate(prompt, 12, smp)[0], smp.kept))
    (tg, lg), (te, le) = runs
    assert tg == te and len(lg) == len(le) == 12
    assert all(np.array_equal(a, b) for a, b in zip(lg, le))
    assert graph_eng.graphs.captures == 2 and graph_eng.graphs.replays >= 12
    assert eager.graphs.replays == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,prologue", DECODE_PATHS)
def test_device_loop_matches_host_loop(cuda, fmt, prologue):
    """generate_chunked (the K-step device loop, each step a graph replay) gives the
    host loop's greedy tokens after the same prefill (the prompt but its last token in
    chunks, the last token as the first one-token step); a seeded stochastic loop
    repeats itself."""
    import chip_smoke

    spec, eng, _ = _path_engines(cuda, fmt, prologue)
    prompt = _prompt(40, 4)
    host = chip_smoke.host_loop_tokens(eng, prompt, 24)
    eng.reset()
    loop = eng.generate_chunked(prompt, 24, Sampler(spec.vocab_size, 0.0), chunk=8)[0]
    assert loop == host
    sampled = []
    for _ in range(2):
        eng.reset()
        sampled.append(eng.generate_chunked(prompt, 16, Sampler(spec.vocab_size, 0.8, 0.9,
                                                                seed=5), chunk=8)[0])
    assert sampled[0] == sampled[1] and all(0 <= t < spec.vocab_size for t in sampled[0])


@pytest.mark.cuda
def test_superstep_pipelined_batch_engine_matches_superstep_1(cuda):
    """The fused BatchEngine at 2 layers of Llama-2-7B width: super-steps of 4,
    pipelined (each step a graph replay), give the single-step engine's greedy tokens.
    Request i+1 arrives at request i's first token, so both engines run the same mixed
    steps and their decode steps the same kernels."""
    import chip_smoke

    spec = chip_smoke._llama2_7b(n_layers=2)
    params = chip_smoke._random_i4p_params(spec, cuda, seed=41, gate_pair=True)
    prompts = [_prompt(n, 10 + n) for n in (70, 9, 33, 17)]
    outs = []
    for k in (1, 4):
        be = BatchEngine(spec, params, slots=4, device="cuda", fused_matmul=True,
                         superstep=k)
        try:
            reqs, _ = chip_smoke.staggered(be, prompts, 14, after=1)
            outs.append([r.out for r in reqs])
            if k == 4:
                assert be.super_steps > 0 and be.chained > 0
                assert be.engine.graphs.replays == be.loop_steps
        finally:
            be.close()
    assert outs[0] == outs[1]


def _split_calls(dev):
    """One call of each kernel that splits its work and merges through the shared tile
    counters, at the decode shapes where it splits: decode_attention, paged_attention
    and the split-K Q40 dequant-matmuls (the plan of the plain mode splits)."""
    q, kc, vc, kn, vn = _decode_inputs(dev, torch.bfloat16, 8, 4, 128, s=2048, seed=3)
    pos = torch.full((1,), 1500, dtype=torch.int64, device=dev)
    layer = torch.ones(1, dtype=torch.int32, device=dev)
    x = torch.randn(8, 11008, device=dev).to(torch.bfloat16)
    packed, scales = _planes(4096, 11008, dev, 5)
    pq, pkc, pvc, pkn, pvn, tables, lens, w = _paged_inputs(dev, torch.bfloat16, 1, 1, 32,
                                                            128, [1900, 700, 1200, 5])
    lib = attention_plan.cuda_build.load("q4_matmul", mm._SIGNATURES)
    p = mm.mm_plan.plan(8, 4096, 11008, 1, mm.mm_plan.resident_blocks(
        lib, "q4_matmul_blocks_per_sm", mm.mm_plan.pick_tile(8), dev.index))
    assert p.splits > 1
    res = torch.randn(8, 4096, device=dev).to(torch.bfloat16)
    xg = x[:, :4096].contiguous()
    pair = (_planes(11008, 4096, dev, 6), _planes(11008, 4096, dev, 7))
    return {"decode_attention": lambda: da._launch(q, kc, vc, kn, vn, layer, pos, 2048),
            "paged_attention": lambda: pa._launch(pq, pkc, pvc, pkn, pvn, tables, lens,
                                                  layer, w),
            "q4_matmul": lambda: mm._launch(x, packed, scales, out_dtype=torch.bfloat16),
            "q4_matmul_res": lambda: mm._launch(x, packed, scales, res,
                                                out_dtype=torch.bfloat16),
            "q4_gated_matmul": lambda: gm._launch(xg, *pair, "silu",
                                                  out_dtype=torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "paged_attention", "q4_matmul",
                                    "q4_matmul_res", "q4_gated_matmul"])
def test_split_kernel_counters_reset_across_replays(cuda, kernel):
    """A split kernel captured once and replayed 100 times writes the same bits every
    time and leaves the shared tile counters zero: a counter left set would make a later
    replay merge too early."""
    fn = _split_calls(cuda)[kernel]
    want = fn()  # warm-up: build, attributes, buffers
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(100):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    counters = attention_plan.merge_counters(cuda, 1)
    assert int(counters.abs().sum()) == 0


# the MoE path: the decode matvecs' expert entries, and attention at Grok-1's g = 6
def _expert_stack(fmt, n_e, n, k, dev, seed):
    if fmt == "q4":
        packed, scales = _planes(n_e * n, k, dev, seed)
        return (packed.reshape(n_e, n, k // 2), scales.reshape(n_e, n, k // 32),
                mv._launch, mv.q4_matvec_expert_plain, mv)
    w8, scales = _i8_planes(n_e * n, k, dev, seed)
    return (w8.reshape(n_e, n, k), scales.reshape(n_e, n, k // 32), q8._launch,
            q8.q8_matvec_expert_plain, q8)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["q4", "q8"])
@pytest.mark.parametrize("n,k", [(300, 704), (28672, 4096), (4096, 14336), (777, 32768)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_moe_expert_entries_match_plain(cuda, fmt, n, k, out_dtype):
    """The expert entry against its plain version on each expert of a 4-expert stack
    (the `_matvec_close` tolerances), bit-identical to the 2-D entry on that expert's
    planes, one launch per call on its own counter; an index past either end clamps."""
    w, s, launch, plain, mod = _expert_stack(fmt, 4, n, k, cuda, seed=n + k)
    x = torch.randn(k, device=cuda).to(torch.bfloat16)
    for e, at in ((0, 0), (2, 2), (3, 3), (-1, 0), (7, 3)):
        idx = torch.tensor([e], dtype=torch.int64, device=cuda)
        before = (mod.expert_launches, mod.launches)
        got = launch(x, w, s, out_dtype=out_dtype, e=idx)
        got32 = launch(x, w, s, e=idx)
        assert (mod.expert_launches, mod.launches) == (before[0] + 2, before[1])
        two_d = launch(x, w[at], s[at], out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, two_d), f"expert {e}"
        _matvec_close(got, plain(x, w, s, idx), got32)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_moe_expert_index_replays_from_cuda_graph(cuda, fmt):
    """One expert-entry launch captured in a CUDA graph replays against the expert whose
    index is written into its index tensor before each replay: the captured launch reads
    the index, it was not frozen into the graph."""
    w, s, launch, _, _ = _expert_stack(fmt, 8, 4096, 14336, cuda, seed=5)
    x = torch.randn(14336, device=cuda).to(torch.bfloat16)
    idx = torch.zeros(1, dtype=torch.int64, device=cuda)
    launch(x, w, s, out_dtype=torch.bfloat16, e=idx)  # warm-up: build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(x, w, s, out_dtype=torch.bfloat16, e=idx)
    outs = []
    for e in (5, 2, 5):
        idx.fill_(e)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, launch(x, w[e], s[e], out_dtype=torch.bfloat16)), e
        outs.append(out.clone())
    assert not torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos,window", [(0, 256), (130, 256), (700, 1024)])
def test_moe_decode_attention_grok_group(cuda, dtype, pos, window):
    """decode_attention at Grok-1's heads: 8 kv heads of 6 query heads, hs 128."""
    q, kc, vc, kn, vn = _decode_inputs(cuda, dtype, 8, 6, 128, seed=pos)
    kc[:, :, :, pos:] = float("nan")
    vc[:, :, :, pos:] = float("nan")
    got = da._launch(q, kc, vc, kn, vn, 1, pos, window)
    torch.cuda.synchronize()
    want = da.decode_attention_plain(q, kc, vc, kn, vn, 1, pos, window)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 8, 64])
def test_moe_paged_attention_grok_group(cuda, dtype, t):
    """paged_attention at Grok-1's heads (8 kv heads of 6 query heads, hs 128)."""
    q, kc, vc, kn, vn, tables, lens, w = _paged_inputs(cuda, dtype, t, 6, 8, 128,
                                                       [0, 37, 300, 16], seed=t)
    layer = torch.ones(1, dtype=torch.int32, device=cuda)
    got = pa._launch(q, kc, vc, kn, vn, tables, lens, layer, w)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, kc, vc, kn, vn, tables, lens, 1, n_read=w)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral", "grok1"])
@pytest.mark.parametrize("prologue", [False, True])
def test_moe_graph_replay_and_device_loop(cuda, arch, prologue):
    """A 2-layer model at Mixtral or Grok-1 width, random Q40 drawn on the card, with
    and without the fused prologue (which takes the attention only): the one-token step
    replayed from its CUDA graph gives the eager step's logits bit for bit (the routing,
    the top-k and the expert indices made inside the captured step), the device loop
    gives the host loop's greedy tokens, and the experts each layer chose differ from
    step to step."""
    import chip_smoke

    spec = chip_smoke._mixtral_8x7b(2) if arch == "mixtral" else chip_smoke._grok1(2)
    params = chip_smoke._random_moe_params(spec, cuda, seed=33)
    kw = dict(device="cuda", prefill_kernel=True, fused_prologue=prologue)
    graph_eng, eager = Engine(spec, params, **kw), Engine(spec, params, cuda_graph=False, **kw)
    prompt = _prompt(40, 5)
    runs = []
    before = (pro.rmsnorm_launches, mv.q80_launches)
    with chip_smoke._ExpertLog(spec, cuda) as log:
        for eng in (graph_eng, eager):
            smp = chip_smoke._CheckedSampler(spec.vocab_size, keep=True)
            runs.append((eng.generate(prompt, 12, smp)[0], smp.kept))
    (tg, lg), (te, le) = runs
    assert tg == te and all(np.array_equal(a, b) for a, b in zip(lg, le))
    assert graph_eng.graphs.replays >= 12
    per, steps = log.distinct()
    assert steps >= 24 and min(per) > 2, per
    launched = (pro.rmsnorm_launches > before[0], mv.q80_launches > before[1])
    assert launched == (prologue, prologue)
    host = chip_smoke.host_loop_tokens(graph_eng, prompt, 16)
    graph_eng.reset()
    loop = graph_eng.generate_chunked(prompt, 16, Sampler(spec.vocab_size, 0.0), chunk=8)[0]
    assert loop == host


# ------------------------------------------------------------------ the prefix cache


def _prefix_model(dev):
    """2 layers at Llama-2-7B width, random Q40 weights drawn on the card (the gate
    pair kept for the fused serving engine), and a 64-token prefix: 4 blocks of 16."""
    import chip_smoke

    spec = chip_smoke._llama2_7b(n_layers=2)
    return spec, chip_smoke._random_i4p_params(spec, dev, seed=43, gate_pair=True), \
        _prompt(64, 50)


def _prefix_batch(spec, params, **kw):
    be = BatchEngine(spec, params, slots=2, device="cuda", fused_matmul=True, superstep=4,
                     **kw)
    assert be.engine.dtype == torch.bfloat16 and be.prefix_cache is not None
    return be


def _settled(be):
    """Every lease released and the last finish's harvest landed."""
    import time

    t0 = time.time()
    while be.prefix_cache.total_refs() and time.time() - t0 < 60:
        time.sleep(0.01)
    with be._slock:
        assert be.prefix_cache.total_refs() == 0


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16)


@pytest.mark.cuda
def test_prefix_hot_demote_promote_is_bit_exact_in_bf16(cuda):
    """A finished request's prefix blocks demoted device -> host (the hot tier keeps the
    engine dtype) and promoted back by a later hit: the rows the hit's table reads are the
    donor's bf16 rows bit for bit, and the seed moved exactly the promoted blocks."""
    spec, params, p = _prefix_model(cuda)
    be = _prefix_batch(spec, params)
    try:
        be.generate(p + [5, 6, 7], 4, Sampler(spec.vocab_size))
        _settled(be)
        with be._slock:
            before = [be._read_block(b) for b in be._slots[0].blocks[:4]]
        assert be.release_idle() == be.kv_pool.n_blocks - 1
        st = be.prefix_cache.stats()
        assert st["dev_blocks"] == 0 and st["cold_blocks"] == st["demoted_blocks"] >= 4
        assert be.prefix_cache.cold.hot_count() == st["cold_blocks"]  # hot tier, no Q80
        be.generate(p + [9, 10], 4, Sampler(spec.vocab_size))
        _settled(be)
        with be._slock:
            after = [be._read_block(b) for b in be._slots[0].blocks[:4]]
        block_bytes = 2 * spec.n_layers * spec.n_kv_heads * 16 * spec.head_size * 2
        assert be.prefix_cache.stats()["promoted_blocks"] == 4
        assert be.seed_bytes == 4 * block_bytes and be.remapped_blocks == 4
        for (bk, bv), (ak, av) in zip(before, after):
            assert bk.dtype == ak.dtype == torch.bfloat16
            assert torch.equal(_bits(bk), _bits(ak)) and torch.equal(_bits(bv), _bits(av))
    finally:
        be.close()


@pytest.mark.cuda
def test_prefix_cow_and_promotion_keep_the_pool_storage(cuda):
    """Copy-on-write and promotion write into the pool tensors in place: the hit of
    exactly the prefix after a demotion promotes its blocks and copies the boundary
    block, and both pools keep the storage the captured steps were recorded on."""
    spec, params, p = _prefix_model(cuda)
    be = _prefix_batch(spec, params)
    try:
        ptrs = (be.engine.k_cache.data_ptr(), be.engine.v_cache.data_ptr())
        be.generate(p + [5, 6, 7], 8, Sampler(spec.vocab_size))
        _settled(be)
        be.release_idle()
        out = be.generate(p, 8, Sampler(spec.vocab_size))[0]
        _settled(be)
        st = be.prefix_cache.stats()
        assert len(out) == 8 and st["promoted_blocks"] == 4 and be.kv_pool.cow_blocks >= 1
        assert (be.engine.k_cache.data_ptr(), be.engine.v_cache.data_ptr()) == ptrs
        assert be.engine.graphs.replays > 0
    finally:
        be.close()


@pytest.mark.cuda
def test_captured_superstep_reads_remapped_and_copied_blocks(cuda):
    """Super-steps captured as CUDA graphs during the donor's decode, replayed after a
    directory remap (a hit on the prefix) and a copy-on-write (a hit of exactly the
    prefix): every request's greedy tokens equal the eager engine's on the same
    sequence, so each replay read the blocks the edited tables name."""
    spec, params, p = _prefix_model(cuda)
    # two different displacing requests: the same one twice would remap its own block
    displace = [[3] + _prompt(20, seed)[1:] for seed in (51, 53)]
    runs = []
    for graphs in (True, False):
        be = _prefix_batch(spec, params, cuda_graph=graphs)
        try:
            outs = [be.generate(p + [5, 6, 7], 12, Sampler(spec.vocab_size))[0]]
            for hit, other in zip((p + [9, 10], p), displace):
                be.generate(other, 6, Sampler(spec.vocab_size))
                outs.append(be.generate(hit, 12, Sampler(spec.vocab_size))[0])
            _settled(be)
            runs.append((outs, be.remapped_blocks, be.kv_pool.cow_blocks,
                         be.engine.graphs.replays))
        finally:
            be.close()
    (g_outs, g_remap, g_cow, g_replays), (e_outs, e_remap, e_cow, e_replays) = runs
    assert g_outs == e_outs and (g_remap, g_cow) == (e_remap, e_cow) == (7, 1)
    assert g_replays > 0 and e_replays == 0


@pytest.mark.cuda
def test_single_slot_seed_then_graph_replay(cuda):
    """The single-sequence Engine through SingleSlotCache: conversation A, a displacing
    B, then A' sharing A's prefix is seeded from the pool in place, and its decode steps
    (CUDA graph replays) give a fresh Engine's logits bit for bit."""
    import chip_smoke

    from distributed_llama_tpu_torch.cache import PrefixCache, SingleSlotCache

    spec, params, p = _prefix_model(cuda)
    eng = Engine(spec, params, device="cuda", fused_matmul=True)
    ptrs = (eng.k_cache.data_ptr(), eng.v_cache.data_ptr())
    ssc = SingleSlotCache(eng, PrefixCache(max_blocks=64, block_tokens=16))

    def turn(prompt, n, smp):
        reuse = ssc.begin(prompt)
        out, _ = eng.generate(prompt[reuse:], n, smp)
        ssc.end((prompt + out)[:eng.pos])
        return reuse, out

    turn(p + [5, 6, 7], 6, Sampler(spec.vocab_size))
    turn([3] + _prompt(90, 52)[1:], 6, Sampler(spec.vocab_size))
    replays = eng.graphs.replays
    a2 = p + [9, 10, 11]
    got = chip_smoke._CheckedSampler(spec.vocab_size, keep=True)
    reuse, out = turn(a2, 12, got)
    want = chip_smoke._CheckedSampler(spec.vocab_size, keep=True)
    fresh = Engine(spec, params, device="cuda", fused_matmul=True)
    assert fresh.generate(a2, 12, want)[0] == out and reuse == 64
    assert all(np.array_equal(a, b) for a, b in zip(got.kept, want.kept))
    assert eng.graphs.replays - replays >= 11 and ssc.cache.total_refs() == 0
    assert (eng.k_cache.data_ptr(), eng.v_cache.data_ptr()) == ptrs


# ------------------------------------------------------------------ speculative decoding


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_batched_verify_graph_matches_eager(cuda, mode):
    """make_batched_verify_loop at 2 layers of Llama-2-7B width (fused, paged, bf16):
    the captured step replayed from its CUDA graph gives the eager step's targets,
    accepted lengths and carry, and writes the same KV bits; the pools keep the storage
    the graph was captured on. Three live rows (greedy, sampled, near-greedy) and one
    parked row, a block of 9 whose drafts are the eager run's own targets."""
    from distributed_llama_tpu_torch.runtime.device_loop import make_batched_verify_loop

    spec, params, p = _prefix_model(cuda)
    be = BatchEngine(spec, params, slots=4, device="cuda", fused_matmul=True,
                     superstep=4, speculative=8, prefix_cache=False)
    eng = be.engine
    try:
        starts = [40, 17, 63, 5]
        for sl, st in zip(be._slots, starts):
            be._paged_ensure(sl, st + 9)
        tables = be._tables()
        ptrs = (eng.k_cache.data_ptr(), eng.v_cache.data_ptr())
        temps = [0.0, 0.8, 0.02, 0.0] if mode == "sample" else [0.0] * 4
        rng = np.array([[1, 2], [0x12345678, 0x9ABCDEF0], [7, 99], [0, 0]], np.int64)
        props = [[p[i]] + p[i + 1:i + 9] for i in range(4)]
        ndraft = [8, 8, 4, -1]
        loops = {g: make_batched_verify_loop(
            spec, eng.params, 9, mode=mode, dtype=eng.dtype, use_kernels=eng.use_kernels,
            attn_window=eng._window_for(80), kv_block_tokens=be._kv_bt,
            paged_kernel=eng.paged_kernel, graphs=eng.graphs if g else None)
            for g in (False, True)}
        first = loops[False](eng.rope, props, eng.k_cache, eng.v_cache, starts, rng,
                             temps, [0.9] * 4, ndraft, tables)
        props = [[props[r][0]] + first[0][:8, r].tolist() for r in range(4)]
        runs = []
        for g in (False, True, True):
            out = loops[g](eng.rope, props, eng.k_cache, eng.v_cache, starts, rng, temps,
                           [0.9] * 4, ndraft, tables)
            torch.cuda.synchronize()
            runs.append(([t.cpu().clone() for t in out[:5]],
                         eng.k_cache.view(torch.int16).clone().cpu(),
                         eng.v_cache.view(torch.int16).clone().cpu()))
        for other in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0][0], other[0]))
            assert torch.equal(runs[0][1], other[1]) and torch.equal(runs[0][2], other[2])
        assert int(runs[0][0][1][0]) >= 1  # the greedy row accepted its own targets
        assert int(runs[0][0][3][3]) == starts[3]  # the parked row kept its position
        key = ("batched_verify", mode, eng._window_for(80), 4, 9)
        assert key in eng.graphs.keys() and eng.graphs.replays_of(key) == 2
        assert (eng.k_cache.data_ptr(), eng.v_cache.data_ptr()) == ptrs
    finally:
        be.close()


@pytest.mark.cuda
def test_speculative_batch_engine_graph_matches_eager(cuda):
    """The fused BatchEngine(speculative=8) at 2 layers of Llama-2-7B width: with CUDA
    graphs (one per verify bucket) and without, the same tokens and verify turns for
    four staggered repetitive requests, pipelined; the pools keep their storage."""
    import chip_smoke

    spec, params, _ = _prefix_model(cuda)
    base = _prompt(24, 60)
    prompts = [[1] + base[1:13] * 4, [1] + base[5:17] * 3, base + base[:20], base * 2]
    runs = []
    for graph in (True, False):
        be = BatchEngine(spec, params, slots=4, device="cuda", fused_matmul=True,
                         superstep=4, speculative=8, prefix_cache=False,
                         cuda_graph=graph)
        eng = be.engine
        try:
            ptrs = (eng.k_cache.data_ptr(), eng.v_cache.data_ptr())
            reqs, _ = chip_smoke.staggered(be, prompts, 24, after=1)
            runs.append([(r.out, r.stats.spec_turns) for r in reqs])
            assert be.verify_steps > 0
            verify = [k for k in eng.graphs.keys() if k[0] == "batched_verify"]
            assert bool(verify) == graph
            assert (eng.k_cache.data_ptr(), eng.v_cache.data_ptr()) == ptrs
        finally:
            be.close()
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("prefill_kernel", [False, True])
def test_generate_speculative_graph_matches_eager(cuda, prefill_kernel):
    """Engine.generate_speculative at 2 layers of Llama-2-7B width: each verify block
    padded to its bucket and replayed from that bucket's CUDA graph gives the eager
    engine's tokens and turns."""
    import chip_smoke

    spec = chip_smoke._llama2_7b(n_layers=2)
    params = chip_smoke._random_i4p_params(spec, cuda, seed=31)
    base = _prompt(20, 61)
    prompt = base + base[1:] + base[1:11]
    runs = []
    for graph in (True, False):
        eng = Engine(spec, params, device="cuda", prefill_kernel=prefill_kernel,
                     cuda_graph=graph)
        out, st = eng.generate_speculative(prompt, 32, Sampler(spec.vocab_size, 0.0), k=8)
        runs.append((out, st.spec_turns))
        verify = [k for k in eng.graphs.keys() if k[0] == "verify"]
        assert bool(verify) == graph and st.spec_steps > 0
    assert runs[0] == runs[1]


# ------------------------------------------------------------------ recovery


@pytest.mark.cuda
def test_recover_wedged_recaptures_and_keeps_the_pool(cuda):
    """The fused BatchEngine at 2 layers of Llama-2-7B width parked in a dispatch by a
    600 s latency fault: recover_wedged fails both in-flight requests (EngineWedged)
    within 1.5 s, keeps the pool tensors' storage, and the abandoned thread makes no
    launch and no replay when woken; afterwards every graph is captured again and the
    same prompts from the same (emptied) state give the same tokens."""
    import time

    from distributed_llama_tpu_torch.resilience import faults
    from distributed_llama_tpu_torch.resilience.errors import EngineWedged
    from distributed_llama_tpu_torch.resilience.faults import FaultSpec

    spec, params, p = _prefix_model(cuda)
    be = _prefix_batch(spec, params)
    prompts = [p[:21], p[:37] + [9]]

    def run():
        with be._slock:  # one pass admits both: the same schedule each time
            reqs = [be.submit(q, 24, Sampler(spec.vocab_size)) for q in prompts]
        return [r.wait(timeout=300) for r in reqs]
    try:
        before = run()
        eng, graphs = be.engine, be.engine.graphs
        ptrs = (eng.k_cache.data_ptr(), eng.v_cache.data_ptr(), be._tables_dev.data_ptr())
        assert graphs.keys()
        old = {k: graphs._graphs[k] for k in graphs.keys()}
        replays = {k: c.replays for k, c in old.items()}
        plan = faults.install([FaultSpec("batch.dispatch", kind="latency",
                                         delay_ms=600_000, count=1)])
        with be._slock:
            reqs = [be.submit(q, 24, Sampler(spec.vocab_size)) for q in prompts]
        t0 = time.time()
        while plan.fired() == 0 and time.time() - t0 < 60:
            time.sleep(0.005)
        zombie = be._thread
        t0 = time.perf_counter()
        assert be.recover_wedged()
        assert time.perf_counter() - t0 < 1.5
        for r in reqs:
            with pytest.raises(EngineWedged):
                r.wait(timeout=10)
        d0, r0 = be.dispatches, graphs.replays
        faults.release()
        zombie.join(30)
        assert not zombie.is_alive()
        assert (be.dispatches, graphs.replays) == (d0, r0)
        assert {k: c.replays for k, c in old.items()} == replays
        faults.uninstall()
        assert (eng.k_cache.data_ptr(), eng.v_cache.data_ptr(),
                be._tables_dev.data_ptr()) == ptrs
        assert not graphs.keys()
        caps = graphs.captures
        assert run() == before
        assert graphs.captures > caps and set(graphs.keys()) == set(old)
        assert be.release_idle() == be.kv_pool.n_blocks - 1
    finally:
        faults.release()
        faults.uninstall()
        be.close()


@pytest.mark.cuda
def test_seeded_tokens_do_not_depend_on_where_they_are_sampled(cuda):
    """On the card a stochastic token picked on the host (after a prefill, in a one-token
    step) takes the device sampler's pick, as super-step tokens do: a seeded request
    gives the same tokens at superstep 1 (every token a host step) and at superstep 4
    (super-steps on the device), and a resume at k from the same state continues it."""
    spec, params, p = _prefix_model(cuda)
    outs = {}
    for k in (1, 4):
        be = BatchEngine(spec, params, slots=2, device="cuda", fused_matmul=True,
                         superstep=k)
        try:
            outs[k] = [be.submit(p[:30] + [i], 24, Sampler(spec.vocab_size, 0.8, 0.9,
                                                           77 + i)).wait(timeout=300)
                       for i in range(2)]
            if k == 4:
                smp = Sampler(spec.vocab_size, 0.8, 0.9, 77)
                smp.fast_forward(5)
                got = be.submit(p[:30] + [0] + outs[k][0][:5], 19, smp,
                                resume_tokens=5).wait(timeout=300)
                assert got == outs[k][0][5:]
        finally:
            be.close()
    assert outs[1] == outs[4]


# ------------------------------------------------------------------ tenancy, disaggregation
@pytest.mark.cuda
@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "seeded"])
@pytest.mark.parametrize("k", [1, 4], ids=["superstep1", "superstep4_pipelined"])
def test_preempted_batch_resumes_identical_on_the_card(cuda, k, temp):
    """One slot at 2 layers of Llama-2-7B width: a batch request preempted by an
    interactive arrival resumes with the tokens of its uninterrupted run. Its 32-token
    prompt's two blocks are remapped at re-admission and the tail past them (under 8
    tokens) is prefilled one token a step, the (1, 1) shape it was decoded in; at
    superstep 1 the preempted row's undelivered device pick gives its coin back. Both
    runs start from emptied caches: a directory hit would prefill the prompt's last
    token alone, in another shape than the reference's 8-token chunk."""
    import chip_smoke

    spec, params, p = _prefix_model(cuda)
    be = BatchEngine(spec, params, slots=1, device="cuda", fused_matmul=True,
                     superstep=k)
    assert be.pipeline == (k > 1)
    try:
        ref = be.submit(p[:32], 24, Sampler(spec.vocab_size, temp, 0.9, 5),
                        klass="batch").wait(timeout=300)
        chip_smoke._resil_fresh(be)
        inter = []

        def on_token(_t, n=[0]):
            n[0] += 1
            if n[0] == 3:
                inter.append(be.submit([1, 2, 3], 4, Sampler(spec.vocab_size),
                                       klass="interactive"))
        r0 = be.remapped_blocks
        victim = be.submit(p[:32], 24, Sampler(spec.vocab_size, temp, 0.9, 5),
                           klass="batch", on_token=on_token)
        assert victim.wait(timeout=300) == ref
        assert len(inter[0].wait(timeout=300)) == 4
        assert victim.preemptions == 1 and be.remapped_blocks - r0 >= 2
        assert victim.stats.reused_tokens == 32
    finally:
        be.close()


@pytest.mark.cuda
def test_kv_export_wire_import_round_trip_on_the_card(cuda):
    """Export a prompt's blocks (bf16, read from the pool), ship them over the raw wire
    and import them into a fresh engine: it prefills only the 5-token tail and decodes
    the monolithic run's greedy tokens; the Q80 wire ships fewer bytes and completes."""
    from distributed_llama_tpu_torch.cache.wire import decode_blocks, encode_blocks

    spec, params, p = _prefix_model(cuda)
    prompt = p[:37]

    def fresh():
        return BatchEngine(spec, params, slots=2, device="cuda", fused_matmul=True,
                           superstep=4)
    pre, mono, dec = fresh(), fresh(), fresh()
    try:
        want = mono.submit(prompt, 16, Sampler(spec.vocab_size)).wait(timeout=300)
        req = pre.submit(prompt, 1, Sampler(spec.vocab_size), export_kv=True)
        req.wait(timeout=300)
        tokens, blocks, bt = req.kv_export
        assert tokens == prompt[:32] and bt == 16 and len(blocks) == 2
        assert blocks[0][0].dtype == torch.bfloat16 and blocks[0][0].device.type == "cpu"
        raw = encode_blocks(blocks)
        assert dec.import_kv_blocks(tokens, decode_blocks(raw)) == 32
        p0 = dec.prefilled_tokens
        got = dec.submit(prompt, 16, Sampler(spec.vocab_size)).wait(timeout=300)
        assert dec.prefilled_tokens - p0 == 5 and got == want
        q80 = encode_blocks(blocks, q80=True)
        assert len(q80) < len(raw)
        dec.close()
        dec = fresh()
        assert dec.import_kv_blocks(tokens, decode_blocks(q80)) == 32
        assert len(dec.submit(prompt, 16, Sampler(spec.vocab_size)).wait(timeout=300)) == 16
    finally:
        for be in (pre, mono, dec):
            be.close()


def _obs_counter(name: str) -> float:
    from distributed_llama_tpu_torch.obs import metrics

    return metrics.REGISTRY.counter(name, "").value


@pytest.mark.cuda
def test_token_counters_count_every_graph_replay(cuda):
    """batch_decode_tokens_total and engine_decode_tokens_total move by the tokens
    delivered, every one of them from a graph replay after the first captures: the
    counters sit on the host's delivery paths, never inside a captured step."""
    import chip_smoke

    spec = chip_smoke._llama2_7b(n_layers=2)
    params = chip_smoke._random_i4p_params(spec, cuda, seed=41, gate_pair=True)
    be = BatchEngine(spec, params, slots=4, device="cuda", fused_matmul=True, superstep=4)
    try:
        d0 = _obs_counter("batch_decode_tokens_total")
        reqs, _ = chip_smoke.staggered(be, [_prompt(n, 20 + n) for n in (30, 9, 17, 12)],
                                       24, after=1)
        delivered = sum(len(r.out) for r in reqs)
        assert delivered == 4 * 24
        assert be.engine.graphs.replays == be.loop_steps > 2 * be.engine.graphs.captures
        assert _obs_counter("batch_decode_tokens_total") - d0 == delivered
    finally:
        be.close()
    eng = Engine(spec, chip_smoke._random_i4p_params(spec, cuda, seed=42),
                 device="cuda")
    d0 = _obs_counter("engine_decode_tokens_total")
    out, _ = eng.generate(_prompt(20, 5), 24, Sampler(spec.vocab_size))
    assert len(out) == 24 and eng.graphs.replays >= 20
    assert _obs_counter("engine_decode_tokens_total") - d0 == 24


@pytest.mark.cuda
def test_scrape_does_not_synchronize_the_stream(cuda, tmp_path):
    """/metrics and /v1/stats answer while a 100 ms spin holds the engine's stream: both
    return before the spin ends (no gauge callback or stats block waits on the
    device), measured as the PDL tests measure their queueing time."""
    import http.client
    import threading
    import time

    import chip_smoke
    from distributed_llama_tpu_torch.apps import api_server
    from distributed_llama_tpu_torch.tokenizer import TemplateType, Tokenizer

    spec = chip_smoke._llama2_7b(n_layers=2)
    params = chip_smoke._random_i4p_params(spec, cuda, seed=43, gate_pair=True)
    chip_smoke._synthetic_tokenizer(str(tmp_path / "t.t"), spec.vocab_size)
    be = BatchEngine(spec, params, Tokenizer.load(str(tmp_path / "t.t")), slots=2,
                     device="cuda", fused_matmul=True, superstep=4)
    srv = api_server.serve(None, "127.0.0.1", 0, TemplateType.LLAMA2, batch_engine=be)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        be.generate(_prompt(20, 7), 8, Sampler(spec.vocab_size))
        port = srv.server_address[1]
        for path in ("/metrics", "/v1/stats", "/v1/requests"):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", path)  # a warm connection path before the timed one
            assert conn.getresponse().read()
            torch.cuda.synchronize()
            torch.cuda._sleep(int(PDL_SPIN_S * chip_smoke.SPIN_HZ))
            end = torch.cuda.Event()
            end.record()
            t_spin = time.perf_counter()
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            scraped_ms = (time.perf_counter() - t_spin) * 1e3
            assert resp.status == 200 and body
            assert scraped_ms < 1e3 * PDL_SPIN_S and not end.query(), (
                f"GET {path} took {scraped_ms:.1f} ms behind a "
                f"{1e3 * PDL_SPIN_S:.0f} ms spin, or waited for it")
            torch.cuda.synchronize()
            conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        be.close()


@pytest.mark.cuda
def test_annotated_span_encloses_its_graph_launch(cuda):
    """With the tracer's annotation on, a profiled one-token step shows the
    engine.dispatch range, and the step's graph launch lies inside it."""
    from distributed_llama_tpu_torch.obs import trace

    spec, eng, _ = _path_engines(cuda, "q40", False)
    eng.generate(_prompt(8, 2), 2, Sampler(spec.vocab_size))  # captures the step
    trace.install(annotate=True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]
                                    ) as prof:
            eng.infer_chunk([5])
            torch.cuda.synchronize()
    finally:
        trace.uninstall()
    evs = prof.events()
    ranges = [e for e in evs if e.name == "engine.dispatch"]
    launches = [e for e in evs if "GraphLaunch" in e.name]
    assert ranges and launches, sorted({e.name for e in evs})[:40]
    r = ranges[0]
    assert any(r.time_range.start <= g.time_range.start
               and g.time_range.end <= r.time_range.end for g in launches)


# ------------------------------------------------------------------ constraints, drafter

_CONSTRAIN_SCHEMA = {"type": "object", "properties": {
    "name": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}


def _grammars(vocab: int):
    """The schema and the branchy regex of tests/test_constrain.py against chip_smoke's
    synthetic tokenizer of the card model's vocab size (one token a byte: the schema has
    forced chains; EOS is 2)."""
    import chip_smoke
    from distributed_llama_tpu_torch.constrain import compile_grammar

    pieces, eos = chip_smoke._constrain_vocab(vocab)
    assert eos == 2
    return (compile_grammar("json_schema", _CONSTRAIN_SCHEMA, pieces, eos)[0],
            compile_grammar("regex", "[a-z]{24}", pieces, eos)[0])


def _masked_loops(be, mode, masked_window):
    from distributed_llama_tpu_torch.runtime.device_loop import make_batched_decode_loop

    eng = be.engine
    return {g: make_batched_decode_loop(
        be.spec, eng.params, 4, mode=mode, dtype=eng.dtype, use_kernels=eng.use_kernels,
        attn_window=masked_window, kv_block_tokens=be._kv_bt, paged_kernel=eng.paged_kernel,
        graphs=eng.graphs if g else None, masked=True) for g in (False, True)}


def _allowed_walk(aut, local: int, toks) -> bool:
    for t in toks:
        local = aut.advance(local, int(t))
        if local < 0:
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_constrain_masked_graph_replay_matches_eager(cuda, mode):
    """The masked K-step loop at 2 layers of Llama-2-7B width (fused, paged, bf16): the
    captured step replayed from its CUDA graph gives the eager step's tokens, carry and
    constraint states and writes the same KV bits. Rows 0 and 1 decode under the schema
    and the branchy regex (their tokens allowed by their grammars), rows 2 and 3 ride the
    universal state."""
    from distributed_llama_tpu_torch.constrain import ConstraintTable

    spec, params, p = _prefix_model(cuda)
    be = BatchEngine(spec, params, slots=4, device="cuda", fused_matmul=True, superstep=4,
                     prefix_cache=False)
    eng = be.engine
    try:
        auts = _grammars(spec.vocab_size)
        tbl = ConstraintTable(spec.vocab_size, 512, device=cuda)
        offs = [tbl.alloc(i, a) for i, a in enumerate(auts)]
        cmask, cdelta = tbl.device()
        starts = [40, 17, 63, 5]
        for sl, st in zip(be._slots, starts):
            be._paged_ensure(sl, st + 4)
        tables = be._tables()
        temps = [0.0, 0.8, 0.02, 0.0] if mode == "sample" else [0.0] * 4
        rng = np.array([[1, 2], [0x12345678, 0x9ABCDEF0], [7, 99], [0, 0]], np.int64)
        cstate = [offs[0], offs[1], 0, 0]
        loops = _masked_loops(be, mode, eng._window_for(80))
        runs = []
        for g in (False, True, True):
            out = loops[g](eng.rope, [p[i] for i in range(4)], eng.k_cache, eng.v_cache,
                           starts, rng, temps, [0.9] * 4, [4] * 4, tables,
                           constrain=(cstate, cmask, cdelta))
            torch.cuda.synchronize()
            runs.append(([t.cpu().clone() for t in out[:4] + (out[6],)],
                         eng.k_cache.view(torch.int16).clone().cpu()))
        for other in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0][0], other[0]))
            assert torch.equal(runs[0][1], other[1])
        toks = runs[0][0][0]
        for r, aut in enumerate(auts):
            assert _allowed_walk(aut, 0, toks[:, r].tolist()), (r, toks[:, r])
        key = ("batched_loop", mode, eng._window_for(80), 4, 4, "mask")
        assert key in eng.graphs.keys() and eng.graphs.replays_of(key) == 8
    finally:
        be.close()


@pytest.mark.cuda
def test_constrain_attach_after_capture_reuploads_in_place(cuda):
    """A masked step captured while the table holds one grammar: a second grammar
    attached afterwards goes into the same device buffers (their addresses unchanged),
    and the replayed graph masks the new row by it, equal to an eager step."""
    from distributed_llama_tpu_torch.constrain import ConstraintTable

    spec, params, p = _prefix_model(cuda)
    be = BatchEngine(spec, params, slots=2, device="cuda", fused_matmul=True, superstep=4,
                     prefix_cache=False)
    eng = be.engine
    try:
        schema, branchy = _grammars(spec.vocab_size)
        tbl = ConstraintTable(spec.vocab_size, 512, device=cuda)
        off0 = tbl.alloc(0, schema)
        cmask, cdelta = tbl.device()
        ptrs = (cmask.data_ptr(), cdelta.data_ptr())
        starts = [30, 50]
        for sl, st in zip(be._slots, starts):
            be._paged_ensure(sl, st + 4)
        tables = be._tables()
        rng = np.zeros((2, 2), np.int64)
        loops = _masked_loops(be, "greedy", None)
        args = (eng.rope, [p[3], p[9]], eng.k_cache, eng.v_cache, starts, rng, [0.0] * 2,
                [0.9] * 2, [4, 4], tables)
        loops[True](*args, constrain=([off0, 0], cmask, cdelta))  # captures
        captures = eng.graphs.captures
        off1 = tbl.alloc(1, branchy)
        m2, d2 = tbl.device()
        assert m2 is cmask and d2 is cdelta
        assert (cmask.data_ptr(), cdelta.data_ptr()) == ptrs
        got = [t.cpu().clone() for t in loops[True](*args, constrain=([off0, off1], cmask,
                                                                        cdelta))[:4]]
        want = [t.cpu().clone() for t in loops[False](*args, constrain=([off0, off1], cmask,
                                                                          cdelta))[:4]]
        assert eng.graphs.captures == captures
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert _allowed_walk(branchy, 0, got[0][:, 1].tolist())
        assert _allowed_walk(schema, 0, got[0][:, 0].tolist())
    finally:
        be.close()


@pytest.mark.cuda
def test_constrain_batch_engine_graph_matches_eager(cuda):
    """The fused BatchEngine(speculative=8) at 2 layers of Llama-2-7B width with two
    constrained rows (the schema greedy, the branchy regex seeded) and two unconstrained
    ones: with CUDA graphs and without, the same tokens, every constrained output
    grammar-valid, the masked graphs replayed, nothing degraded."""
    from distributed_llama_tpu_torch.runtime.sampler import Sampler as S

    spec, params, p = _prefix_model(cuda)
    auts = _grammars(spec.vocab_size)
    runs = []
    for graph in (True, False):
        be = BatchEngine(spec, params, slots=4, device="cuda", fused_matmul=True,
                         superstep=4, speculative=8, prefix_cache=False, cuda_graph=graph)
        try:
            smps = [S(spec.vocab_size, 0.0), S(spec.vocab_size, 0.8, 0.9, 5),
                    S(spec.vocab_size, 0.0), S(spec.vocab_size, 0.8, 0.9, 6)]
            cons = [auts[0], auts[1], None, None]
            reqs = [be.submit(p[i:i + 12], 30, smps[i], constraint=cons[i])
                    for i in range(4)]
            outs = [r.wait(timeout=600) for r in reqs]
            for aut, out in zip(auts, outs):
                cut = out.index(2) + 1 if 2 in out else len(out)
                assert aut.validate(out[:cut])[0], out
            assert be.constrain_degraded == 0 and be.verify_steps > 0
            masked = {k[0] for k in be.engine.graphs.keys() if k[-1] == "mask"}
            assert masked == ({"batched_loop", "batched_verify"} if graph else set())
            runs.append(outs)
        finally:
            be.close()
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_drafter_scan_graph_matches_eager(cuda):
    """The drafter's catch-up + draft scan at 2 layers of Llama-2-7B width (fused, bf16,
    a self-draft on the target's own prepared weights): replayed from its CUDA graph per
    scan bucket it drafts the eager scan's tokens, turn after turn."""
    from distributed_llama_tpu_torch.draft.drafter import ModelDrafter

    spec, params, p = _prefix_model(cuda)
    eng = Engine(spec, params, device="cuda", fused_matmul=True)
    drafters = [ModelDrafter(spec, eng.params, slots=4, target_spec=spec, device="cuda",
                             dtype=torch.bfloat16, use_kernels="fused", cuda_graph=g)
                for g in (True, False)]
    assert drafters[0].graphs.enabled and not drafters[1].graphs.enabled
    # no copy of the weights: the drafter reads the target's storage
    assert all(drafters[0].params["blocks"][n].data.data_ptr()
               == eng.params["blocks"][n].data.data_ptr() for n in ("wqkv", "w1", "w2"))
    outs = []
    for d in drafters:
        for r in range(3):
            d.attach(r, p[:20 + 7 * r])
        turns = [d.propose_batch({0: 8, 1: 4, 2: 2})]
        for r, drafts in turns[0].items():
            for t in drafts[:2] + [5]:
                d.push(r, t)
        turns.append(d.propose_batch({0: 8, 1: 8, 2: 8}))
        outs.append(turns)
    assert outs[0] == outs[1]
    keys = drafters[0].graphs.keys()
    assert keys and all(k[0] == "draft_scan" for k in keys)


def _paged_pair(kernels: bool):
    """A dense and a paged Engine (ring of 64, host store) on the card, f32, on one tiny
    Q40 model of seq_len 512."""
    spec = ModelSpec(arch_type=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=300, seq_len=512).resolved()
    params = init_random_params(spec, FloatType.Q40, seed=5)
    kw = dict(device="cuda", dtype=torch.float32, use_kernels=kernels,
              prefill_kernel=kernels)
    return (Engine(spec, params, **kw),
            Engine(spec, params, kv_cache_storage="host", kv_cache_resident=64, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", [False, True])
def test_paged_engine_matches_dense_on_card(cuda, kernels):
    """The host KV spill on the card in f32 (TF32 off) against the dense engine, chunk by
    chunk over (64, 8, 1, 1, 7, 1) to 200 positions (the ring wraps twice): 2e-4·max
    |logits| on the dequantize path (only the attention's order differs); with the kernels
    on 2e-2·max (a Q80 activation code may cross a rounding boundary between the two
    attention orders, as in test_engine_kernels_match_cpu_plain)."""
    dense, paged = _paged_pair(kernels)
    assert paged.paged and paged.k_cache.shape[3] == 64
    rng = np.random.default_rng(0)
    pos, i, mix = 0, 0, (64, 8, 1, 1, 7, 1)
    while pos < 200:
        t = min(mix[i % len(mix)], 200 - pos)
        toks = rng.integers(0, 300, size=t).tolist()
        want = dense.infer_chunk(toks)
        got = paged.infer_chunk(toks)
        tol = (2e-2 if kernels else 2e-4) * np.abs(want).max()
        assert np.abs(got - want).max() < tol, f"pos {pos}, {t} tokens"
        pos, i = pos + t, i + 1


@pytest.mark.cuda
def test_paged_engine_keeps_ring_and_projections_on_card(cuda):
    """Past the ring, a paged step keeps its ring on the card and launches the decode
    kernels (q4_matvec at one token, q4_matmul for a chunk); only the cold partial and the
    store are on the host."""
    _dense, paged = _paged_pair(True)
    paged.infer_chunk(list(range(3, 67)))  # 64 tokens: the ring is full
    before = (mv.launches, mm.launches)
    paged.infer_chunk(list(range(5, 13)))
    paged.infer_chunk([7])
    assert mv.launches > before[0] and mm.launches > before[1]
    assert paged.k_cache.is_cuda and paged.v_cache.is_cuda
    assert paged.store.k.device.type == "cpu" and paged.pos == 73
    assert all(t.data.is_cuda for t in paged.params["blocks"].values() if hasattr(t, "data"))


@pytest.mark.cuda
def test_collectives_on_cuda_tensors_over_gloo_match_the_cpu_world(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo (the host-staged wire that lets ranks share one
    card): psum, quantized_psum (its quantize the prologue kernel) and the single-phase
    gather on CUDA tensors give the CPU world's results bit for bit, with the same
    counted bytes."""
    from distributed_llama_tpu_torch.parallel import launch

    rng = np.random.RandomState(4)
    cases = [{"partials": rng.randn(2, *shape).astype(np.float32)}
             for shape in ((1, 1, 4096), (2, 3, 96), (1, 8, 4096))]
    torch.save(cases, tmp_path / "cases.pt")
    runs = {}
    for dev in ("cpu", "cuda:0"):
        (tmp_path / dev).mkdir()
        runs[dev] = launch.run("torch_tp_ranks:collective_cases", 2, dev, backend="gloo",
                               args=(str(tmp_path / "cases.pt"),),
                               workdir=str(tmp_path / dev), deadline=300)
    for r in range(2):
        for got, want in zip(runs["cuda:0"][r], runs["cpu"][r]):
            for key in want:
                if key.endswith("_traffic"):
                    assert got[key] == want[key], key
                else:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.cuda
def test_nccl_world_of_one_eager_and_captured(cuda):
    """An NCCL world of one on cuda:0: the f32 all-reduce, the Q80 two-phase wire (a Q80
    round trip over one member) and the logits gather, eager and captured in a CUDA
    graph replayed on new inputs, each equal to what it must compute
    (chip_smoke.tp_rank_nccl_one)."""
    from distributed_llama_tpu_torch.parallel import launch

    got = launch.run("chip_smoke:tp_rank_nccl_one", 1, "cuda:0", backend="nccl",
                     deadline=300)[0]
    assert got == {"eager": True, "graph": True}


@pytest.mark.cuda
def test_q4_matmul_route_takes_the_tp_shard_k_on_the_card(cuda):
    """On the card the M > 1 route gate is csrc/q4_matmul.cu's own (K a multiple of 64):
    Llama-2-7B's w2 shard at tp = 2 (K = 5504, K/2 not a multiple of the JAX kernel's
    128-lane tile) takes q4_matmul and matches its plain version within 1e-3·max (f32
    output); the same weight on the CPU keeps the JAX package's gate (dequantize)."""
    from distributed_llama_tpu_torch.ops import matmul as tmm
    from distributed_llama_tpu_torch.quants import QTensor

    gen = torch.Generator(device=cuda).manual_seed(8)
    n, k = 256, 5504
    packed = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=gen,
                           device=cuda)
    scales = (torch.rand(n, k // 32, generator=gen, device=cuda) * 0.004 + 0.002).half()
    w = QTensor(FloatType.Q40, packed, scales, layout="i4p")
    x = torch.randn(8, k, generator=gen, device=cuda).to(torch.bfloat16)
    assert tmm.q4_mm_supported(w, 8)
    assert not tmm.q4_mm_supported(w.to("cpu"), 8)
    tmm.reset_kernel_selections()
    y = tmm.qmatmul(x, w, use_kernels="all", out_dtype=torch.float32)
    assert set(tmm.kernel_selections().values()) == {"q4_mm"}
    ref = mm.q4_matmul_plain(x, packed, scales)
    assert float((y - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
