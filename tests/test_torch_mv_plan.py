"""PyTorch port: the launch planning of the decode matvec kernels (ops/mv_plan.py), which
needs no card — rows split over one wave of blocks, the ring and the row within the
block's shared memory, every bulk copy aligned and sized — and the matvec wrappers'
output dtype on CPU tensors."""

import os
import re

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import cuda_build, mv_plan
from distributed_llama_tpu_torch.ops import q4_matvec as mv
from distributed_llama_tpu_torch.ops import q8_matvec as q8
from distributed_llama_tpu_torch.ops.matmul import qmatmul_q80
from distributed_llama_tpu_torch.quants import FloatType, QTensor

# decode projections of Llama-2-7B (wqkv, wo, w13, w2, wcls) and the card tests' odd shapes
SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]
ODD = [(300, 704), (300, 96), (300, 128), (4096, 11008), (777, 32768)]
ENTRIES = [("i4p", "quantize"), ("i4p", "q80"), ("i8", "quantize"), ("i8", "q80"),
           ("i8", "precise")]


def _supported(n, k, fmt, mode):
    try:
        mv_plan.check(k, fmt, mode)
    except ValueError:
        return False
    return True


CASES = [(n, k, fmt, mode) for n, k in SHAPES_7B + ODD for fmt, mode in ENTRIES
         if _supported(n, k, fmt, mode)]
# (SMs, blocks per SM): an H100 at the occupancies the ring allows, and smaller cards
CARDS = [(132, 1), (132, 2), (132, 3), (114, 2), (7, 1)]


@pytest.mark.parametrize("n,k,fmt,mode", CASES)
def test_every_row_once_in_one_wave(n, k, fmt, mode):
    for sms, per_sm in CARDS:
        p = mv_plan.plan(n, k, fmt, mode, sms, per_sm)
        assert p.grid == min(n, sms * per_sm)  # one wave, no block without a row
        ranges = mv_plan.row_ranges(p, n)
        assert len(ranges) == p.grid
        assert [r for r0, r1 in ranges for r in range(r0, r1)] == list(range(n))
        sizes = {r1 - r0 for r0, r1 in ranges}
        assert sizes <= {n // p.grid, n // p.grid + 1} and min(sizes) >= 1  # split evenly


@pytest.mark.parametrize("n,k,fmt,mode", CASES)
def test_ring_and_row_fit_shared_memory(n, k, fmt, mode):
    r = mv_plan.ring(k, fmt, mode)
    rb = mv_plan.row_bytes(k, fmt)
    lay = mv_plan.layout(k, fmt, mode, r.rs, r.stages, r.gw)
    assert lay.total == r.smem <= mv_plan.MAX_SMEM
    assert r.stages >= mv_plan.MIN_STAGES and r.gw in (1, 2, 4, 8)
    assert r.rs % (mv_plan.WARPS // r.gw) == 0  # each warp group: the same rows of a slot
    # the regions in order, each on 128 bytes, each as large as what it holds
    assert lay.stage >= r.rs * rb and lay.sstage >= r.rs * mv_plan.scale_bytes(k, fmt)
    assert lay.sring == r.stages * lay.stage
    assert lay.row == lay.sring + r.stages * lay.sstage
    row_bytes = 0 if mode == "precise" else k
    assert lay.row + row_bytes <= lay.sx <= lay.ssum <= lay.red
    if mode == "precise":  # the f32 row passes through the ring's slots 1.. (4·K bytes)
        assert (r.stages - 1) * lay.stage >= 4 * k
    if mode != "precise":
        assert lay.sx + 4 * k // 32 <= lay.ssum
        assert lay.ssum + (4 * k // 32 if fmt == "i4p" else 0) <= lay.red
    assert lay.red + 2 * r.rs * r.gw * 4 <= lay.bars
    assert lay.total == lay.bars + 8 * r.stages
    assert all(v % 128 == 0 for v in (lay.stage, lay.sstage, lay.sring, lay.row, lay.sx,
                                      lay.ssum, lay.red, lay.bars))
    # every chunk of a row has a lane, each lane at most 4 chunks (the kernel's
    # registers; 2 for the precise mode's f32 row)
    assert 1 <= r.cpl <= (2 if mode == "precise" else 4)
    assert r.cpl * 32 * r.gw >= rb // 32 > (r.cpl - 1) * 32 * r.gw
    # the pre-quantized entry issues 1..stages slots before its wait for the prologue
    assert (1 <= r.pre <= r.stages) if mode == "q80" else r.pre == 0


@pytest.mark.parametrize("n,k,fmt,mode", CASES)
def test_every_bulk_copy_is_aligned_and_sized(n, k, fmt, mode):
    p = mv_plan.plan(n, k, fmt, mode, 132, 2)
    lay = mv_plan.layout(k, fmt, mode, p.ring.rs, p.ring.stages, p.ring.gw)
    rb = mv_plan.row_bytes(k, fmt)
    seen = 0
    for block, slot, src, size in mv_plan.bulk_copies(p, n, k, fmt):
        assert src % 16 == 0 and size % 16 == 0 and 0 < size <= lay.stage
        assert (lay.ring + slot * lay.stage) % 16 == 0
        assert size < 1 << 20  # an mbarrier's transaction count
        assert src == seen  # the blocks' spans tile the weights in order
        seen += size
    assert seen == n * rb
    # the scales of a slot come by 4-byte copies: whole words from a 4-byte offset
    assert mv_plan.scale_bytes(k, fmt) % 4 == 0


@pytest.mark.parametrize("n,k", SHAPES_7B)
@pytest.mark.parametrize("fmt,mode", ENTRIES)
def test_weights_in_flight_at_the_7b_shapes(n, k, fmt, mode):
    """Each block keeps at least 32 KB of weight bytes requested while it works on a slot
    (all slots but the one it reads), as the kernel's header states."""
    r = mv_plan.ring(k, fmt, mode)
    assert (r.stages - 1) * r.rs * mv_plan.row_bytes(k, fmt) >= 32 * 1024


@pytest.mark.parametrize("k,fmt,mode", [(96, "i4p", "quantize"), (32, "i4p", "q80"),
                                        (32832, "i4p", "quantize"), (100, "i8", "quantize"),
                                        (32800, "i8", "q80"), (12320, "i8", "precise"),
                                        (4096, "i4p", "precise"), (4096, "q4", "quantize"),
                                        (4096, "i8", "fast"), (0, "i8", "quantize")])
def test_unsupported_shapes_are_refused(k, fmt, mode):
    with pytest.raises(ValueError):
        mv_plan.ring(k, fmt, mode)
    with pytest.raises(ValueError):
        mv_plan.plan(300, k, fmt, mode, 132, 2)


@pytest.mark.parametrize("args", [(0, 4096, "i8", "q80", 132, 2),
                                  (300, 4096, "i8", "q80", 0, 2),
                                  (300, 4096, "i4p", "quantize", 132, 0)])
def test_bad_launch_arguments_are_refused(args):
    with pytest.raises(ValueError):
        mv_plan.plan(*args)


def test_the_plan_knows_the_kernel_header():
    """THREADS and MAX_SMEM mirror matvec_stream.cuh; the header lays out shared memory
    with the same regions in the same order as `layout`."""
    with open(os.path.join(cuda_build.CSRC_DIR, "matvec_stream.cuh")) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kThreads = (\d+);", text)[1]) == mv_plan.THREADS
    assert int(re.search(r"constexpr int kMaxSmem = (\d+);", text)[1]) == mv_plan.MAX_SMEM
    body = text[text.index("inline Layout layout("):]
    body = body[:body.index("return l;")]
    order = re.findall(r"l\.(\w+) = ", body)
    assert order == ["stage", "sstage", "ring", "sring", "xq", "sx", "ssum", "red", "sx",
                     "ssum", "red", "bars", "total"]


def _q4(n, k, rng):
    packed = torch.from_numpy(rng.integers(0, 256, (n, k // 2), dtype=np.uint8))
    scales = torch.from_numpy((rng.random((n, k // 32)) * 0.01).astype(np.float16))
    return QTensor(FloatType.Q40, packed, scales, "i4p")


def _q8(n, k, rng):
    w8 = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    scales = torch.from_numpy((rng.random((n, k // 32)) * 1e-3).astype(np.float32))
    return QTensor(FloatType.Q80, w8, scales, "i8")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["q4_matvec", "q4_matvec_q80", "q8_matvec",
                                   "q8_matvec_precise", "q8_matvec_q80", "qmatmul_q80_i4p",
                                   "qmatmul_q80_i8"])
def test_cpu_out_dtype_is_plain_then_cast(entry, out_dtype):
    """On CPU tensors each matvec entry returns its plain version's f32 result rounded
    once to the caller's dtype, as the kernels write it on the card."""
    rng = np.random.default_rng(6)
    n, k = 40, 128
    x = torch.from_numpy(rng.standard_normal((1, 1, k)).astype(np.float32)).to(torch.bfloat16)
    xq, sx = mv.quantize_row(x.reshape(k))
    w4, w8 = _q4(n, k, rng), _q8(n, k, rng)
    if entry == "q4_matvec":
        got = mv.q4_matvec(x, w4, out_dtype=out_dtype)
        want = mv.q4_matvec_plain(x.reshape(k), w4.data, w4.scales)
    elif entry == "q4_matvec_q80":
        got = mv.q4_matvec_q80(xq[None], sx[None], w4, out_dtype=out_dtype)
        want = mv.q4_matvec_q80_plain(xq, sx, w4.data, w4.scales)
    elif entry == "q8_matvec":
        got = q8.q8_matvec(x, w8, out_dtype=out_dtype)
        want = q8.q8_matvec_plain(x.reshape(k), w8.data, w8.scales)
    elif entry == "q8_matvec_precise":
        got = q8.q8_matvec(x, w8, out_dtype=out_dtype, precise=True)
        want = q8.q8_matvec_precise_plain(x.reshape(k), w8.data, w8.scales)
    elif entry == "q8_matvec_q80":
        got = q8.q8_matvec_q80(xq[None], sx[None], w8, out_dtype=out_dtype)
        want = q8.q8_matvec_q80_plain(xq, sx, w8.data, w8.scales)
    else:
        w = w4 if entry.endswith("i4p") else w8
        got = qmatmul_q80(xq[None], sx[None], w, use_kernels=True, out_dtype=out_dtype)
        plain = mv.q4_matvec_q80_plain if w is w4 else q8.q8_matvec_q80_plain
        want = plain(xq, sx, w.data, w.scales)
    assert got.dtype == out_dtype
    assert got.numel() == n
    assert torch.equal(got.reshape(n), want.to(out_dtype))


def test_cpu_out_dtype_defaults_to_the_row_dtype():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 1, 128)).astype(np.float32)).to(torch.bfloat16)
    assert mv.q4_matvec(x, _q4(8, 128, rng)).dtype == torch.bfloat16
    assert q8.q8_matvec(x.float(), _q8(8, 128, rng)).dtype == torch.float32
