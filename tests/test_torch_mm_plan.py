"""PyTorch port: the launch planning of the Q40 dequant-matmul kernels
(ops/mm_plan.py), which needs no card: tiles, K splits and grid from the shapes and the
resident block count, and the wrappers' output dtype on CPU tensors."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import mm_plan
from distributed_llama_tpu_torch.ops import q4_gated_matmul as gm
from distributed_llama_tpu_torch.ops import q4_matmul as mm
from distributed_llama_tpu_torch.quants import FloatType, QTensor

# serving and prefill shapes of Llama-2-7B and the edge shapes of the card tests, under
# the resident counts of the card's occupancy queries and some others
SHAPES = [(m, n, k) for m in (1, 2, 3, 8, 9, 16, 17, 64, 70, 128, 256, 512)
          for n, k in ((12288, 4096), (4096, 11008), (32000, 4096), (130, 256), (96, 704))]
RESIDENT = (1, 7, 132, 264, 396, 660)


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("resident", RESIDENT)
def test_splits_cover_every_chunk_once_in_order(streams, resident):
    for m, n, k in SHAPES:
        p = mm_plan.plan(m, n, k, streams, resident)
        ranges = [range(z * p.per_split, min(p.chunks, (z + 1) * p.per_split))
                  for z in range(p.splits)]  # split z's chunks, as the kernel takes them
        assert len(ranges) == p.splits >= 1
        assert [c for r in ranges for c in r] == list(range(k // 64))  # once, in order
        assert all(len(r) > 0 for r in ranges)  # no empty split
        tile = mm_plan.TILES[p.cfg]
        assert all(r.start % tile.ch == 0 for r in ranges)  # splits start on a stage


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("resident", RESIDENT)
def test_tiles_cover_every_output_once_within_one_wave(streams, resident):
    for m, n, k in SHAPES:
        p = mm_plan.plan(m, n, k, streams, resident)
        tile = mm_plan.TILES[p.cfg]
        seen = np.zeros((m, n), dtype=np.int64)
        for t in range(p.tiles):  # the kernel's item -> tile mapping, weight-major
            n0, m0 = t // p.tiles_m * tile.bw, t % p.tiles_m * tile.bn
            seen[m0:m0 + tile.bn, n0:n0 + tile.bw] += 1
        assert (seen == 1).all()
        assert p.tiles_m * tile.bn < m + tile.bn and p.tiles_w * tile.bw < n + tile.bw
        assert 1 <= p.grid <= resident
        assert p.grid <= p.tiles * p.splits
        if p.splits > 1:  # a split plan fits the card at once
            assert p.tiles * p.splits <= resident
            assert p.part_floats == p.tiles * p.splits * tile.threads * 4 * streams \
                * tile.wt * tile.nt
        else:
            assert p.part_floats == 0


def test_tile_follows_the_row_count():
    assert [mm_plan.pick_tile(m) for m in (1, 8, 9, 16, 17, 64, 65, 512)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert [t.bn for t in mm_plan.TILES[:3]] == [8, 16, 64]
    assert all(t.ch in (2, 4) and t.bw % 16 == 0 for t in mm_plan.TILES)


def test_a_small_card_splits_less():
    big = mm_plan.plan(8, 4096, 11008, 1, 660)
    small = mm_plan.plan(8, 4096, 11008, 1, 132)
    assert big.splits > small.splits >= 1


@pytest.mark.parametrize("args", [(0, 64, 64, 1, 10), (8, 0, 64, 1, 10), (8, 64, 32, 1, 10),
                                  (8, 64, 96, 1, 10), (8, 64, 64, 3, 10), (8, 64, 64, 1, 0)])
def test_bad_arguments_raise(args):
    with pytest.raises(ValueError):
        mm_plan.plan(*args)
    with pytest.raises(ValueError):
        mm_plan.pick_tile(0)


def _q4(n, k, rng):
    packed = torch.from_numpy(rng.integers(0, 256, (n, k // 2), dtype=np.uint8))
    scales = torch.from_numpy((rng.random((n, k // 32)) * 0.01).astype(np.float16))
    return QTensor(FloatType.Q40, packed, scales, "i4p")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["mm", "res", "silu", "gelu_tanh"])
def test_cpu_out_dtype_is_plain_then_cast(out_dtype, mode):
    """On CPU tensors the wrappers return the plain version's f32 result cast once to
    the caller's dtype, as the kernels' epilogue rounds it on the card."""
    rng = np.random.default_rng(5)
    m, n, k = 3, 40, 128
    x = torch.from_numpy(rng.standard_normal((1, m, k)).astype(np.float32)).to(torch.bfloat16)
    w1, w3 = _q4(n, k, rng), _q4(n, k, rng)
    x2 = x.reshape(m, k)
    if mode == "mm":
        got = mm.q4_matmul(x, w1, out_dtype=out_dtype)
        want = mm.q4_matmul_plain(x2, w1.data, w1.scales)
    elif mode == "res":
        res = torch.from_numpy(rng.standard_normal((1, m, n)).astype(np.float32))
        got = mm.q4_matmul(x, w1, out_dtype=out_dtype, residual=res)
        want = mm.q4_matmul_res_plain(x2, w1.data, w1.scales, res.reshape(m, n))
    else:
        got = gm.q4_gated_matmul(x, w1, w3, act=mode, out_dtype=out_dtype)
        want = gm.q4_gated_matmul_plain(x2, (w1.data, w1.scales), (w3.data, w3.scales), mode)
    assert got.dtype == out_dtype and got.shape == (1, m, n)
    assert torch.equal(got.reshape(m, n), want.to(out_dtype))


@pytest.mark.parametrize("source,streams", [("q4_matmul", 1), ("q4_gated_matmul", 2)])
def test_the_plan_knows_the_kernels_tiles(source, streams):
    """TILES mirrors the Cfg<...> lines of each CUDA source, in tile order."""
    import os
    import re

    from distributed_llama_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    cfgs = re.findall(r"using C(\d) = q4mm::Cfg<([^>]*)>;", text)
    assert [int(i) for i, _ in cfgs] == list(range(len(mm_plan.TILES)))
    for (_, args), tile in zip(cfgs, mm_plan.TILES):
        ns, wt, nt, ww, wn, ch = (int(a) for a in args.split(",")[:6])
        assert ns == streams
        assert (wt, nt, ww, wn, ch) == (tile.wt, tile.nt, tile.ww, tile.wn, tile.ch)
