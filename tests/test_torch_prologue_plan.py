"""PyTorch port: the launch shapes of the fused activation prologue
(ops/prologue_plan.py), which need no card — every row of K % 32 == 0 up to 65536, f32
and bf16, with and without the norm: the CTAs' pieces cover the row exactly once, each
32-block within one lane group, no CTA idle, registers within budget, at most 8 CTAs
(one cluster) — and the kernel source's shapes and limits against the plan's."""

import os
import re

import numpy as np
import pytest

from distributed_llama_tpu_torch.ops import cuda_build
from distributed_llama_tpu_torch.ops import prologue_plan as pp

ALL_K = range(32, pp.MAX_K + 1, 32)


def _cover(p: pp.Plan, k: int, x_bf16: bool) -> None:
    """The kernel's map, thread t of CTA c holding pieces c·T·L + i·T + t: each piece of
    the row once, and the lanes of each 32-block in one group of consecutive lanes of
    one warp, on one load."""
    n = pp.pieces(k, x_bf16)
    lanes = 32 // pp.values_per_piece(x_bf16)
    c, i, t = np.meshgrid(np.arange(p.ctas), np.arange(p.per_thread), np.arange(p.threads),
                          indexing="ij")
    pc = (c * p.threads * p.per_thread + i * p.threads + t).ravel()
    group = ((c * p.per_thread + i) * (p.threads // lanes) + t // lanes).ravel()
    keep = pc < n
    assert (np.bincount(pc[keep], minlength=n) == 1).all()
    by_piece = np.empty(n, np.int64)
    by_piece[pc[keep]] = group[keep]
    assert (by_piece.reshape(-1, lanes) == by_piece.reshape(-1, lanes)[:, :1]).all()


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("norm", [True, False])
def test_every_row_covered_once_within_budget(x_bf16, norm):
    for k in ALL_K:
        p = pp.plan(k, x_bf16, norm)
        n = pp.pieces(k, x_bf16)
        slice_ = p.threads * p.per_thread
        assert pp.fits(p, x_bf16, norm)
        assert 1 <= p.ctas <= pp.MAX_CTAS
        assert p.ctas * slice_ >= n > (p.ctas - 1) * slice_  # no CTA without a piece
        assert pp.registers(p.threads, p.per_thread, x_bf16, norm) <= \
            pp.register_budget(p.threads)
        assert p.cluster == (norm and p.ctas > 1)
        _cover(p, k, x_bf16)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("k", [32, 4096, 11008, 14336, 65536])
def test_built_shapes_that_fit_cover_the_row(k, x_bf16, norm):
    """Every shape the kernel is built for (csrc/prologue.cu's CTA sizes and pieces a
    thread) that `fits` maps the row once, the plan's among them."""
    n = pp.pieces(k, x_bf16)
    shapes = []
    for t in pp.THREADS:
        for per in pp.PER_THREAD:
            ctas = -(-n // (t * per))
            p = pp.Plan(t, per, ctas, norm and ctas > 1)
            if pp.fits(p, x_bf16, norm):
                shapes.append(p)
                _cover(p, k, x_bf16)
    assert pp.plan(k, x_bf16, norm) in shapes


def test_rows_the_kernel_does_not_take_raise():
    for k in (0, 16, 48, pp.MAX_K + 32):
        with pytest.raises(ValueError):
            pp.plan(k, False, True)


def test_kernel_source_matches_the_plan():
    """csrc/prologue.cu is built for the plan's CTA sizes and pieces a thread, for at
    most MAX_CTAS CTAs."""
    with open(os.path.join(cuda_build.CSRC_DIR, "prologue.cu")) as f:
        src = f.read()
    assert f"kMaxCtas = {pp.MAX_CTAS};" in src
    by_threads = src[src.index("cudaError_t by_threads"):]
    by_pieces = src[src.index("cudaError_t by_pieces"):src.index("cudaError_t by_threads")]
    threads = tuple(int(v) for v in re.findall(r"case (\d+): return by_pieces",
                                                by_threads))
    pieces = tuple(int(v) for v in re.findall(r"case (\d+):", by_pieces))
    assert threads == pp.THREADS and pieces == pp.PER_THREAD
