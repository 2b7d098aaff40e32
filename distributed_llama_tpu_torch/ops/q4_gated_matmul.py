"""Kernel 5: the FFN gate pair Y = act(X·dequant(W1)^T) · (X·dequant(W3)^T) for M > 1
activation rows against two Q40 weights in the i4p split-plane layout, act = silu or
tanh-GELU in float32.

Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_gated_matmul`
(`_gated_mm_kernel`). The CUDA kernel is csrc/q4_gated_matmul.cu over the block body of
csrc/q4_mm_tile.cuh with two weight streams; its header says what bounds it on an H100
and what its design does about that. ops/mm_plan.py sizes each launch.

Numerics, shared by the kernel and `q4_gated_matmul_plain`: each product is the q4
dequant-matmul's (bf16 operands, float32 sums), and the activation runs in float32 on the
full gate sum with the formulas of ops/kernels.py; the kernel rounds the result once to
the caller's dtype.

`q4_gated_matmul` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors, one launch per call; `launches` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from ..quants import QTensor
from . import cuda_build, mm_plan
from .kernels import gelu_tanh, silu
from .q4_matmul import OUT_KINDS, check_planes, kernel_input, q4_matmul_plain, split_buffers

launches = 0

ACTS = ("silu", "gelu_tanh")
_P, _I = cuda_build.P, cuda_build.I
_SIGNATURES = {"q4_gated_matmul": [_P] * 6 + [_I, _P, _P] + [_I] * 8 + [_P],
               "q4_gated_matmul_blocks_per_sm": [_I]}


def q4_gated_matmul_plain(x: torch.Tensor, w1: tuple[torch.Tensor, torch.Tensor],
                          w3: tuple[torch.Tensor, torch.Tensor],
                          act: str = "silu") -> torch.Tensor:
    """The kernel's function in plain torch: x (M, K), w1/w3 as (packed, scales) i4p
    planes -> (M, N) f32."""
    f = silu if act == "silu" else gelu_tanh
    return f(q4_matmul_plain(x, *w1)) * q4_matmul_plain(x, *w3)


def _launch(x: torch.Tensor, w1: tuple[torch.Tensor, torch.Tensor],
            w3: tuple[torch.Tensor, torch.Tensor], act: str = "silu",
            out_dtype=torch.float32) -> torch.Tensor:
    global launches
    if act not in ACTS:
        raise ValueError(f"unsupported epilogue activation {act!r}")
    check_planes("q4_gated_matmul", x, *w1)
    check_planes("q4_gated_matmul", x, *w3)
    if w1[0].shape != w3[0].shape:
        raise ValueError(f"q4_gated_matmul: W1 {tuple(w1[0].shape)} and W3 "
                         f"{tuple(w3[0].shape)} differ")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"q4_gated_matmul kernel writes {OUT_KINDS}, not {out_dtype}")
    m, k = x.shape
    n = w1[0].shape[0]
    xb = kernel_input(x)
    dev = x.device
    y = torch.empty(m, n, dtype=out_dtype, device=dev)
    lib = cuda_build.load("q4_gated_matmul", _SIGNATURES)
    p = mm_plan.plan(m, n, k, 2, mm_plan.resident_blocks(
        lib, "q4_gated_matmul_blocks_per_sm", mm_plan.pick_tile(m), dev.index))
    part, counters = split_buffers(p, dev)
    rc = lib.q4_gated_matmul(xb.data_ptr(), w1[0].data_ptr(), w1[1].data_ptr(),
                             w3[0].data_ptr(), w3[1].data_ptr(), y.data_ptr(),
                             OUT_KINDS.index(out_dtype), part, counters, m, n, k,
                             ACTS.index(act), p.cfg, p.splits, p.per_split, p.grid,
                             cuda_build.stream_of(x))
    cuda_build.check(rc, "q4_gated_matmul")
    launches += 1
    return y


def q4_gated_matmul(x: torch.Tensor, w1: QTensor, w3: QTensor, *, act: str = "silu",
                    out_dtype=None) -> torch.Tensor:
    """FFN gate pair: act(x·W1^T) · (x·W3^T) for x (..., K) against two i4p QTensors
    (N, K) -> (..., N)."""
    for w in (w1, w3):
        if w.layout != "i4p" or w.groups != 1 or w.data.ndim != 2:
            raise ValueError("q4_gated_matmul needs 2-D i4p weights packed with groups=1")
    if act not in ACTS:
        raise ValueError(f"unsupported epilogue activation {act!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), x.shape[-1])
    planes1, planes3 = (w1.data, w1.scales), (w3.data, w3.scales)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x2, planes1, planes3, act, out_dtype)
    elif x.device.type == "cpu":
        y = q4_gated_matmul_plain(x2, planes1, planes3, act).to(out_dtype)
    else:
        raise ValueError(f"q4_gated_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[-1])
