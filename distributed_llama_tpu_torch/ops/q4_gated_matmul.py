"""Kernel 5: the FFN gate pair Y = act(X·dequant(W1)^T) · (X·dequant(W3)^T) for M > 1
activation rows against two Q40 weights in the i4p split-plane layout, act = silu or
tanh-GELU in float32.

Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_gated_matmul`
(`_gated_mm_kernel`). The CUDA kernel is csrc/q4_gated_matmul.cu; its header says what
bounds it on an H100 and what its design does about that.

Numerics, shared by the kernel and `q4_gated_matmul_plain`: each product is the q4
dequant-matmul's (bf16 operands, float32 sums), and the activation runs in float32 on the
full gate sum with the formulas of ops/kernels.py.

`q4_gated_matmul` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors; `launches` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from ..quants import QK, QTensor
from . import cuda_build
from .kernels import gelu_tanh, silu
from .q4_matmul import q4_matmul_plain, splits_for

launches = 0

ACTS = ("silu", "gelu_tanh")
_P, _I = cuda_build.P, cuda_build.I
_SIGNATURES = {"q4_gated_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}
_TILE_N = 32  # output columns per block (csrc/q4_gated_matmul.cu kBN)


def q4_gated_matmul_plain(x: torch.Tensor, w1: tuple[torch.Tensor, torch.Tensor],
                          w3: tuple[torch.Tensor, torch.Tensor],
                          act: str = "silu") -> torch.Tensor:
    """The kernel's function in plain torch: x (M, K), w1/w3 as (packed, scales) i4p
    planes -> (M, N) f32."""
    f = silu if act == "silu" else gelu_tanh
    return f(q4_matmul_plain(x, *w1)) * q4_matmul_plain(x, *w3)


def _check_planes(x, packed, scales):
    m, k = x.shape
    n, kh = packed.shape
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"q4_gated_matmul kernel takes u8 planes and f16 scales, got "
                        f"{packed.dtype}/{scales.dtype}")
    if kh * 2 != k or k % 64 or scales.shape != (n, k // QK):
        raise ValueError(f"q4_gated_matmul kernel cannot take x {tuple(x.shape)}, "
                         f"w {tuple(packed.shape)}, scales {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()) or packed.data_ptr() % 16:
        raise ValueError("q4_gated_matmul kernel needs contiguous, 16-byte aligned planes")
    if not (packed.device == scales.device == x.device):
        raise ValueError("q4_gated_matmul: tensors on different devices")


def _launch(x: torch.Tensor, w1: tuple[torch.Tensor, torch.Tensor],
            w3: tuple[torch.Tensor, torch.Tensor], act: str = "silu") -> torch.Tensor:
    global launches
    if act not in ACTS:
        raise ValueError(f"unsupported epilogue activation {act!r}")
    _check_planes(x, *w1)
    _check_planes(x, *w3)
    if w1[0].shape != w3[0].shape:
        raise ValueError(f"q4_gated_matmul: W1 {tuple(w1[0].shape)} and W3 "
                         f"{tuple(w3[0].shape)} differ")
    m, k = x.shape
    n, kh = w1[0].shape
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    # split K when the column tiles alone do not cover the card twice over; the
    # activation then runs on the fixed-order sum of the partials in the second pass
    splits = splits_for(m, n, kh, x.device.index, tile_n=_TILE_N)
    part = (torch.empty(splits, 2, m, n, dtype=torch.float32, device=x.device)
            if splits > 1 else y)
    lib = cuda_build.load("q4_gated_matmul", _SIGNATURES)
    rc = lib.q4_gated_matmul(xb.data_ptr(), w1[0].data_ptr(), w1[1].data_ptr(),
                             w3[0].data_ptr(), w3[1].data_ptr(), y.data_ptr(),
                             part.data_ptr(), m, n, k, splits, ACTS.index(act),
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
    if x.device.type == "cuda":
        y = _launch(x2, planes1, planes3, act)
    elif x.device.type == "cpu":
        y = q4_gated_matmul_plain(x2, planes1, planes3, act)
    else:
        raise ValueError(f"q4_gated_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[-1]).to(out_dtype or x.dtype)
