"""Kernels 2 and 4: the dequant-matmul Y = X·dequant(W)^T for M > 1 activation rows
against Q40 weights in the i4p split-plane layout, and its residual launch mode
Y = R + X·dequant(W)^T.

Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_matmul` (`_mm_kernel` ->
`_tile_partial`) and `_q4_matmul_res` (`_mm_res_kernel`). Both modes are one CUDA source,
csrc/q4_matmul.cu; its header says what bounds it on an H100 and what its design does
about that.

Numerics, shared by the kernel and `q4_matmul_plain` / `q4_matmul_res_plain`: each weight
decodes as bf16((q - 8) · f32(s)), X is rounded to bf16, the products accumulate in
float32, and the residual is added in float32 — only the order of the sums differs.

`q4_matmul` takes the plain version for CPU tensors and launches the kernel for CUDA
tensors; `launches` counts launches of the plain mode and `res_launches` of the
residual mode.
"""

from __future__ import annotations

import math

import torch

from ..quants import QK, QTensor
from . import cuda_build

launches = 0
res_launches = 0

_P, _I = cuda_build.P, cuda_build.I
_SIGNATURES = {"q4_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
               "q4_matmul_res": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]}
_TILE_N = 64  # output columns per block (csrc/q4_matmul.cu kBN)
_CHUNK = 64  # packed bytes per K stage (kBK)


def dequant_bf16(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """i4p planes (N, K/2) u8 + (N, K/32) f16 -> (N, K) bf16 values, decoded in f32 as
    (q - 8) · s and rounded once."""
    n, kh = packed.shape
    q = torch.cat([packed & 0x0F, packed >> 4], dim=1).float() - 8.0
    w = q.reshape(n, kh * 2 // QK, QK) * scales.float()[:, :, None]
    return w.reshape(n, kh * 2).to(torch.bfloat16)


def q4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: x (M, K) -> (M, N) f32, with bf16 operands
    and a float32 product (exact products of bf16 values, f32 sums)."""
    w = dequant_bf16(packed, scales).float()
    return x.to(torch.bfloat16).float() @ w.T


def q4_matmul_res_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                        res: torch.Tensor) -> torch.Tensor:
    """The residual mode in plain torch: res (M, N) any float dtype + x (M, K) ·
    dequant(W)^T -> (M, N) f32, the add in float32."""
    return res.float() + q4_matmul_plain(x, packed, scales)


def splits_for(m: int, n: int, kh: int, device_index: int, tile_n: int = _TILE_N) -> int:
    """K splits (of whole 64-byte chunks) so that the output tiles times the splits
    cover the card twice over; `tile_n` output columns per block, and an M tile of 16
    rows for M <= 16, else 64."""
    tiles = math.ceil(n / tile_n) * math.ceil(m / (16 if m <= 16 else 64))
    return max(1, min(math.ceil(kh / _CHUNK),
                      math.ceil(2 * cuda_build.sm_count(device_index) / tiles)))


def _launch(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
            res: torch.Tensor | None = None) -> torch.Tensor:
    global launches, res_launches
    m, k = x.shape
    n, kh = packed.shape
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"q4_matmul kernel takes u8 planes and f16 scales, got "
                        f"{packed.dtype}/{scales.dtype}")
    if kh * 2 != k or k % 64 or scales.shape != (n, k // QK):
        raise ValueError(f"q4_matmul kernel cannot take x {tuple(x.shape)}, "
                         f"w {tuple(packed.shape)}, scales {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()) or packed.data_ptr() % 16:
        raise ValueError("q4_matmul kernel needs contiguous, 16-byte aligned weight planes")
    if not (packed.device == scales.device == x.device):
        raise ValueError("q4_matmul: tensors on different devices")
    if res is not None and (res.shape != (m, n) or res.device != x.device
                            or res.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"q4_matmul residual must be ({m}, {n}) f32 or bf16 on "
                         f"{x.device}, got {tuple(res.shape)} {res.dtype} on {res.device}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    # the splits' f32 partials are summed by the kernel's second pass in a fixed order
    splits = splits_for(m, n, kh, x.device.index)
    part = (torch.empty(splits, m, n, dtype=torch.float32, device=x.device)
            if splits > 1 else y)
    lib = cuda_build.load("q4_matmul", _SIGNATURES)
    stream = cuda_build.stream_of(x)
    if res is None:
        rc = lib.q4_matmul(xb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                           y.data_ptr(), part.data_ptr(), m, n, k, splits, stream)
        cuda_build.check(rc, "q4_matmul")
        launches += 1
    else:
        r = res.contiguous()
        rc = lib.q4_matmul_res(xb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                               r.data_ptr(), int(r.dtype == torch.bfloat16), y.data_ptr(),
                               part.data_ptr(), m, n, k, splits, stream)
        cuda_build.check(rc, "q4_matmul_res")
        res_launches += 1
    return y


def q4_matmul(x: torch.Tensor, w: QTensor, *, out_dtype=None,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """M > 1 matmul: x (..., K) against an i4p QTensor (N, K) -> (..., N). With
    `residual` (shape (..., N)) the result is residual + x·W^T, added in f32 inside the
    kernel (the residual launch mode)."""
    if w.layout != "i4p" or w.groups != 1 or w.data.ndim != 2:
        raise ValueError("q4_matmul needs 2-D i4p weights packed with groups=1")
    lead = x.shape[:-1]
    m = math.prod(lead)
    x2 = x.reshape(m, x.shape[-1])
    r2 = None if residual is None else residual.reshape(m, residual.shape[-1])
    if x.device.type == "cuda":
        y = _launch(x2, w.data, w.scales, r2)
    elif x.device.type == "cpu":
        y = (q4_matmul_plain(x2, w.data, w.scales) if r2 is None
             else q4_matmul_res_plain(x2, w.data, w.scales, r2))
    else:
        raise ValueError(f"q4_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[-1]).to(out_dtype or x.dtype)
