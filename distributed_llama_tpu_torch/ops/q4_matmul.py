"""Kernels 2 and 4: the dequant-matmul Y = X·dequant(W)^T for M > 1 activation rows
against Q40 weights in the i4p split-plane layout, and its residual launch mode
Y = R + X·dequant(W)^T.

Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_matmul` (`_mm_kernel` ->
`_tile_partial`) and `_q4_matmul_res` (`_mm_res_kernel`). Both modes are one CUDA source,
csrc/q4_matmul.cu, over the block body it shares with q4_gated_matmul
(csrc/q4_mm_tile.cuh); their headers say what bounds it on an H100 and what the design
does about that. ops/mm_plan.py sizes each launch: tile, K splits, one wave of blocks.

Numerics, shared by the kernel and `q4_matmul_plain` / `q4_matmul_res_plain`: each weight
decodes as bf16((q - 8) · f32(s)), X is rounded to bf16, the products accumulate in
float32, and the residual is added in float32 — only the order of the sums differs. The
kernel rounds the f32 result once to the caller's dtype (f32 or bf16), as `.to()`
does after the plain version.

`q4_matmul` takes the plain version for CPU tensors and launches the kernel for CUDA
tensors, one launch per call; `launches` counts launches of the plain mode and
`res_launches` of the residual mode.
"""

from __future__ import annotations

import math

import torch

from ..quants import QK, QTensor
from . import cuda_build, mm_plan
from .attention_plan import merge_counters

launches = 0
res_launches = 0

_P, _I = cuda_build.P, cuda_build.I
_SIGNATURES = {"q4_matmul": [_P, _P, _P, _P, _I, _P, _I, _P, _P] + [_I] * 7 + [_P],
               "q4_matmul_blocks_per_sm": [_I]}
# output dtypes the kernel's epilogue writes (out_kind)
OUT_KINDS = (torch.float32, torch.bfloat16)


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


def check_planes(what: str, x: torch.Tensor, packed: torch.Tensor,
                 scales: torch.Tensor) -> None:
    """Raise unless the kernels take these i4p planes against x (M, K)."""
    n, kh = packed.shape
    k = x.shape[1]
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"{what} kernel takes u8 planes and f16 scales, got "
                        f"{packed.dtype}/{scales.dtype}")
    if kh * 2 != k or k % 64 or scales.shape != (n, k // QK):
        raise ValueError(f"{what} kernel cannot take x {tuple(x.shape)}, "
                         f"w {tuple(packed.shape)}, scales {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()) or packed.data_ptr() % 16 \
            or scales.data_ptr() % 4:
        raise ValueError(f"{what} kernel needs contiguous weight planes, 16-byte aligned "
                         f"(scales 4-byte aligned)")
    if not (packed.device == scales.device == x.device):
        raise ValueError(f"{what}: tensors on different devices")


def kernel_input(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it: bf16, contiguous, 16-byte aligned."""
    xb = x.to(torch.bfloat16).contiguous()
    return xb.clone() if xb.data_ptr() % 16 else xb


def split_buffers(p: mm_plan.Plan, dev: torch.device) -> tuple[int | None, int | None]:
    """The workspace and tile counters of a launch, as pointers (None without a split)."""
    if p.splits == 1:
        return None, None
    return (mm_plan.workspace(dev, p.part_floats).data_ptr(),
            merge_counters(dev, p.tiles).data_ptr())


def _launch(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
            res: torch.Tensor | None = None, out_dtype=torch.float32) -> torch.Tensor:
    global launches, res_launches
    m, k = x.shape
    n = packed.shape[0]
    check_planes("q4_matmul", x, packed, scales)
    if res is not None and (res.shape != (m, n) or res.device != x.device
                            or res.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"q4_matmul residual must be ({m}, {n}) f32 or bf16 on "
                         f"{x.device}, got {tuple(res.shape)} {res.dtype} on {res.device}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"q4_matmul kernel writes {OUT_KINDS}, not {out_dtype}")
    xb = kernel_input(x)
    dev = x.device
    y = torch.empty(m, n, dtype=out_dtype, device=dev)
    lib = cuda_build.load("q4_matmul", _SIGNATURES)
    p = mm_plan.plan(m, n, k, 1, mm_plan.resident_blocks(
        lib, "q4_matmul_blocks_per_sm", mm_plan.pick_tile(m), dev.index))
    part, counters = split_buffers(p, dev)
    r = None if res is None else res.contiguous()
    rc = lib.q4_matmul(xb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                       None if r is None else r.data_ptr(),
                       0 if r is None else 1 + (r.dtype == torch.bfloat16), y.data_ptr(),
                       OUT_KINDS.index(out_dtype), part, counters, m, n, k, p.cfg,
                       p.splits, p.per_split, p.grid, cuda_build.stream_of(x))
    cuda_build.check(rc, "q4_matmul")
    if res is None:
        launches += 1
    else:
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
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x2, w.data, w.scales, r2, out_dtype)
    elif x.device.type == "cpu":
        y = (q4_matmul_plain(x2, w.data, w.scales) if r2 is None
             else q4_matmul_res_plain(x2, w.data, w.scales, r2)).to(out_dtype)
    else:
        raise ValueError(f"q4_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[-1])
