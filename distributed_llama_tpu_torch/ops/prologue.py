"""Kernels 10 and 11: the fused activation prologue of the decode matvecs — rmsnorm and
the Q80 quantization of one activation row in one pass, feeding `qmatmul_q80`.

    rmsnorm_quantize_q80:  x (..., K) f32/bf16, w (K,)  ->  xq (1, K) int8, sx (1, K/32) f32
    quantize_q80_row:      x (..., K)                   ->  xq (1, K) int8, sx (1, K/32) f32

Replaces distributed_llama_tpu/ops/pallas_prologue.py `_rmsnorm_q80` and `_quantize`.
The CUDA kernel is csrc/prologue.cu, one source with a flag for the norm; its header
says what bounds it on an H100 (latency), how one read of the row and a programmatic
dependent launch answer that, and which rounding rules keep it bit-exact.
ops/prologue_plan.py gives each launch its shape (threads, pieces a thread, CTAs).

Numerics: the norm runs in f32 as the port's ops/kernels.py rmsnorm does on an f32 row
(mean of squares, eps inside, reciprocal of the square root, (x·inv)·w); the quantize
step is `quantize_row`. The kernel's quantize step gives the plain version's bits; its
sum of squares runs in another (fixed) order than torch.mean, so rmsnorm_q80 may move an
xq value that sits within an ulp of a rounding tie by one.

The entries take the plain version for CPU tensors and launch the kernel for CUDA
tensors, with programmatic stream serialization: the pre-quantized matvec behind it
is launched while it runs. `rmsnorm_launches` and
`quantize_launches` count each entry's launches.
"""

from __future__ import annotations

import torch

from ..quants import QK
from . import cuda_build, prologue_plan
from .kernels import rmsnorm
from .q4_matvec import aligned, quantize_row

rmsnorm_launches = 0
quantize_launches = 0

_P, _I, _F = cuda_build.P, cuda_build.I, cuda_build.F
_SIGNATURES = {"prologue_q80": [_P, _I, _P, _F, _I, _P, _P] + [_I] * 4 + [_P]}


def prologue_supported(k: int) -> bool:
    """Whole 32-blocks and a row of at most 64k elements (the JAX package's gate)."""
    return k % QK == 0 and k <= prologue_plan.MAX_K


def rmsnorm_q80_plain(x_row: torch.Tensor, w: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10's function in plain torch: x_row (K,) -> (xq (K,) int8, sx (K/32,) f32)
    of rmsnorm(x_row, w) computed in f32."""
    return quantize_row(rmsnorm(x_row.float(), w.float(), eps))


def quantize_q80_plain(x_row: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11's function in plain torch: `quantize_row`."""
    return quantize_row(x_row)


def _launch(x_row: torch.Tensor, w: torch.Tensor | None,
            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    global rmsnorm_launches, quantize_launches
    k = x_row.shape[0]
    if x_row.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prologue kernel takes f32 or bf16 activations, got {x_row.dtype}")
    if not prologue_supported(k):
        raise ValueError(f"prologue kernel cannot take K={k}")
    x_row = aligned(x_row)
    if w is not None:
        if w.shape != (k,) or w.device != x_row.device:
            raise ValueError(f"rmsnorm_q80: weight {tuple(w.shape)} on {w.device} against "
                             f"a row of {k} on {x_row.device}")
        w = aligned(w.float())
    xb = x_row.dtype == torch.bfloat16
    p = prologue_plan.plan(k, xb, w is not None)
    xq = torch.empty(k, dtype=torch.int8, device=x_row.device)
    sx = torch.empty(k // QK, dtype=torch.float32, device=x_row.device)
    lib = cuda_build.load("prologue", _SIGNATURES)
    rc = lib.prologue_q80(x_row.data_ptr(), int(xb), None if w is None else w.data_ptr(),
                          float(eps), int(w is not None), xq.data_ptr(), sx.data_ptr(), k,
                          p.threads, p.per_thread, p.ctas, cuda_build.stream_of(x_row))
    cuda_build.check(rc, "rmsnorm_q80" if w is not None else "quantize_q80")
    if w is not None:
        rmsnorm_launches += 1
    else:
        quantize_launches += 1
    return xq, sx


def _one_row(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.numel() != x.shape[-1]:
        raise ValueError(f"{what} takes one activation row, got {tuple(x.shape)}")
    return x.reshape(x.shape[-1])


def rmsnorm_quantize_q80(x: torch.Tensor, w: torch.Tensor,
                         eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) with leading dims multiplying to 1 -> (xq (1, K) int8, sx (1, K/32)
    f32) of rmsnorm(x, w) quantized per 32-block."""
    x_row = _one_row(x, "rmsnorm_quantize_q80")
    if x.device.type == "cuda":
        xq, sx = _launch(x_row, w, eps)
    elif x.device.type == "cpu":
        xq, sx = rmsnorm_q80_plain(x_row, w, eps)
    else:
        raise ValueError(f"rmsnorm_quantize_q80: no kernel for device {x.device}")
    return xq[None], sx[None]


def quantize_q80_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) with leading dims multiplying to 1 -> (xq (1, K) int8, sx (1, K/32)
    f32)."""
    x_row = _one_row(x, "quantize_q80_row")
    if x.device.type == "cuda":
        xq, sx = _launch(x_row, None, 0.0)
    elif x.device.type == "cpu":
        xq, sx = quantize_q80_plain(x_row)
    else:
        raise ValueError(f"quantize_q80_row: no kernel for device {x.device}")
    return xq[None], sx[None]
