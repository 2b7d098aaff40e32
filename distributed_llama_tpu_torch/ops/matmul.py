"""Quantized matmul dispatch: y[..., out] = x[..., in] · W[out, in] for a dense or
block-quantized W (reference: the matmul layer, src/funcs.cpp:424-465).

Paths (the JAX package's ops/matmul.py `qmatmul`, at the subset the dense decode path
reaches):
- one activation row, i4p weights, `use_kernels` on -> kernel 1, `q4_matvec`;
- M > 1 rows, i4p weights, `use_kernels == "all"` (prefill_kernel) -> kernel 2,
  `q4_matmul`;
- everything else -> dequantize to x's dtype, then a float32-accumulated product (the
  counterpart of the JAX package's `_qmatmul_xla`).

There is no fallback: a kernel that cannot take its inputs raises.
"""

from __future__ import annotations

import math
import threading

import torch

from ..quants import QTensor
from .q4_matmul import q4_matmul
from .q4_matvec import q4_matvec

# which kernel served each (M, N, K, layout) bucket; bounded by the distinct shapes
_selections: dict[str, str] = {}
_selections_lock = threading.Lock()


def _record(kernel: str, m: int, w: QTensor) -> None:
    n, kin = w.shape
    key = f"m={m},n={n},k={kin},layout={w.layout},op=mm"
    with _selections_lock:
        _selections[key] = kernel


def kernel_selections() -> dict[str, str]:
    """Snapshot of {shape-bucket: kernel}. Kernel names: q4_matvec, q4_mm, dequant."""
    with _selections_lock:
        return dict(_selections)


def qmatmul(x: torch.Tensor, w: QTensor, *, use_kernels: bool | str = False,
            out_dtype=None) -> torch.Tensor:
    """y = x @ W^T for W of logical shape (out, in); x: (..., in) -> (..., out).

    use_kernels: False = dequantize path everywhere; True = kernel 1 for one activation
    row; "all" = additionally kernel 2 for M > 1 (prefill chunks)."""
    m = math.prod(x.shape[:-1])
    kernel_w = w.layout == "i4p" and w.groups == 1
    if use_kernels and m == 1 and kernel_w:
        _record("q4_matvec", m, w)
        return q4_matvec(x, w, out_dtype=out_dtype or x.dtype)
    if use_kernels == "all" and m > 1 and kernel_w:
        _record("q4_mm", m, w)
        return q4_matmul(x, w, out_dtype=out_dtype or x.dtype)
    _record("dequant", m, w)
    return _qmatmul_dequant(x, w, out_dtype=out_dtype)


def _qmatmul_dequant(x: torch.Tensor, w: QTensor, *, out_dtype=None) -> torch.Tensor:
    """Dequantize to x's dtype, then multiply with float32 accumulation (products of
    x.dtype values are exact in f32)."""
    wd = w.dequantize(dtype=x.dtype)
    y = torch.matmul(x.float(), wd.float().transpose(-1, -2))
    return y.to(out_dtype or x.dtype)
