"""Kernels 6 and 7: the decode matvec y = W·x against weights in the int8-plane (i8)
layout: Q80 weights, and Q40 weights whose K fails the i4p alignment.

Replaces distributed_llama_tpu/ops/pallas_q8.py `_q8_matvec` (the int8 body
`_matvec_kernel` with the Q80 row quantizer `_quantize_row` that feeds it: `q8_matvec`;
the precise body `_matvec_kernel_f32`: `q8_matvec(precise=True)`) and
`_q8_matvec_inline` (`q8_matvec_q80`, the entry the fused prologue feeds). The CUDA
kernel is csrc/q8_matvec.cu over the block body it shares with q4_matvec
(csrc/matvec_stream.cuh); their headers say what bounds it on an H100 (bytes: 1.125
B/weight streamed once) and what the design does about that. ops/mv_plan.py sizes each
launch: the ring, one wave of blocks.

Numerics, shared by the kernel and the plain versions: the activation row is quantized
per 32-block to Q80 exactly as `quantize_row` does (or comes quantized), the per-block
dot P[n,b] of the int8 weights with the int8 row is an exact integer, and y[n] =
Σ_b (s[n,b]·sx[b])·P[n,b] in float32; only the order of that last sum differs. The
precise mode skips the Q80 step: P[n,b] is an f32 sum of W8·x and sx = 1. No entry point
of the port passes `precise`, as none of the JAX package's does. The kernel rounds y
once to the caller's dtype (f32 or bf16), as `.to()` does after the plain version: one
launch per call.

`q8_matvec_expert` is the quantizing entry against one expert of a layer's (E, N, K)
stack, chosen by a one-element int64 index in device memory that the kernel reads
itself (ops/q4_matvec.py says why).

The entries take the plain version for CPU tensors and launch the kernel for CUDA
tensors. `launches` counts the quantizing entry's launches, `expert_launches` the
expert entry's, `precise_launches` the precise mode's, `q80_launches` the pre-quantized
entry's.
"""

from __future__ import annotations

import math

import torch

from ..quants import QK, QTensor
from . import cuda_build, mv_plan
from .q4_matvec import OUT_DTYPES, aligned, check_expert_index, expert_slice, quantize_row

launches = 0
expert_launches = 0
precise_launches = 0
q80_launches = 0

MAX_K = mv_plan.MAX_K
_PRECISE_MAX_K = mv_plan.PRECISE_MAX_K
_P, _I = cuda_build.P, cuda_build.I
_SIGNATURES = {"q8_matvec": [_P, _I, _I, _P, _P, _P] + [_I] * 7 + [_P],
               "q8_matvec_expert": [_P, _I, _P, _P, _P, _I, _P] + [_I] * 7 + [_P],
               "q8_matvec_q80": [_P] * 5 + [_I] * 8 + [_P],
               "q8_matvec_blocks_per_sm": [_I] * 6}


def _block_dots(w8: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """P[n,b] = Σ_{j in block b} W8[n,j]·xb[b,j] in float32: exact for int8 rows
    (|P| <= 128·127·32 < 2^24), an f32 sum for the precise mode's float row."""
    n, k = w8.shape
    nb = k // QK
    return torch.einsum("nbk,bk->nb", w8.float().reshape(n, nb, QK), xb.float())


def q8_matvec_q80_plain(xq: torch.Tensor, sx: torch.Tensor, w8: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Kernel 7's function in plain torch: a Q80 row xq (K,) int8 with block scales sx
    (K/32,) f32, int8 planes w8 (N, K), scales (N, K/32) f32 -> y (N,) f32."""
    nb = scales.shape[1]
    p = _block_dots(w8, xq.reshape(nb, QK))
    return ((scales.float() * sx.float()) * p).sum(dim=1)


def q8_matvec_plain(x_row: torch.Tensor, w8: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """Kernel 6's function in plain torch: x_row (K,) quantized by `quantize_row`, then
    `q8_matvec_q80_plain`."""
    return q8_matvec_q80_plain(*quantize_row(x_row), w8, scales)


def q8_matvec_expert_plain(x_row: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor,
                           e: torch.Tensor) -> torch.Tensor:
    """The expert entry's function in plain torch: x_row (K,), w8 (E, N, K) int8,
    scales (E, N, K/32) f32, e one-element int -> `q8_matvec_plain` against expert e."""
    return q8_matvec_plain(x_row, expert_slice(w8, e), expert_slice(scales, e))


def q8_matvec_precise_plain(x_row: torch.Tensor, w8: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """Kernel 6's precise body in plain torch: x_row (K,) unquantized in f32, sx = 1."""
    nb = scales.shape[1]
    p = _block_dots(w8, x_row.float().reshape(nb, QK))
    return (scales.float() * p).sum(dim=1)


def _check_weights(what: str, w8: torch.Tensor, scales: torch.Tensor, dev,
                   out_dtype) -> int:
    n, k = w8.shape[-2:]
    if w8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes int8 planes and f32 scales, got "
                        f"{w8.dtype}/{scales.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{what} kernel writes {OUT_DTYPES}, not {out_dtype}")
    if k % QK or k > MAX_K or scales.shape != (*w8.shape[:-1], k // QK):
        raise ValueError(f"{what} kernel cannot take K={k}, scales {tuple(scales.shape)}")
    if not (w8.is_contiguous() and scales.is_contiguous()) or w8.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs contiguous, 16-byte aligned weight planes")
    if not (w8.device == scales.device == dev):
        raise ValueError(f"{what}: tensors on different devices")
    return k


def _launch(x_row: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor,
            precise: bool = False, out_dtype=torch.float32,
            e: torch.Tensor | None = None) -> torch.Tensor:
    """The float entry (quantizing, or precise); with `e`, the expert entry against
    matrix e of the (E, N, K) stack `w8`."""
    global launches, precise_launches, expert_launches
    what = "q8_matvec" if e is None else "q8_matvec_expert"
    if x_row.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes f32 or bf16 activations, got {x_row.dtype}")
    if w8.ndim != (2 if e is None else 3) or (precise and e is not None):
        raise ValueError(f"{what}: weights {tuple(w8.shape)}, precise={precise}")
    n = w8.shape[-2]
    dev = x_row.device
    k = _check_weights(what, w8, scales, dev, out_dtype)
    if x_row.shape != (k,):
        raise ValueError(f"{what}: row {tuple(x_row.shape)} against K={k}")
    if precise and k > _PRECISE_MAX_K:
        raise ValueError(f"q8_matvec precise mode takes K <= {_PRECISE_MAX_K}, got {k}")
    x_row = aligned(x_row)
    xb = x_row.dtype == torch.bfloat16
    y = torch.empty(n, dtype=out_dtype, device=dev)
    lib = cuda_build.load("q8_matvec", _SIGNATURES)
    p = mv_plan.for_call(lib, "q8_matvec_blocks_per_sm", n, k, "i8",
                         "precise" if precise else "quantize", xb, dev.index)
    r = p.ring
    ob = int(out_dtype == torch.bfloat16)
    if e is None:
        rc = lib.q8_matvec(x_row.data_ptr(), int(xb), int(precise), w8.data_ptr(),
                           scales.data_ptr(), y.data_ptr(), ob, n, k, r.rs, r.stages, r.gw,
                           p.grid, cuda_build.stream_of(x_row))
    else:
        check_expert_index(what, e, dev)
        rc = lib.q8_matvec_expert(x_row.data_ptr(), int(xb), w8.data_ptr(),
                                  scales.data_ptr(), e.data_ptr(), w8.shape[0],
                                  y.data_ptr(), ob, n, k, r.rs, r.stages, r.gw, p.grid,
                                  cuda_build.stream_of(x_row))
    cuda_build.check(rc, what)
    if e is not None:
        expert_launches += 1
    elif precise:
        precise_launches += 1
    else:
        launches += 1
    return y


def _launch_q80(xq: torch.Tensor, sx: torch.Tensor, w8: torch.Tensor,
                scales: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    global q80_launches
    n = w8.shape[0]
    dev = xq.device
    k = _check_weights("q8_matvec_q80", w8, scales, dev, out_dtype)
    if xq.dtype != torch.int8 or sx.dtype != torch.float32:
        raise TypeError(f"q8_matvec_q80 kernel takes an int8 row and f32 block scales, "
                        f"got {xq.dtype}/{sx.dtype}")
    if xq.shape != (k,) or sx.shape != (k // QK,) or sx.device != dev:
        raise ValueError(f"q8_matvec_q80: row {tuple(xq.shape)}, scales "
                         f"{tuple(sx.shape)} against K={k}")
    xq, sx = aligned(xq), sx.contiguous()
    y = torch.empty(n, dtype=out_dtype, device=dev)
    lib = cuda_build.load("q8_matvec", _SIGNATURES)
    p = mv_plan.for_call(lib, "q8_matvec_blocks_per_sm", n, k, "i8", "q80", False,
                         dev.index)
    r = p.ring
    rc = lib.q8_matvec_q80(xq.data_ptr(), sx.data_ptr(), w8.data_ptr(), scales.data_ptr(),
                           y.data_ptr(), int(out_dtype == torch.bfloat16), n, k, r.rs,
                           r.stages, r.gw, r.pre, p.grid, cuda_build.stream_of(xq))
    cuda_build.check(rc, "q8_matvec_q80")
    q80_launches += 1
    return y


def _check_layout(what: str, w: QTensor) -> None:
    if w.layout != "i8" or w.data.ndim != 2:
        raise ValueError(f"{what} needs 2-D i8-layout weights (QTensor.to_i8_layout, "
                         f"models.params.prepare_for_cuda)")


def q8_matvec(x: torch.Tensor, w: QTensor, *, out_dtype=None,
              precise: bool = False) -> torch.Tensor:
    """Decode-path matmul: x (..., K) with leading dims multiplying to 1, i8-layout
    QTensor (N, K) -> (..., N) in out_dtype (default x's). precise=True skips the
    activation's Q80 step."""
    _check_layout("q8_matvec", w)
    lead = x.shape[:-1]
    if math.prod(lead) != 1:
        raise ValueError(f"q8_matvec takes one activation row, got {tuple(x.shape)}")
    x_row = x.reshape(x.shape[-1])
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x_row, w.data, w.scales, precise, out_dtype)
    elif x.device.type == "cpu":
        plain = q8_matvec_precise_plain if precise else q8_matvec_plain
        y = plain(x_row, w.data, w.scales).to(out_dtype)
    else:
        raise ValueError(f"q8_matvec: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[0])


def q8_matvec_expert(x: torch.Tensor, w: QTensor, e: torch.Tensor, *,
                     out_dtype=None) -> torch.Tensor:
    """Decode-path matmul against one expert: x (..., K) with leading dims multiplying
    to 1, w one layer's i8-layout expert stack (E, N, K), e a one-element int64 tensor
    on x's device -> (..., N) in out_dtype (default x's)."""
    if w.layout != "i8" or w.data.ndim != 3:
        raise ValueError("q8_matvec_expert needs a 3-D i8-layout expert stack")
    lead = x.shape[:-1]
    if math.prod(lead) != 1:
        raise ValueError(f"q8_matvec_expert takes one activation row, got "
                         f"{tuple(x.shape)}")
    x_row = x.reshape(x.shape[-1])
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x_row, w.data, w.scales, out_dtype=out_dtype, e=e)
    elif x.device.type == "cpu":
        y = q8_matvec_expert_plain(x_row, w.data, w.scales, e).to(out_dtype)
    else:
        raise ValueError(f"q8_matvec_expert: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[0])


def q8_matvec_q80(xq: torch.Tensor, sx: torch.Tensor, w: QTensor, *,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Decode-path matmul on a pre-quantized row: xq (..., K) int8 and sx (..., K/32)
    f32 with leading dims multiplying to 1, i8-layout QTensor (N, K) -> (N,) in
    out_dtype."""
    _check_layout("q8_matvec_q80", w)
    xq_row, sx_row = xq.reshape(xq.shape[-1]), sx.reshape(sx.shape[-1])
    if xq.device.type == "cuda":
        return _launch_q80(xq_row, sx_row, w.data, w.scales, out_dtype)
    if xq.device.type == "cpu":
        return q8_matvec_q80_plain(xq_row, sx_row, w.data, w.scales).to(out_dtype)
    raise ValueError(f"q8_matvec_q80: no kernel for device {xq.device}")
