"""Quantized matmul dispatch: y[..., out] = x[..., in] · W[out, in] for a dense or
block-quantized W (reference: the matmul layer, src/funcs.cpp:424-465).

Paths (the JAX package's ops/matmul.py `qmatmul` / `qmatmul_gated` / `qmatmul_q80`, at
the subset the dense Llama path reaches):
- one activation row, i4p weights, `use_kernels` on -> kernel 1, `q4_matvec`;
- one activation row, i8 weights (Q80, or Q40 that fails the i4p alignment),
  `use_kernels` on -> `q8_matvec`;
- a row the fused prologue quantized (`qmatmul_q80`), `use_kernels` on ->
  `q4_matvec_q80` on i4p weights, `q8_matvec_q80` on i8 weights; elsewhere the row is
  dequantized and multiplied in f32;
- M > 1 rows, i4p weights that pass `q4_mm_supported`, `use_kernels` in FUSED_POLICIES
  -> kernel 2, `q4_matmul`; under "fused" a residual rides in its residual mode
  (kernel 4);
- the FFN gate pair under "fused" with M > 1 and an i4p pair that passes
  `q4_gated_supported` -> kernel 5, `q4_gated_matmul`;
- one expert of a layer's MoE stack (`expert=`): a Python int is a view of the stack and
  takes the routes above; an index tensor with one row and `use_kernels` on ->
  `q4_matvec_expert` on i4p stacks, `q8_matvec_expert` on i8 stacks (with `expert_lo`,
  the stack holds the owner window [expert_lo, expert_lo + n_local) of an
  expert-sharded rank, and an index outside it gives zeros), otherwise the expert is
  sliced and dequantized;
- everything else -> dequantize to x's dtype, then a float32-accumulated product (the
  counterpart of the JAX package's `_qmatmul_xla`).

The shape gates choose a route by shape before any launch. On the CPU they mirror the
JAX package's `q4_mm_supported` / `q4_gated_supported` (ops/pallas_q4_mm.py), so the port
computes what the JAX package computes for the same call; on the card they take every K
the CUDA kernels take (a multiple of 64), where the JAX gate held the TPU kernel's
128-lane tile. There is no fallback: a kernel that cannot take its inputs raises.
"""

from __future__ import annotations

import math
import threading

import torch

from ..obs import metrics
from ..quants import QTensor, dequantize_i8
from .q4_gated_matmul import q4_gated_matmul
from .q4_matmul import q4_matmul
from .q4_matvec import expert_slice, q4_matvec, q4_matvec_expert, q4_matvec_q80
from .q8_matvec import q8_matvec, q8_matvec_expert, q8_matvec_q80

# "fused" is a strict superset of "all": everything "all" runs plus the residual-add
# and gate-pair epilogues wired through models/forward.py
FUSED_POLICIES = ("all", "fused")

# the JAX package's family; it moves only when a shape bucket's kernel changes, so it
# reads the same whether a step runs eagerly or replays from a CUDA graph (a replay runs
# no host code, and _record runs at every eager call and at every capture)
_KERNEL_SELECTED = metrics.counter(
    "matmul_kernel_selected_total",
    "matmul kernel lowerings by selected kernel (counted at trace time: one "
    "per compiled program per call site, not per dispatch)",
    labelnames=("kernel",))

# which kernel served each (M, N, K, layout, op) bucket; bounded by the distinct shapes
_selections: dict[str, str] = {}
_selections_lock = threading.Lock()


def _record(kernel: str, m: int, w: QTensor, op: str = "mm") -> None:
    n, kin = w.shape[-2:]
    key = f"m={m},n={n},k={kin},layout={w.layout},op={op}"
    with _selections_lock:
        if _selections.get(key) != kernel:
            _selections[key] = kernel
            _KERNEL_SELECTED.labels(kernel=kernel).inc()


def kernel_selections() -> dict[str, str]:
    """Snapshot of {shape-bucket: kernel}. Kernel names: q4_matvec, q8_matvec, q4_mm,
    q4_mm+res, q4_gated_mm, q4_matvec_q80, q8_matvec_q80 (op=q80), q4_matvec_expert,
    q8_matvec_expert (op=expert), dequant."""
    with _selections_lock:
        return dict(_selections)


def reset_kernel_selections() -> None:
    with _selections_lock:
        _selections.clear()


def _pick_bkp(kh: int) -> int | None:
    """The JAX kernel's packed K tile: the largest of 512/256/128 dividing K/2."""
    for b in (512, 256, 128):
        if kh % b == 0:
            return b
    return None


def q4_mm_supported(w: QTensor, m: int) -> bool:
    """The route gate for the M > 1 dequant-matmul: 2-D i4p packed with groups=1, at
    most 512 rows, and a K the kernel that runs takes. On the card that is
    csrc/q4_matmul.cu's own (ops/mm_plan.py: K a multiple of 64, so a tp shard such as
    Llama-2-7B's w2 at tp=2, K=5504, takes it); elsewhere, where the plain version
    stands in, the JAX package's gate (K/2 a multiple of 128, its TPU kernel's lane
    tile), so the CPU routes every shape as the reference does."""
    if w.layout != "i4p" or w.groups != 1 or w.data.ndim != 2 or m > 512:
        return False
    kh = w.data.shape[1]
    if w.data.device.type == "cuda":
        return kh * 2 % 64 == 0
    return _pick_bkp(kh) is not None


def q4_gated_supported(w1: QTensor, w3: QTensor, m: int) -> bool:
    """The route gate for the gate-pair kernel: both weights pass q4_mm_supported and
    share one shape (the JAX package's rule)."""
    return (q4_mm_supported(w1, m) and q4_mm_supported(w3, m)
            and w1.data.shape == w3.data.shape and w1.scales.shape == w3.scales.shape)


def _res_add(y: torch.Tensor, residual: torch.Tensor, out_dtype) -> torch.Tensor:
    return (residual.float() + y.float()).to(out_dtype)


def qmatmul(x: torch.Tensor, w: QTensor, *, use_kernels: bool | str = False,
            out_dtype=None, residual: torch.Tensor | None = None,
            expert: torch.Tensor | int | None = None,
            expert_lo: int | None = None) -> torch.Tensor:
    """y = x @ W^T for W of logical shape (out, in); x: (..., in) -> (..., out).

    use_kernels: False = dequantize path everywhere; True = kernel 1 (i4p) or q8_matvec
    (i8) for one activation row; "all" = additionally kernel 2 for M > 1; "fused" = "all"
    plus the residual mode.

    residual: optional (..., out) tensor; the result is residual + x @ W^T on every path
    (under "fused" the add runs inside the kernel; elsewhere it is added in f32 before
    the cast, the same rounding as the kernel's f32 add).

    expert: W is one layer's MoE stack (E, out, in) and the product takes its expert
    `expert`: a Python int (a view of the stack), or a one-element int64 tensor on x's
    device, which the matvecs' expert entries read themselves (no copy of the expert, no
    host read of the index). expert_lo: the stack holds experts [expert_lo, expert_lo +
    E) of the model (the owner window of an expert-sharded rank), which only the expert
    entries take: zeros for an index outside the window; any other route raises."""
    m = math.prod(x.shape[:-1])
    out_dtype = out_dtype or x.dtype
    if isinstance(expert, int):
        w, expert = expert_of(w, expert), None
    op = "mm" if expert is None else "expert"
    if use_kernels and m == 1 and w.layout == "i4p" and w.groups == 1:
        if expert is None:
            _record("q4_matvec", m, w)
            y = q4_matvec(x, w, out_dtype=out_dtype)
        else:
            _record("q4_matvec_expert", m, w, op=op)
            y = q4_matvec_expert(x, w, expert, out_dtype=out_dtype, e_lo=expert_lo or 0)
        return y if residual is None else _res_add(y, residual, out_dtype)
    if use_kernels and m == 1 and w.layout == "i8":
        if expert is None:
            _record("q8_matvec", m, w)
            y = q8_matvec(x, w, out_dtype=out_dtype)
        else:
            _record("q8_matvec_expert", m, w, op=op)
            y = q8_matvec_expert(x, w, expert, out_dtype=out_dtype, e_lo=expert_lo or 0)
        return y if residual is None else _res_add(y, residual, out_dtype)
    if expert_lo is not None:
        raise ValueError("an owner window (expert_lo) is taken only by the matvecs' "
                         "expert entries: one row, the kernels on, an i4p or i8 stack")
    if expert is not None:
        w = expert_of(w, expert)
    if use_kernels in FUSED_POLICIES and m > 1 and q4_mm_supported(w, m):
        fuse_res = residual is not None and use_kernels == "fused"
        _record("q4_mm+res" if fuse_res else "q4_mm", m, w)
        y = q4_matmul(x, w, out_dtype=out_dtype, residual=residual if fuse_res else None)
        if residual is not None and not fuse_res:
            return _res_add(y, residual, out_dtype)
        return y
    _record("dequant", m, w, op=op)
    return _qmatmul_dequant(x, w, out_dtype=out_dtype, residual=residual)


def _qmatmul_dequant(x: torch.Tensor, w: QTensor, *, out_dtype=None,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """Dequantize to x's dtype, then multiply with float32 accumulation (products of
    x.dtype values are exact in f32); a residual adds in f32 before the cast."""
    wd = w.dequantize(dtype=x.dtype)
    y = torch.matmul(x.float(), wd.float().transpose(-1, -2))
    if residual is not None:
        y = residual.float() + y
    return y.to(out_dtype or x.dtype)


def expert_of(w: QTensor, e: torch.Tensor | int) -> QTensor:
    """Expert e of a stacked (E, out, in) QTensor: a view for a Python int, an
    index_select for a one-element index tensor."""
    if isinstance(e, int):
        return QTensor(w.ftype, w.data[e], None if w.scales is None else w.scales[e],
                       w.layout, w.groups, w.row_groups)
    return QTensor(w.ftype, expert_slice(w.data, e),
                   None if w.scales is None else expert_slice(w.scales, e),
                   w.layout, w.groups, w.row_groups)


def qmatmul_q80(xq: torch.Tensor, sx: torch.Tensor, w: QTensor, *,
                use_kernels: bool | str = False, out_dtype=torch.float32) -> torch.Tensor:
    """Decode matvec against a pre-quantized activation row (the fused prologue's
    output): xq (1, K) int8, sx (1, K/32) f32 -> (1, 1, N) in out_dtype. With the kernels
    on, i4p weights packed with groups=1 take q4_matvec_q80 and i8 weights
    q8_matvec_q80, which write out_dtype themselves; every other weight dequantizes, and
    so does the row (x̂ = xq·sx), for an f32 product."""
    if use_kernels and w.layout == "i4p" and w.groups == 1:
        _record("q4_matvec_q80", 1, w, op="q80")
        y = q4_matvec_q80(xq, sx, w, out_dtype=out_dtype)
    elif use_kernels and w.layout == "i8":
        _record("q8_matvec_q80", 1, w, op="q80")
        y = q8_matvec_q80(xq, sx, w, out_dtype=out_dtype)
    else:
        _record("dequant", 1, w, op="q80")
        xhat = dequantize_i8(xq, sx, torch.float32)
        y = torch.matmul(xhat, w.dequantize(torch.float32).transpose(-1, -2)).to(out_dtype)
    return y.reshape(1, 1, y.shape[-1])


def qmatmul_gated(x: torch.Tensor, w1: QTensor, w3: QTensor, *, act, act_name: str,
                  use_kernels: bool | str = False, out_dtype=None) -> torch.Tensor:
    """FFN gate pair: act(x @ W1^T) * (x @ W3^T). Under use_kernels == "fused" with
    M > 1 and a pair that passes q4_gated_supported this is one q4_gated_matmul launch;
    every other configuration runs two qmatmul calls and `act` (the torch function of
    the kernel's `act_name` epilogue)."""
    m = math.prod(x.shape[:-1])
    if (use_kernels == "fused" and m > 1 and act_name in ("silu", "gelu_tanh")
            and q4_gated_supported(w1, w3, m)):
        _record("q4_gated_mm", m, w1, op="gated")
        return q4_gated_matmul(x, w1, w3, act=act_name, out_dtype=out_dtype or x.dtype)
    return (act(qmatmul(x, w1, use_kernels=use_kernels, out_dtype=out_dtype))
            * qmatmul(x, w3, use_kernels=use_kernels, out_dtype=out_dtype))
