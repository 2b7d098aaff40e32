"""Kernels 1 and 2: the decode matvec y = W·x against Q40 weights in the i4p split-plane
layout, from a float row or from a row already quantized to Q80.

Replaces distributed_llama_tpu/ops/pallas_q4.py `_q4_matvec` (`_matvec_kernel` ->
`_unpack_dot_epilogue`) with the Q80 row quantizer `_quantize_row` of ops/pallas_q8.py
that feeds it (`q4_matvec`), and `_q4_matvec_inline` (`q4_matvec_q80`, the entry the
fused prologue feeds). The CUDA kernel is csrc/q4_matvec.cu over the block body it
shares with q8_matvec (csrc/matvec_stream.cuh); their headers say what bounds it on an
H100 (bytes: 0.5625 B/weight streamed once) and what the design does about that.
ops/mv_plan.py sizes each launch: the ring, one wave of blocks.

Numerics, shared by the kernel and `q4_matvec_plain`: the activation row is quantized
per 32-block to Q80 (multiply by 127/absmax, round half to even), the per-block dot
P[n,b] of (nibble-8) with the int8 row is an exact integer, and y[n] = Σ_b
(s[n,b]·sx[b])·P[n,b] in float32 — only the order of that last sum differs. The kernel
rounds y once to the caller's dtype (f32 or bf16), as `.to()` does after the plain
version: one launch per call.

`q4_matvec_expert` is the float entry against one expert of the (n_local, N, K/2) stack
of experts [e_lo, e_lo + n_local) a card holds (its owner window: all E on one card,
E/tp under expert parallelism), chosen by a one-element int64 index in device memory
that the kernel reads itself: the MoE decode step passes the router's top-k without
copying the expert or reading the index on the host, so a captured step replays with
each step's experts. An index inside the window computes against local matrix
e - e_lo, with q4_matvec's bound and numerics at the expert's (N, K); one outside it
gives exact zeros and reads no weight byte (the JAX package's lax.cond(owner, compute,
zeros) of its expert-sharded body), costing a launch. `owned` counts, on the card, the
launches that computed.

`q4_matvec`, `q4_matvec_expert` and `q4_matvec_q80` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; `launches` counts the float entry's
launches, `expert_launches` the expert entry's (inside the window or not),
`q80_launches` the pre-quantized entry's.
"""

from __future__ import annotations

import math

import torch

from ..quants import QK, QTensor
from . import cuda_build, mv_plan

launches = 0
expert_launches = 0
q80_launches = 0

MAX_K = mv_plan.MAX_K
_P, _I = cuda_build.P, cuda_build.I
_SIGNATURES = {"q4_matvec": [_P, _I, _P, _P, _P] + [_I] * 7 + [_P],
               "q4_matvec_expert": [_P, _I, _P, _P, _P, _I, _I, _P, _P] + [_I] * 7 + [_P],
               "q4_matvec_q80": [_P] * 5 + [_I] * 8 + [_P],
               "q4_matvec_blocks_per_sm": [_I] * 6}
# output dtypes the kernel writes (out_bf16)
OUT_DTYPES = (torch.float32, torch.bfloat16)


def quantize_row(x_row: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-block Q80 quantization of one activation row (K,) -> (xq (K,) int8,
    sx (K/32,) f32): the reference's Q80 buffer semantics (src/tasks.cpp:96-135)."""
    k = x_row.shape[0]
    g = x_row.reshape(k // QK, QK).float()
    absmax = g.abs().amax(dim=-1)
    # tensor / tensor: torch turns a python-scalar divisor or dividend into a product
    # with a reciprocal (two roundings); the kernel and the JAX package divide once
    c127 = torch.full_like(absmax, 127.0)
    sx = absmax / c127
    inv = torch.where(absmax > 0, c127 / absmax, torch.zeros((), device=g.device))
    xq = torch.round(g * inv[:, None]).to(torch.int8).reshape(k)
    return xq, sx


def q4_matvec_q80_plain(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Kernel 2's function in plain torch: a pre-quantized row xq (K,) int8 with block
    scales sx (K/32,) f32, packed (N, K/2) u8 i4p, scales (N, K/32) f16 -> y (N,) f32.
    P is computed in float32, which is exact here (|P| <= 15·127·32 < 2^24)."""
    n = packed.shape[0]
    nb = scales.shape[1]
    q = torch.cat([packed & 0x0F, packed >> 4], dim=1).float()  # (N, K) nibbles in [0,16)
    xqf = xq.float().reshape(nb, QK)
    p = torch.einsum("nbk,bk->nb", q.reshape(n, nb, QK), xqf)
    p = p - 8.0 * xqf.sum(dim=1)  # remove the nibble offset per block
    return ((scales.float() * sx.float()) * p).sum(dim=1)


def q4_matvec_plain(x_row: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """Kernel 1's function in plain torch: x_row (K,) quantized by `quantize_row`, then
    `q4_matvec_q80_plain`."""
    return q4_matvec_q80_plain(*quantize_row(x_row), packed, scales)


class OwnedCounter:
    """The expert entries' count of launches that computed (an index inside the owner
    window), kept on the card: one int32 a device, which the kernel adds one to. It is
    allocated at the first launch on a device (outside a CUDA graph's capture, so a
    captured launch adds to the same counter on every replay)."""

    def __init__(self):
        self._counts: dict[int, torch.Tensor] = {}

    def tensor(self, dev) -> torch.Tensor:
        i = torch.device(dev).index or 0
        if i not in self._counts:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the owned-compute counter must exist before a CUDA "
                                   "graph captures an expert entry: launch one eagerly "
                                   "first")
            self._counts[i] = torch.zeros(1, dtype=torch.int32, device=f"cuda:{i}")
        return self._counts[i]

    def value(self, dev) -> int:
        return int(self.tensor(dev).item())

    def reset(self, dev) -> None:
        self.tensor(dev).zero_()


owned = OwnedCounter()


def expert_slice(stack: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Matrix e of a stack (E, ...), e a one-element integer tensor clamped into
    [0, E): the index_select of the dequantizing route (the JAX package's
    dynamic_slice_in_dim, which clamps)."""
    idx = e.reshape(1).long().clamp(0, stack.shape[0] - 1)
    return torch.index_select(stack, 0, idx)[0]


def expert_window(stack: torch.Tensor, e: torch.Tensor,
                  e_lo: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain versions' counterpart of the expert entries' own index read: a stack
    (n_local, ...) holding experts [e_lo, e_lo + n_local) and e a one-element integer
    tensor -> (matrix e - e_lo, whether e lies in the window), both without a host read;
    outside the window the matrix is a clamped index's, whose product the caller
    discards."""
    rel = e.reshape(1).long() - e_lo
    inside = (rel >= 0) & (rel < stack.shape[0])
    idx = rel.clamp(0, stack.shape[0] - 1)
    return torch.index_select(stack, 0, idx)[0], inside[0]


def windowed(y: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """y where the expert is in the window, exact zeros where it is not."""
    return torch.where(inside, y, torch.zeros_like(y))


def q4_matvec_expert_plain(x_row: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, e: torch.Tensor,
                           e_lo: int = 0) -> torch.Tensor:
    """The expert entry's function in plain torch: x_row (K,), packed (n_local, N, K/2)
    u8 i4p and scales (n_local, N, K/32) f16 holding experts [e_lo, e_lo + n_local),
    e one-element int -> `q4_matvec_plain` against local matrix e - e_lo, or zeros (N,)
    where e lies outside the window."""
    wp, inside = expert_window(packed, e, e_lo)
    ws, _ = expert_window(scales, e, e_lo)
    return windowed(q4_matvec_plain(x_row, wp, ws), inside)


def check_expert_index(what: str, e: torch.Tensor, dev, e_lo: int) -> None:
    if e.dtype != torch.int64 or e.numel() != 1 or e.device != dev:
        raise ValueError(f"{what} takes the expert as one int64 on {dev}, got "
                         f"{e.dtype} {tuple(e.shape)} on {e.device}")
    if e_lo < 0:
        raise ValueError(f"{what}: the owner window starts at {e_lo}")


def _check_weights(what: str, packed: torch.Tensor, scales: torch.Tensor, dev,
                   out_dtype) -> int:
    n, kh = packed.shape[-2:]
    k = kh * 2
    if packed.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"{what} kernel takes u8 planes and f16 scales, got "
                        f"{packed.dtype}/{scales.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{what} kernel writes {OUT_DTYPES}, not {out_dtype}")
    if k % 64 or k > MAX_K or scales.shape != (*packed.shape[:-1], k // QK):
        raise ValueError(f"{what} kernel cannot take K={k}, scales {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()) or packed.data_ptr() % 16 \
            or scales.data_ptr() % 4:
        raise ValueError(f"{what} kernel needs contiguous weight planes, 16-byte aligned "
                         f"(scales 4-byte aligned)")
    if not (packed.device == scales.device == dev):
        raise ValueError(f"{what}: tensors on different devices")
    return k


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned, as the kernels load the row."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(x_row: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
            out_dtype=torch.float32, e: torch.Tensor | None = None,
            e_lo: int = 0) -> torch.Tensor:
    """The float entry; with `e`, the expert entry against the (n_local, N, K/2) stack
    `packed` of experts [e_lo, e_lo + n_local)."""
    global launches, expert_launches
    what = "q4_matvec" if e is None else "q4_matvec_expert"
    if x_row.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes f32 or bf16 activations, got {x_row.dtype}")
    if packed.ndim != (2 if e is None else 3):
        raise ValueError(f"{what}: weights {tuple(packed.shape)}")
    n = packed.shape[-2]
    dev = x_row.device
    k = _check_weights(what, packed, scales, dev, out_dtype)
    if x_row.shape != (k,):
        raise ValueError(f"{what}: row {tuple(x_row.shape)} against K={k}")
    x_row = aligned(x_row)
    xb = x_row.dtype == torch.bfloat16
    y = torch.empty(n, dtype=out_dtype, device=dev)
    lib = cuda_build.load("q4_matvec", _SIGNATURES)
    p = mv_plan.for_call(lib, "q4_matvec_blocks_per_sm", n, k, "i4p", "quantize", xb,
                         dev.index)
    r = p.ring
    ob = int(out_dtype == torch.bfloat16)
    if e is None:
        rc = lib.q4_matvec(x_row.data_ptr(), int(xb), packed.data_ptr(), scales.data_ptr(),
                           y.data_ptr(), ob, n, k, r.rs, r.stages, r.gw, p.grid,
                           cuda_build.stream_of(x_row))
    else:
        check_expert_index(what, e, dev, e_lo)
        rc = lib.q4_matvec_expert(x_row.data_ptr(), int(xb), packed.data_ptr(),
                                  scales.data_ptr(), e.data_ptr(), e_lo, packed.shape[0],
                                  owned.tensor(dev).data_ptr(), y.data_ptr(), ob, n, k,
                                  r.rs, r.stages, r.gw, p.grid, cuda_build.stream_of(x_row))
    cuda_build.check(rc, what)
    if e is None:
        launches += 1
    else:
        expert_launches += 1
    return y


def _launch_q80(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    global q80_launches
    n = packed.shape[0]
    dev = xq.device
    k = _check_weights("q4_matvec_q80", packed, scales, dev, out_dtype)
    if xq.dtype != torch.int8 or sx.dtype != torch.float32:
        raise TypeError(f"q4_matvec_q80 kernel takes an int8 row and f32 block scales, "
                        f"got {xq.dtype}/{sx.dtype}")
    if xq.shape != (k,) or sx.shape != (k // QK,) or sx.device != dev:
        raise ValueError(f"q4_matvec_q80: row {tuple(xq.shape)}, scales "
                         f"{tuple(sx.shape)} against K={k}")
    xq, sx = aligned(xq), sx.contiguous()
    y = torch.empty(n, dtype=out_dtype, device=dev)
    lib = cuda_build.load("q4_matvec", _SIGNATURES)
    p = mv_plan.for_call(lib, "q4_matvec_blocks_per_sm", n, k, "i4p", "q80", False,
                         dev.index)
    r = p.ring
    rc = lib.q4_matvec_q80(xq.data_ptr(), sx.data_ptr(), packed.data_ptr(),
                           scales.data_ptr(), y.data_ptr(), int(out_dtype == torch.bfloat16),
                           n, k, r.rs, r.stages, r.gw, r.pre, p.grid,
                           cuda_build.stream_of(xq))
    cuda_build.check(rc, "q4_matvec_q80")
    q80_launches += 1
    return y


def q4_matvec(x: torch.Tensor, w: QTensor, *, out_dtype=None) -> torch.Tensor:
    """Decode-path matmul: x (..., K) with leading dims multiplying to 1, i4p-layout
    QTensor (N, K) -> (..., N) in out_dtype (default x's)."""
    if w.layout != "i4p" or w.groups != 1 or w.data.ndim != 2:
        raise ValueError("q4_matvec needs 2-D i4p weights packed with groups=1")
    lead = x.shape[:-1]
    if math.prod(lead) != 1:
        raise ValueError(f"q4_matvec takes one activation row, got {tuple(x.shape)}")
    x_row = x.reshape(x.shape[-1])
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x_row, w.data, w.scales, out_dtype)
    elif x.device.type == "cpu":
        y = q4_matvec_plain(x_row, w.data, w.scales).to(out_dtype)
    else:
        raise ValueError(f"q4_matvec: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[0])


def q4_matvec_expert(x: torch.Tensor, w: QTensor, e: torch.Tensor, *,
                     out_dtype=None, e_lo: int = 0) -> torch.Tensor:
    """Decode-path matmul against one expert: x (..., K) with leading dims multiplying
    to 1, w one layer's i4p-layout stack (n_local, N, K) of experts [e_lo, e_lo +
    n_local), e a one-element int64 tensor on x's device -> (..., N) in out_dtype
    (default x's), zeros where e lies outside the window."""
    if w.layout != "i4p" or w.groups != 1 or w.data.ndim != 3:
        raise ValueError("q4_matvec_expert needs a 3-D i4p expert stack packed with "
                         "groups=1")
    lead = x.shape[:-1]
    if math.prod(lead) != 1:
        raise ValueError(f"q4_matvec_expert takes one activation row, got "
                         f"{tuple(x.shape)}")
    x_row = x.reshape(x.shape[-1])
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        y = _launch(x_row, w.data, w.scales, out_dtype, e=e, e_lo=e_lo)
    elif x.device.type == "cpu":
        y = q4_matvec_expert_plain(x_row, w.data, w.scales, e, e_lo).to(out_dtype)
    else:
        raise ValueError(f"q4_matvec_expert: no kernel for device {x.device}")
    return y.reshape(*lead, y.shape[0])


def q4_matvec_q80(xq: torch.Tensor, sx: torch.Tensor, w: QTensor, *,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Decode-path matmul on a pre-quantized row: xq (..., K) int8 and sx (..., K/32)
    f32 with leading dims multiplying to 1, i4p-layout QTensor (N, K) -> (N,) in
    out_dtype."""
    if w.layout != "i4p" or w.groups != 1 or w.data.ndim != 2:
        raise ValueError("q4_matvec_q80 needs 2-D i4p weights packed with groups=1")
    xq_row, sx_row = xq.reshape(xq.shape[-1]), sx.reshape(sx.shape[-1])
    if xq.device.type == "cuda":
        return _launch_q80(xq_row, sx_row, w.data, w.scales, out_dtype)
    if xq.device.type == "cpu":
        return q4_matvec_q80_plain(xq_row, sx_row, w.data, w.scales).to(out_dtype)
    raise ValueError(f"q4_matvec_q80: no kernel for device {xq.device}")
