"""The tp axis's collectives over torch.distributed, with the Q80-compressed all-reduce.

The port's copy of the JAX package's parallel/collectives.py. The reference compresses
every inter-node activation transfer to Q80 (f32 -> int8 + f16 scale per 32-block)
before the TCP write and dequantizes after (src/tasks.cpp:96-135). `quantized_psum` is
the same EQuARX-style two-phase form as the JAX package's:

1. scatter-reduce: quantize the local partial, all-to-all the block chunks so rank d
   holds every peer's copy of chunk d, dequantize and sum them in rank order;
2. gather: re-quantize the reduced chunk and all-gather it back to the full vector.

Each phase moves (n-1)/n of the compressed payload (34/32 bytes an element), the ring
all-reduce's factor at ~3.8x less payload. Where the block count does not divide by n,
`quantized_psum_gather` all-gathers the whole quantized partial and sums locally.

The wire carries one buffer a phase: a chunk's int8 values and its f16 scales travel
together as bytes (the JAX package issues one collective for each; the bytes are the
same). The uncompressed all-reduce carries f32 whatever the activation dtype: the
reference's `--buffer-float-type f32` wire, and the 4 bytes an element that
`collective_kbytes_per_token` models.

Q80 codes are those of the JAX package's jnp_quantize_q80: scale f16(absmax/127),
value round-half-even(x·(127/absmax)). On a CUDA tensor the quantization is kernel 11
(ops/prologue.py `quantize_q80_row`, bit-exact to its plain version, which is
q4_matvec.quantize_row), one launch per prologue-sized piece of the flattened tensor (32-
blocks never straddle a row, so the flat tensor quantizes as its rows do); on the CPU it
is the plain version. Every collective is recorded on the mesh's TrafficCounter.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import prologue_plan
from ..ops.prologue import quantize_q80_row
from ..ops.q4_matvec import quantize_row
from ..quants import QK

# the largest piece one quantize launch takes: a multiple of 32 within the kernel's row
_PIECE = prologue_plan.MAX_K // QK * QK


def wire_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q80 of x (..., n), n % 32 == 0 -> (values int8 (..., n/32, 32), scales f16
    (..., n/32)), the JAX package's jnp_quantize_q80."""
    n = x.shape[-1]
    flat = x.float().contiguous().reshape(-1)
    if flat.is_cuda:
        parts = [quantize_q80_row(p) for p in flat.split(_PIECE)]
        xq = torch.cat([q.reshape(-1) for q, _ in parts])
        sx = torch.cat([s.reshape(-1) for _, s in parts])
    elif flat.device.type == "cpu":
        xq, sx = quantize_row(flat)
    else:
        raise ValueError(f"wire_quantize: no quantizer for device {flat.device}")
    lead = x.shape[:-1]
    return xq.reshape(*lead, n // QK, QK), sx.to(torch.float16).reshape(*lead, n // QK)


def wire_dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 values (..., nb*32) of Q80 blocks (exact: an int8 times an f16 scale)."""
    out = values.float() * scales.float()[..., None]
    return out.reshape(*values.shape[:-2], values.shape[-2] * QK)


def _pack(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(g, ...) values and (g, ...) scales -> (g, bytes) int8: each row's values, then
    its scales' bytes."""
    g = values.shape[0]
    return torch.cat([values.reshape(g, -1),
                      scales.contiguous().view(torch.int8).reshape(g, -1)], dim=1)


def _unpack(buf: torch.Tensor, rows: int, nbc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of _pack for g rows of `rows` x `nbc` blocks: (g, rows, nbc, 32) int8 and
    (g, rows, nbc) f16."""
    g, nv = buf.shape[0], rows * nbc * QK
    values = buf[:, :nv].reshape(g, rows, nbc, QK)
    scales = buf[:, nv:].contiguous().view(torch.float16).reshape(g, rows, nbc)
    return values, scales


def _gather_rows(flat: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's 1-D `flat` stacked in rank order -> (tp, flat.numel()). gloo takes
    the output flat, as tp pieces each shaped like the input; nccl takes either."""
    out = flat.new_empty(mesh.tp * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=mesh.group)
    mesh.counter.record("all-gather", out.numel() * out.element_size(), mesh.tp)
    return out.reshape(mesh.tp, flat.numel())


def _rows(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n % QK:
        raise ValueError(f"a Q80 wire needs whole 32-blocks, got a last axis of {n}")
    return x.float().contiguous().reshape(-1, n)


def quantized_psum_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce with a Q80 payload in one phase: all-gather the whole quantized
    partial and sum the dequantized copies in rank order. The fallback for a block count
    that does not divide by the group size. x (..., n), n % 32 == 0."""
    n_dev = mesh.tp
    if n_dev <= 1:
        return x
    x2 = _rows(x)
    r, n = x2.shape
    vals, scales = wire_quantize(x2)
    send = _pack(vals[None], scales[None])
    recv = _gather_rows(send.reshape(-1), mesh)
    gv, gs = _unpack(recv, r, n // QK)
    deq = wire_dequantize(gv, gs)  # (n_dev, r, n)
    out = deq[0]
    for s in range(1, n_dev):
        out = out + deq[s]
    return out.reshape(x.shape).to(x.dtype)


def quantized_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Two-phase Q80-compressed all-reduce (the module docstring). x (..., n),
    n % 32 == 0. A one-member group returns x unchanged."""
    return x if mesh.tp <= 1 else _two_phase(x, mesh)


def _two_phase(x: torch.Tensor, mesh) -> torch.Tensor:
    """quantized_psum's wire over the mesh's group, whatever its size: over one member
    it is a Q80 round trip through the collectives."""
    n_dev = mesh.tp
    x2 = _rows(x)
    r, n = x2.shape
    nb = n // QK
    if nb % n_dev:
        return quantized_psum_gather(x, mesh)
    nbc = nb // n_dev
    # phase 1: chunk d of every row goes to rank d
    vals, scales = wire_quantize(x2)  # (r, nb, 32), (r, nb)
    send = _pack(vals.reshape(r, n_dev, nbc, QK).transpose(0, 1).contiguous(),
                 scales.reshape(r, n_dev, nbc).transpose(0, 1))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    mesh.counter.record("all-to-all", recv.numel(), n_dev)
    rv, rs = _unpack(recv, r, nbc)  # the source rank leads
    deq = wire_dequantize(rv, rs)  # (n_dev, r, nbc*32)
    shard = deq[0]
    for s in range(1, n_dev):
        shard = shard + deq[s]
    # phase 2: re-quantize this rank's reduced chunk and gather the chunks in rank order
    qv, qs = wire_quantize(shard)  # (r, nbc, 32), (r, nbc)
    mine = _pack(qv[None], qs[None])
    gv, gs = _unpack(_gather_rows(mine.reshape(-1), mesh), r, nbc)  # (n_dev, r, nbc, 32), (n_dev, r, nbc)
    out = wire_dequantize(gv.transpose(0, 1).reshape(r, nb, QK),
                          gs.transpose(0, 1).reshape(r, nb))
    return out.reshape(x.shape).to(x.dtype)


def psum(x: torch.Tensor, mesh, compress: bool = False) -> torch.Tensor:
    """The tp merge point: the sum of every rank's x, on every rank; through the Q80
    wire with `compress`, else as an f32 all-reduce."""
    if compress:
        return quantized_psum(x, mesh)
    return x if mesh.tp <= 1 else _all_reduce_f32(x, mesh)


def _all_reduce_f32(x: torch.Tensor, mesh) -> torch.Tensor:
    """The f32 all-reduce over the mesh's group, whatever its size."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()  # the all-reduce writes in place; the caller's x stays its own
    dist.all_reduce(y, group=mesh.group)
    mesh.counter.record("all-reduce", y.numel() * y.element_size(), mesh.tp)
    return y.to(x.dtype)


def all_gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's x (..., m) along the last axis in rank order ->
    (..., tp·m): the vocab-split logits."""
    return x if mesh.tp <= 1 else _gather_last(x, mesh)


def _gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    n_dev = mesh.tp
    out = _gather_rows(x.contiguous().reshape(-1), mesh)
    lead = x.shape[:-1]
    out = out.reshape(n_dev, -1, x.shape[-1]).transpose(0, 1)
    return out.reshape(*lead, n_dev * x.shape[-1])


def broadcast_int(value: int, mesh, src: int = 0) -> int:
    """Rank src's integer on every rank (the sampled token: each rank's sampler runs,
    rank src's pick is the one every rank feeds)."""
    if mesh.tp <= 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src, group=mesh.group)
    mesh.counter.record("broadcast", t.numel() * t.element_size(), mesh.tp)
    return int(t.item())
