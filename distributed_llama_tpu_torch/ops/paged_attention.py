"""Kernel 9: paged attention of T chunk queries per batch row over the device block pool
— the batched serving path's attention, decode (T = 1) and prefill chunks alike.

Replaces distributed_llama_tpu/ops/pallas_paged_attention.py `paged_attention`
(`_kernel`). The CUDA kernel is csrc/paged_attention.cu over the block body of
csrc/attention_tile.cuh, which it shares with decode_attention; its header says what
bounds it on an H100 and what its design does about that. One launch per call.

KV lives in (L, N, hk, bt, hs) pools; row b's block table maps virtual position p to pool
block tables[b, p // bt] at offset p % bt, and lengths[b] is the row's committed length
(its start position in this step). Semantics, shared by the kernel and
`paged_attention_plain`: query (b, ti) attends to the committed slots p < lengths[b] of
the first n_read table entries and to the chunk keys tau <= ti (k_new, v_new, not yet in
the pool); scores and softmax in float32. Slots at or past lengths[b] never reach the
output: the kernel never reads them, and the plain version zeroes their values before
the product (a NaN left in a scratch or unused block stays out).

`paged_gather_kv` and `paged_attention_plain` port the JAX package's `paged_gather_kv` and
`paged_attention_xla`. `paged_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; `launches` counts kernel launches. The launch
depends on the shapes and n_read only: tables, lengths and the layer are read on the
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_build
from .attention import gqa_attention
from .attention_plan import merge_counters, resident_blocks, split_plan

launches = 0

KERNEL_HS = (32, 64, 96, 128)  # head sizes the kernel is built for
_P, _I, _F = cuda_build.P, cuda_build.I, cuda_build.F
_SIGNATURES = {"paged_attention": [_P] * 13 + [_I] * 12 + [_F, _P],
               "paged_attention_blocks_per_sm": [_I, _I, _I]}


def paged_gather_kv(kc: torch.Tensor, vc: torch.Tensor, layer_idx: int,
                    tables: torch.Tensor, n_read: int):
    """Gather the first `n_read` table entries' blocks of one layer into contiguous
    (B, hk, n_read·bt, hs) K/V buffers (table entry j supplies positions
    [j·bt, (j+1)·bt)). kc/vc: (L, N, hk, bt, hs) pools; tables: (B, W >= n_read)."""
    _, _, hk, bt, hs = kc.shape
    tbl = tables[:, :n_read].long()
    b = tbl.shape[0]

    def grab(pool):
        g = pool[layer_idx][tbl]  # (B, n_read, hk, bt, hs)
        return g.permute(0, 2, 1, 3, 4).reshape(b, hk, n_read * bt, hs)

    return grab(kc), grab(vc)


def paged_attention_plain(q, kc, vc, k_new, v_new, tables, lengths, layer_idx: int, *,
                          n_read: int) -> torch.Tensor:
    """The kernel's function in plain torch: gather the table's blocks into the dense
    window layout and run gqa_attention with per-row key positions. q: (B, T, hq, hs);
    kc/vc: (L, N, hk, bt, hs); k_new/v_new: (B, hk, T, hs); tables: (B, W); lengths: (B,).
    Returns (B, T, hq, hs) f32."""
    b, t, hq, hs = q.shape
    bt = kc.shape[3]
    win = n_read * bt
    kw, vw = paged_gather_kv(kc, vc, layer_idx, tables, n_read)
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    slot = torch.arange(win, device=q.device)
    live = slot[None, :] < lengths[:, None]  # (B, win)
    vw = torch.where(live[:, None, :, None], vw, torch.zeros((), dtype=vw.dtype,
                                                             device=vw.device))
    # a dead slot's position lies past every query position, so the causal compare
    # masks it whatever the window, as the kernel never reads it (the JAX oracle's
    # win + 1 does so only when the window covers the chunk, as the engines' windows do)
    beyond = torch.iinfo(torch.int64).max
    slot_pos = torch.where(live, slot[None, :], torch.full_like(slot[None, :], beyond))
    chunk_pos = lengths[:, None] + torch.arange(t, device=q.device)[None, :]  # (B, T)
    key_pos = torch.cat([slot_pos, chunk_pos], dim=1)
    kfull = torch.cat([kw, k_new.to(kw.dtype)], dim=2)
    vfull = torch.cat([vw, v_new.to(vw.dtype)], dim=2)
    out = gqa_attention(q.float(), kfull, vfull, chunk_pos, key_positions=key_pos)
    return out.reshape(b, t, hq, hs)


def _launch(q, kc, vc, k_new, v_new, tables, lengths, layer: torch.Tensor, n_read: int):
    global launches
    b, t, hq, hs = q.shape
    nl, n_blocks, hk, bt, hs2 = kc.shape
    if hs2 != hs or vc.shape != kc.shape or hq % hk:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} vs pools {tuple(kc.shape)}")
    if k_new.shape != (b, hk, t, hs) or v_new.shape != (b, hk, t, hs):
        raise ValueError(f"paged_attention: k_new {tuple(k_new.shape)}, want "
                         f"{(b, hk, t, hs)}")
    if kc.dtype not in (torch.bfloat16, torch.float32) or not (
            vc.dtype == k_new.dtype == v_new.dtype == kc.dtype):
        raise TypeError("paged_attention kernel takes bf16 or f32 pools and chunk k/v of "
                        "the same dtype")
    if hs not in KERNEL_HS:
        raise ValueError(f"paged_attention kernel takes hs in {KERNEL_HS}, got {hs}")
    if t < 1:
        raise ValueError("paged_attention kernel needs at least one chunk query")
    if tables.dim() != 2 or tables.shape[0] != b or not 1 <= n_read <= tables.shape[1]:
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)}, n_read {n_read}")
    if (tables.dtype, lengths.dtype, layer.dtype) != (torch.int32,) * 3 \
            or lengths.shape != (b,) or layer.numel() != 1:
        raise TypeError("paged_attention kernel takes int32 tables (B, W), lengths (B,) "
                        "and a one-element int32 layer index")
    if not (kc.is_contiguous() and vc.is_contiguous() and tables.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("paged_attention kernel needs contiguous pools, tables, lengths")
    if len({x.device for x in (q, kc, vc, k_new, v_new, tables, lengths, layer)}) != 1:
        raise ValueError("paged_attention: tensors on different devices")
    g = hq // hk
    r = t * g
    dev = q.device
    lib = cuda_build.load("paged_attention", _SIGNATURES)
    n_slots = n_read * bt
    bf16 = kc.dtype == torch.bfloat16
    npass, nsplit = split_plan(n_slots, r, b * hk, resident_blocks(
        lib, "paged_attention_blocks_per_sm", bf16, hs, r, dev.index))
    # (B, T, hq, hs) -> (B, hk, T·g, hs): row ti·g + gi of kv head h
    qr = q.float().reshape(b, t, hk, g, hs).permute(0, 2, 1, 3, 4).reshape(b, hk, r, hs)
    qr = qr.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    out = torch.empty(b, hk, r, hs, dtype=torch.float32, device=dev)
    if nsplit > 1:
        part_m = torch.empty(b * hk, nsplit, r, dtype=torch.float32, device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty(b * hk, nsplit, r, hs, dtype=torch.float32, device=dev)
        ptrs = (part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                merge_counters(dev, b * hk * npass).data_ptr())
    else:
        ptrs = (None,) * 4
    scale = float(np.float32(1.0 / math.sqrt(hs)))
    rc = lib.paged_attention(
        qr.data_ptr(), kc.data_ptr(), vc.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), layer.data_ptr(), *ptrs, out.data_ptr(),
        int(bf16), b, hk, r, g, t, hs, n_blocks, bt,
        tables.shape[1], n_slots, nsplit, scale, cuda_build.stream_of(q))
    cuda_build.check(rc, "paged_attention")
    launches += 1
    return out.reshape(b, hk, t, g, hs).permute(0, 2, 1, 3, 4).reshape(b, t, hq, hs)


def paged_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor, layer_idx, *, n_read: int) -> torch.Tensor:
    """Paged attention of T chunk queries per row against block-table KV.

    q: (B, T, hq, hs); kc/vc: (L, N, hk, bt, hs) full stacked pools; k_new/v_new:
    (B, hk, T, hs) the chunk's uncommitted K/V in the pool dtype; tables: (B, W) int32;
    lengths: (B,) int32 committed lengths; layer_idx: int, or a one-element int32 tensor
    on the pools' device (the kernel reads it from there); n_read: table entries to read.
    Returns (B, T, hq, hs) f32."""
    if q.device.type == "cuda":
        if not isinstance(layer_idx, torch.Tensor):
            layer_idx = torch.tensor([layer_idx], dtype=torch.int32, device=q.device)
        return _launch(q, kc, vc, k_new, v_new, tables, lengths, layer_idx, n_read)
    if q.device.type == "cpu":
        return paged_attention_plain(q, kc, vc, k_new, v_new, tables, lengths,
                                     int(layer_idx), n_read=n_read)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")
