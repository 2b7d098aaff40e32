"""Ring attention: causal GQA attention over a sequence-sharded KV cache.

The port's copy of the JAX package's ops/ring_attention.py (sequence parallelism; the
reference keeps the whole seqLen KV slice on every node and shards only heads,
src/commands.cpp:97-102). The cache's sequence axis is sharded over the mesh's sp axis;
each rank attends its local KV block, the blocks rotate around the ring of sp ranks
(parallel/collectives.py ring_shift_start, in place of `ppermute`), and an online
softmax (the flash-attention m / denominator carry) accumulates the output. The next
block's shift is posted before the current block is attended, so the transfer overlaps
the compute.

Every rank holds the whole Q (queries are small; KV is what grows with context), so the
output is replicated over sp and needs no gather. It composes with the tp head split:
a rank's cache is (B, hk/tp, S/sp, hs).

The layout is the JAX package's deferred-write one, STRIPED: rank m's slot j holds
position j·sp + m, which spreads the live context evenly, so a window bucket bounds each
rotation to ceil(window/sp) slots. The contiguous layout serves only the in-scan cache
write, which the port does not run (models/forward.py is deferred-only), so its commit
(update_kv_cache_sharded and the contiguous branch of commit_kv_rows_sharded) is not
here; ring_attention keeps both layouts, as the JAX function does.

Each rank combines the blocks in its own rotation order (owner = (idx + r) % sp, the
JAX package's), so its output matches the JAX member of the same index and may differ
from another rank's in its last bits.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import ring_shift_start

_NEG_INF = -1e30


def _block_attend(qg, k_blk, v_blk, positions, col_offset, col_stride=1, live_end=None):
    """Masked scores and the unnormalized accumulation of one KV block.

    qg: (B, hk, g, T, hs) f32; k_blk/v_blk: (B, hk, Sb, hs); positions: (T,) absolute
    query positions. Block column j sits at absolute position col_offset + col_stride·j
    (contiguous shards: (owner·Sb, 1); striped: (owner, sp)). live_end, where given,
    also masks columns at positions >= live_end: the deferred write attends the cache
    over committed rows only (the chunk comes in as its own register block).
    Returns the partial softmax stats (m (..., T), l (..., T), acc (..., T, hs))."""
    sb = k_blk.shape[2]
    hs = qg.shape[-1]
    scale = 1.0 / math.sqrt(hs)
    scores = torch.einsum("bkgtd,bksd->bkgts", qg, k_blk.float()) * scale
    col_pos = col_offset + col_stride * torch.arange(sb, device=qg.device)
    valid = col_pos[None, :] <= positions[:, None]  # (T, Sb) causal
    if live_end is not None:
        valid = valid & (col_pos[None, :] < live_end)
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1)  # (B, hk, g, T)
    # a fully masked block: exp(NEG_INF - NEG_INF) would be 1, so clamp m
    safe_m = torch.clamp(m, min=_NEG_INF / 2)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgts,bksd->bkgtd", p, v_blk.float())
    return m, l, acc


def _combine(m1, l1, acc1, m2, l2, acc2):
    """Merge two partial softmax accumulations (the flash-attention combine)."""
    m = torch.maximum(m1, m2)
    safe_m = torch.clamp(m, min=_NEG_INF / 2)
    a1 = torch.exp(m1 - safe_m)
    a2 = torch.exp(m2 - safe_m)
    return m, l1 * a1 + l2 * a2, acc1 * a1[..., None] + acc2 * a2[..., None]


def ring_attention(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                   positions: torch.Tensor, *, mesh, live_end=None, chunk=None,
                   striped: bool = False, window_slots: int | None = None) -> torch.Tensor:
    """Causal GQA attention of T query tokens against a sequence-sharded cache.

    q: (B, T, hq, hs), the same on every sp rank; k_shard/v_shard: (B, hk, S/sp, hs),
    this rank's shard; mesh: its Mesh (the sp axis's size, this rank's index and group).
    Layouts: contiguous (rank i holds positions [i·Sb, (i+1)·Sb); every rotation moves
    the whole shard) or striped (rank i's slot j holds position j·sp + i; with a window
    bucket W covering the live context only window_slots = ceil(W/sp) slots take part,
    so each rotation moves W/sp columns).

    live_end (an int or a 0-d tensor): the cache holds committed rows only (positions <
    live_end); chunk = (k_c (B, hk, T, hs), v_c, chunk_start): the step's own K/V,
    attended as one more block folded into the same online softmax, after the ring.
    Returns (B, T, hq·hs) in q's dtype."""
    b, t, hq, hs = q.shape
    _, hk, sb, _ = k_shard.shape
    g = hq // hk
    sp, idx = mesh.sp, mesh.sp_rank
    if window_slots is not None and window_slots < sb:
        if not striped:
            raise ValueError("window_slots only bounds the striped layout")
        k_shard = k_shard[:, :, :window_slots]
        v_shard = v_shard[:, :, :window_slots]
        sb = window_slots
    # (B, hk, g, T, hs): the block attend's subscripts are head-major
    qg = q.reshape(b, t, hk, g, hs).permute(0, 2, 3, 1, 4).float()
    positions = positions.to(q.device)
    m = torch.full((b, hk, g, t), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, t, hs), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k_shard, v_shard
    for r in range(sp):
        owner = (idx + r) % sp  # whose shard this rank holds now
        # post the next rotation before attending this block: the transfer overlaps it
        shift = ring_shift_start([k_blk, v_blk], mesh) if r + 1 < sp else None
        offset, stride = (owner, sp) if striped else (owner * sb, 1)
        mb, lb, ab = _block_attend(qg, k_blk, v_blk, positions, offset, stride,
                                   live_end=live_end)
        m, l, acc = _combine(m, l, acc, mb, lb, ab)
        if shift is not None:
            k_blk, v_blk = shift.wait()
    if chunk is not None:
        k_c, v_c, chunk_start = chunk
        mb, lb, ab = _block_attend(qg, k_c, v_c, positions, chunk_start)
        m, l, acc = _combine(m, l, acc, mb, lb, ab)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, hk, g, T, hs)
    out = out.permute(0, 3, 1, 2, 4)  # (B, T, hk, g, hs)
    return out.reshape(b, t, hq * hs).to(q.dtype)


def commit_kv_rows_striped(k_cache: torch.Tensor, v_cache: torch.Tensor,
                           k_rows: torch.Tensor, v_rows: torch.Tensor, start_pos,
                           *, mesh) -> None:
    """The deferred write of a sequence-sharded, striped cache: every layer's new rows
    in one masked window write per cache, in place (the JAX package's
    commit_kv_rows_sharded with striped=True).

    caches: (L, B, hk, Sb, hs), this rank's shard; rows: (L, B, hk, T, hs), the same on
    every sp rank. This rank (sp index m) takes the chunk positions p with p % sp == m;
    they land in a window of min((T-1)//sp + 2, Sb) slots from slot start_pos // sp,
    clipped into the shard, each slot written only where a chunk token lands (a chunk
    wider than a shard included)."""
    t = k_rows.shape[3]
    sb = k_cache.shape[3]
    sp, idx = mesh.sp, mesh.sp_rank
    dev = k_cache.device
    wl = min((t - 1) // sp + 2, sb)  # the slot window's width
    start = torch.as_tensor(start_pos, dtype=torch.int64, device=dev)
    j0 = torch.clamp(torch.div(start, sp, rounding_mode="floor"), 0, sb - wl)
    slots = j0 + torch.arange(wl, device=dev)
    src = slots * sp + idx - start  # which chunk token lands in each slot
    hit = ((src >= 0) & (src < t))[None, None, None, :, None]
    src_c = torch.clamp(src, 0, t - 1)
    for cache, rows in ((k_cache, k_rows), (v_cache, v_rows)):
        cur = cache.index_select(3, slots)
        gathered = rows.to(cache.dtype).index_select(3, src_c)
        cache.index_copy_(3, slots, torch.where(hit, gathered, cur))
