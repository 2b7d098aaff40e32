"""Grouped-query causal attention of a chunk of T query tokens (reference: the per-head
attention loop, src/llama2-tasks.cpp:54-94).

This is the T>1 attention that the JAX package leaves to XLA; it stays plain torch here
(two batched products and a masked softmax, all in float32). Single-sequence decode (T=1)
runs the decode-attention kernel instead (ops/decode_attention.py), and the batched
serving path the paged-attention kernel (ops/paged_attention.py).

Shapes (batch-first, head-major cache):
    q: (B, T, n_q_heads, hs)     k_cache/v_cache: (B, n_kv_heads, S, hs)
"""

from __future__ import annotations

import math

import torch

from .kernels import masked_softmax


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  positions: torch.Tensor,
                  key_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA attention of T query tokens against the given keys.

    positions: absolute query positions, (T,) shared across the batch or (B, T) per row
    (continuous batching: each row decodes at its own offset). key_positions: absolute
    position of each key slot, (S,) or per row (B, S); defaults to arange(S). The
    deferred-cache-write path passes [window slots ++ current-chunk positions] with stale
    slots pushed past seq_len, so the causal compare masks them. Returns
    (B, T, n_q_heads * hs) in q's dtype."""
    b, t, hq, hs = q.shape
    _, hk, s, _ = k_cache.shape
    g = hq // hk
    qg = q.reshape(b, t, hk, g, hs)
    scale = 1.0 / math.sqrt(hs)
    scores = torch.einsum("btkgd,bksd->bkgts", qg.float(), k_cache.float()) * scale
    if key_positions is None:
        key_positions = torch.arange(s, device=q.device)
    if positions.dim() == 1:
        assert key_positions.dim() == 1
        mask = (key_positions[None, :] <= positions[:, None])[None, None, None]  # (T, S)
    else:
        kp = key_positions if key_positions.dim() == 2 else key_positions[None, :]
        mask = (kp[:, None, :] <= positions[:, :, None])[:, None, None]  # (B, T, S)
    probs = masked_softmax(scores, mask)
    out = torch.einsum("bkgts,bksd->btkgd", probs, v_cache.float())
    return out.reshape(b, t, hq * hs).to(q.dtype)
