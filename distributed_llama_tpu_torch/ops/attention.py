"""Grouped-query causal attention of a chunk of T query tokens (reference: the per-head
attention loop, src/llama2-tasks.cpp:54-94).

This is the T>1 attention that the JAX package leaves to XLA; it stays plain torch here
(two batched products and a masked softmax, all in float32). Single-sequence decode (T=1)
runs the decode-attention kernel instead (ops/decode_attention.py), and the batched
serving path the paged-attention kernel (ops/paged_attention.py).

`gqa_attention_lse` and `merge_attention_partials` are the flash-attention segment form
the host KV spill (runtime/paged_cache.py) uses to merge the device hot ring's partial
with the host's cold-history partial; plain torch in float32, as the JAX package leaves
them to XLA.

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


def gqa_attention_lse(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, key_positions: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """gqa_attention that also returns the log-sum-exp of the masked scores: a softmax
    over keys split into segments equals merge_attention_partials() of each segment's
    (normalized output, lse).

    Returns (out (B, T, hq, hs) f32, lse (B, T, hq) f32); a fully masked row gives out 0
    and lse -inf (a zero-weight segment under the merge)."""
    b, t, hq, hs = q.shape
    _, hk, s, _ = k_cache.shape
    g = hq // hk
    qg = q.reshape(b, t, hk, g, hs)
    scale = 1.0 / math.sqrt(hs)
    scores = torch.einsum("btkgd,bksd->bkgts", qg.float(), k_cache.float()) * scale
    if key_positions is None:
        key_positions = torch.arange(s, device=q.device)
    if positions.dim() == 1:
        mask = (key_positions[None, :] <= positions[:, None])[None, None, None]
    else:
        kp = key_positions if key_positions.dim() == 2 else key_positions[None, :]
        mask = (kp[:, None, :] <= positions[:, :, None])[:, None, None]
    neg = torch.finfo(torch.float32).min
    sm = torch.where(mask, scores, neg)
    m = sm.amax(dim=-1)  # (B, hk, g, T)
    e = torch.where(mask, torch.exp(sm - m[..., None]), 0.0)
    denom = e.sum(dim=-1)  # (B, hk, g, T)
    out = torch.einsum("bkgts,bksd->btkgd", e, v_cache.float())
    l_t = denom.permute(0, 3, 1, 2)  # (B, T, hk, g)
    m_t = m.permute(0, 3, 1, 2)
    out = out / torch.clamp(l_t, min=1e-30)[..., None]
    lse = torch.where(l_t > 0.0, m_t + torch.log(torch.clamp(l_t, min=1e-30)),
                      -torch.inf)
    return out.reshape(b, t, hq, hs), lse.reshape(b, t, hq)


def merge_attention_partials(out_a: torch.Tensor, lse_a: torch.Tensor,
                             out_b: torch.Tensor, lse_b: torch.Tensor) -> torch.Tensor:
    """The exact full-softmax output of two attention segments' (normalized output,
    lse): the weights re-derive from exp(lse_i - max), an empty segment (lse -inf)
    weighs zero, and two empty segments give zeros. out_*: (..., hs), lse_*: (...)."""
    m = torch.maximum(lse_a, lse_b)
    m = torch.where(torch.isfinite(m), m, 0.0)  # both segments empty: output zeros
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    den = torch.clamp(wa + wb, min=1e-30)[..., None]
    return (out_a * wa[..., None] + out_b * wb[..., None]) / den
