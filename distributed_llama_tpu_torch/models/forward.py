"""Transformer forward pass for the dense Llama architecture (reference:
src/llama2-tasks.cpp:241-298).

The counterpart of the JAX package's models/forward.py on its dense branch with the
deferred cache write and a scalar start_pos: pre-norm attention + SwiGLU FFN (w1=gate,
w3=up, w2=down), layers run as a Python loop over the stacked parameters.

Deferred write: every layer's attention reads only the COMMITTED cache slots
(< start_pos) plus the chunk's own k/v; the chunk's rows of all layers are written into
the caches after the last layer. The caches are updated in place (the JAX package
returns new arrays; here the write lands in the caller's tensors, which are also
returned).

Kernel paths (use_kernels): decode projections and the logits take kernel 1
(ops/q4_matvec.py), T=1 attention takes kernel 3 (ops/decode_attention.py), and with
use_kernels == "all" the prefill projections take kernel 2 (ops/q4_matmul.py).
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.attention import gqa_attention
from ..ops.decode_attention import decode_attention
from ..ops.kernels import gelu_tanh, rmsnorm, silu
from ..ops.matmul import qmatmul
from ..ops.rope import RopeTables, apply_rope
from ..quants import QTensor
from .spec import ArchType, HiddenAct, ModelSpec


def _act(spec: ModelSpec):
    return silu if spec.hidden_act == HiddenAct.SILU else gelu_tanh


def layer_params(blocks: dict[str, Any], li: int) -> dict[str, Any]:
    """Layer li's slice of the stacked block params (views, no copies)."""
    out = {}
    for name, t in blocks.items():
        if isinstance(t, QTensor):
            out[name] = QTensor(t.ftype, t.data[li],
                                None if t.scales is None else t.scales[li],
                                t.layout, t.groups, t.row_groups)
        else:
            out[name] = t[li]
    return out


def _attention(x, bp, layer_idx: int, spec: ModelSpec, rope: RopeTables, kc, vc,
               start_pos: int, positions, use_kernels, window, residual):
    """Attention sub-block against the full stacked caches (L, 1, hk, S, hs). Returns
    (residual + attention output, (k_t, v_t)) where k_t/v_t are the chunk's new rows
    (B, hk, T, hs) for forward() to commit."""
    b, t, _ = x.shape
    hs = spec.head_size
    _, _, hk, s, _ = kc.shape
    xb = rmsnorm(x, bp["rms_att"], spec.norm_eps)
    if "wqkv" in bp:
        # merged QKV: one launch for the three projections, rows split dim : kv : kv
        qkv = qmatmul(xb, bp["wqkv"], use_kernels=use_kernels)
        total = qkv.shape[-1]
        lq = total * spec.dim // (spec.dim + 2 * spec.kv_dim)
        lkv = (total - lq) // 2
        q = qkv[..., :lq]
        k = qkv[..., lq:lq + lkv]
        v = qkv[..., lq + lkv:]
    else:
        q = qmatmul(xb, bp["wq"], use_kernels=use_kernels)
        k = qmatmul(xb, bp["wk"], use_kernels=use_kernels)
        v = qmatmul(xb, bp["wv"], use_kernels=use_kernels)
    hq = q.shape[-1] // hs
    q = apply_rope(q.reshape(b, t, hq, hs), rope, positions)
    k = apply_rope(k.reshape(b, t, hk, hs), rope, positions)
    v = v.reshape(b, t, hk, hs)
    k_t = k.transpose(1, 2).to(kc.dtype)  # (B, hk, T, hs)
    v_t = v.transpose(1, 2).to(vc.dtype)
    win = window or s
    if use_kernels and t == 1 and b == 1:
        out = decode_attention(q.reshape(hk, hq // hk, hs).float(), kc, vc, k_t[0], v_t[0],
                               layer_idx, start_pos, window=win)
        att = out.reshape(1, 1, hq * hs).to(x.dtype)
    else:
        kw = kc[layer_idx, :, :, :win]  # (B, hk, win, hs)
        vw = vc[layer_idx, :, :, :win]
        # window slot j holds a committed row iff j < start_pos; stale slots get a
        # past-seq_len position so the causal compare masks them
        slot = torch.arange(win, device=x.device)
        slot_pos = torch.where(slot < start_pos, slot, torch.full_like(slot, s + 1))
        key_pos = torch.cat([slot_pos, positions])
        att = gqa_attention(q, torch.cat([kw, k_t], dim=2), torch.cat([vw, v_t], dim=2),
                            positions, key_positions=key_pos)
    y = qmatmul(att, bp["wo"], use_kernels=use_kernels)
    return residual + y, (k_t, v_t)


def _dense_ffn(x, bp, spec: ModelSpec, use_kernels, residual):
    """Dense FFN on the pre-norm block input; returns residual + ffn(x)."""
    act = _act(spec)
    xb = rmsnorm(x, bp["rms_ffn"], spec.norm_eps)
    if "w13" in bp:
        # merged gate+up: [gate | up] rows, act(gate) * up
        y = qmatmul(xb, bp["w13"], use_kernels=use_kernels)
        hl = y.shape[-1] // 2
        h = act(y[..., :hl]) * y[..., hl:]
    else:
        h = (act(qmatmul(xb, bp["w1"], use_kernels=use_kernels))
             * qmatmul(xb, bp["w3"], use_kernels=use_kernels))
    out = qmatmul(h.to(x.dtype), bp["w2"], use_kernels=use_kernels)
    return residual + out


def forward(params: dict[str, Any], spec: ModelSpec, rope: RopeTables,
            tokens: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            start_pos: int, *, dtype=torch.float32, use_kernels: bool | str = False,
            attn_window: int | None = None):
    """Run T tokens through the model at cache position start_pos.

    tokens: (1, T) integer tensor; k_cache/v_cache: (L, 1, hk, S, hs). attn_window bounds
    the cache positions attention reads (must cover start_pos + T; None = all of S).
    Returns (logits (1, T, vocab) f32, k_cache, v_cache) with the chunk's rows committed
    in place at [start_pos, start_pos + T)."""
    if spec.arch_type != ArchType.LLAMA or spec.is_moe:
        raise NotImplementedError("the port runs the dense Llama architecture only")
    t = tokens.shape[1]
    positions = start_pos + torch.arange(t, device=tokens.device)
    x = params["embedding"][tokens].to(dtype)
    k_rows, v_rows = [], []
    for li in range(spec.n_layers):
        bp = layer_params(params["blocks"], li)
        x, (k_t, v_t) = _attention(x, bp, li, spec, rope, k_cache, v_cache, start_pos,
                                   positions, use_kernels, attn_window, residual=x)
        x = _dense_ffn(x, bp, spec, use_kernels, residual=x)
        k_rows.append(k_t)
        v_rows.append(v_t)
    # commit all layers' new rows: (L, B, hk, T, hs) at [.., start_pos:start_pos+T, ..]
    k_cache[:, :, :, start_pos:start_pos + t] = torch.stack(k_rows)
    v_cache[:, :, :, start_pos:start_pos + t] = torch.stack(v_rows)
    x = rmsnorm(x, params["rms_final"], spec.norm_eps)
    logits = qmatmul(x, params["wcls"], use_kernels=use_kernels, out_dtype=torch.float32)
    return logits, k_cache, v_cache


def init_kv_cache(spec: ModelSpec, batch: int = 1, dtype=torch.float32, device="cpu",
                  seq_len: int | None = None):
    """Zeroed head-major KV caches (L, B, hk, S, hs)."""
    s = seq_len if seq_len is not None else spec.seq_len
    shape = (spec.n_layers, batch, spec.n_kv_heads, s, spec.head_size)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
