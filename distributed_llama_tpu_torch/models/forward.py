"""Transformer forward pass for Llama, Mixtral and Grok-1 (reference:
src/llama2-tasks.cpp:241-298, src/mixtral-tasks.cpp:5-78, src/grok1-tasks.cpp:275-354).

The counterpart of the JAX package's models/forward.py with the deferred cache write,
layers run as a Python loop over the stacked parameters:
- LLAMA: pre-norm attention + SwiGLU FFN (w1=gate, w3=up, w2=down);
- MIXTRAL: attention as llama; the FFN is a top-k-of-E MoE (router softmax over all
  experts, top-k renormalized, hb_e = up_e(x) * act(gate_e(x)), out = sum_j w_j ·
  down_e(hb_e));
- GROK1: embedding x GROK_EMBEDDING_SCALE; the attention output is rmsnorm'd (rms_ffn)
  before its residual join; the MoE input norm is rms_moe and its output is rmsnorm'd
  (rms_ffn2) before its join; logits x GROK_LOGITS_SCALE; GELU-tanh.

The MoE FFN (`_moe_ffn`) takes the JAX package's three routes by the same gates: one
row with the kernels on runs the k chosen experts through the matvecs' expert entries
(the index stays on the device: a captured step replays with each step's experts); up
to n_experts token-expert pairs gather and dequantize the chosen experts; more run the
expert-major loop over all E experts, each masked by its routing weights.

Deferred write: every layer's attention reads only the COMMITTED cache slots
(< start_pos) plus the chunk's own k/v; the chunk's rows of all layers are written into
the caches after the last layer. The caches are updated in place (the JAX package
returns new arrays; here the write lands in the caller's tensors, which are also
returned).

Four cache layouts, as in the JAX package:
- dense, scalar start_pos: (L, 1, hk, S, hs), one sequence (runtime/engine.py);
- dense, per-row start_pos (B,): (L, B, hk, S, hs), each row at its own offset;
- block pool, per-row start_pos and (B, W) block tables: (L, N, hk, bt, hs), position p
  of row b in block tables[b, p // bt] at offset p % bt (the batched serving path,
  runtime/batch_engine.py);
- hot ring, scalar start_pos and `paged_cold`: (L, 1, hk, R, hs), position p in slot
  p mod R; attention over the ring is merged with the host's partial over the older
  history (the host KV spill, runtime/paged_cache.py).

Kernel paths (use_kernels): decode projections and the logits take kernel 1
(ops/q4_matvec.py), one-sequence T=1 attention takes kernel 3 (ops/decode_attention.py),
the pool layout's attention takes kernel 9 (ops/paged_attention.py) under
`paged_kernel`, and with use_kernels in ("all", "fused") the M > 1 projections take
kernel 2 (ops/q4_matmul.py); "fused" adds the residual mode (kernel 4) for wo and w2 and
the gate-pair kernel 5 (ops/q4_gated_matmul.py) for separate w1/w3. i8 weights (Q80,
and Q40 that fails the i4p alignment) take q8_matvec (ops/q8_matvec.py) at one row. A
one-row MoE step's experts take the expert entries of both (`qmatmul(expert=)`).

The fused activation prologue (`fused_prologue`, single-row decode with the kernels on):
each layer's rmsnorm and the Q80 quantization of its row run as one kernel
(ops/prologue.py) before the QKV and gate/up projections, the attention output and the
FFN hidden are quantized by the prologue's second kernel before wo and w2, and the
projections take the quantized rows (`qmatmul_q80`); the residual is added outside.

Tensor parallelism (`mesh`, parallel/): each rank runs this function on its own shard of
the weights (parallel/tp.py shard_params) and caches (its KV heads). The partial sums of
the column-split projections are reduced where the reference's root merged the slices and
where the JAX package calls psum: after wo, after w2 and after the MoE down projection
(parallel/collectives.py psum, through the Q80 wire with `compress_collectives`), and the
vocab-split logits are gathered along their last axis. The reduction comes before the
residual join, so the wo and w2 kernels' residual epilogue is off whenever the merge
points are on. Attention runs on the rank's heads; the router, the norms and rope are
replicated.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.attention import gqa_attention, gqa_attention_lse, merge_attention_partials
from ..ops.decode_attention import decode_attention
from ..ops.kernels import gelu_tanh, rmsnorm, silu
from ..ops.matmul import qmatmul, qmatmul_gated, qmatmul_q80
from ..ops.paged_attention import paged_attention, paged_gather_kv
from ..ops.prologue import prologue_supported, quantize_q80_row, rmsnorm_quantize_q80
from ..ops.rope import RopeTables, apply_rope
from ..parallel.collectives import all_gather_last, psum
from ..quants import QTensor
from .spec import ArchType, HiddenAct, ModelSpec


GROK_EMBEDDING_SCALE = 78.38367176906169  # grok1-tasks.cpp:13
GROK_LOGITS_SCALE = 0.5773502691896257  # grok1-tasks.cpp:272


def _act(spec: ModelSpec):
    return silu if spec.hidden_act == HiddenAct.SILU else gelu_tanh


def _act_name(spec: ModelSpec) -> str:
    """Activation name for the gate-pair kernel's epilogue."""
    return "silu" if spec.hidden_act == HiddenAct.SILU else "gelu_tanh"


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


class _Step:
    """What every layer of one forward call shares: the start positions, the paging
    tables and the kernel switches."""

    def __init__(self, spec, rope, start_pos, positions, use_kernels, window,
                 block_tables, block_tokens, paged_kernel, lengths, layer_ids, prologue,
                 paged_cold=None, mesh=None, compress=False):
        self.spec = spec
        self.rope = rope
        self.start_pos = start_pos  # int, 0-d int64 tensor, or (B,) int64 tensor
        self.positions = positions  # (T,) or (B, T) int64
        self.use_kernels = use_kernels
        self.window = window
        self.block_tables = block_tables
        self.block_tokens = block_tokens
        self.paged_kernel = paged_kernel
        self.lengths = lengths  # (B,) int32 on the device, for the paged kernel
        self.layer_ids = layer_ids  # (L,) int32 on the device, for the attention kernels
        self.prologue = prologue  # the fused activation prologue is on for this step
        self.paged_cold = paged_cold  # the host's cold-history partial (hot-ring layout)
        self.per_row = isinstance(start_pos, torch.Tensor) and start_pos.ndim == 1
        self.mesh = mesh  # the tp merge points are on (parallel/), or None
        self.compress = compress  # the merge points reduce through the Q80 wire

    def merge(self, y: torch.Tensor) -> torch.Tensor:
        """A tp merge point: the sum of every rank's partial y (y itself without a
        mesh)."""
        return y if self.mesh is None else psum(y, self.mesh, self.compress)


def _attention(x, bp, layer_idx: int, st: _Step, kc, vc, residual):
    """Attention sub-block against the full stacked caches or pools. Returns
    (residual + attention output, (k_t, v_t)) where k_t/v_t are the chunk's new rows
    (B, hk, T, hs) for forward() to commit; with residual None (Grok-1, which joins the
    normalized output) the attention output alone."""
    spec = st.spec
    b, t, _ = x.shape
    hs = spec.head_size
    hk = kc.shape[2]
    use_kernels = st.use_kernels
    if st.prologue:
        # one kernel normalizes and quantizes the row; the projections take it quantized
        xq, sx = rmsnorm_quantize_q80(x, bp["rms_att"], spec.norm_eps)

        def project(name):
            return qmatmul_q80(xq, sx, bp[name], use_kernels=use_kernels, out_dtype=x.dtype)
    else:
        xb = rmsnorm(x, bp["rms_att"], spec.norm_eps)

        def project(name):
            return qmatmul(xb, bp[name], use_kernels=use_kernels)
    if "wqkv" in bp:
        # merged QKV: one launch for the three projections, rows split dim : kv : kv
        qkv = project("wqkv")
        total = qkv.shape[-1]
        lq = total * spec.dim // (spec.dim + 2 * spec.kv_dim)
        lkv = (total - lq) // 2
        q = qkv[..., :lq]
        k = qkv[..., lq:lq + lkv]
        v = qkv[..., lq + lkv:]
    else:
        q = project("wq")
        k = project("wk")
        v = project("wv")
    hq = q.shape[-1] // hs
    q = apply_rope(q.reshape(b, t, hq, hs), st.rope, st.positions)
    k = apply_rope(k.reshape(b, t, hk, hs), st.rope, st.positions)
    v = v.reshape(b, t, hk, hs)
    k_t = k.transpose(1, 2).to(kc.dtype)  # (B, hk, T, hs)
    v_t = v.transpose(1, 2).to(vc.dtype)
    start = st.start_pos
    paged = st.block_tables is not None
    if paged:
        bt = st.block_tokens
        w_total = st.block_tables.shape[1]
        nb = min(-(-(st.window or w_total * bt) // bt), w_total)  # table entries read
    else:
        win = st.window or kc.shape[3]
    if st.paged_cold is not None:
        att = _ring_attention(q, k_t, v_t, kc[layer_idx], vc[layer_idx], layer_idx, st)
        att = att.reshape(b, t, hq * hs).to(x.dtype)
    elif paged and st.paged_kernel:
        # the kernel reads the table's blocks straight out of the pools
        li = st.layer_ids[layer_idx:layer_idx + 1] if x.is_cuda else layer_idx
        out = paged_attention(q.float(), kc, vc, k_t, v_t, st.block_tables, st.lengths,
                              li, n_read=nb)
        att = out.reshape(b, t, hq * hs).to(x.dtype)
    elif not paged and use_kernels and t == 1 and b == 1 and not st.per_row:
        # on the card the kernel reads the position and the layer from device memory
        # (the step's positions, the layer ids): the step copies nothing to the device
        if x.is_cuda:
            pos, li = st.positions[:1], st.layer_ids[layer_idx:layer_idx + 1]
        else:
            pos, li = start, layer_idx
        out = decode_attention(q.reshape(hk, hq // hk, hs).float(), kc, vc, k_t[0],
                               v_t[0], li, pos, window=win)
        att = out.reshape(1, 1, hq * hs).to(x.dtype)
    else:
        if paged:  # gather the table's blocks into the dense window layout
            kw, vw = paged_gather_kv(kc, vc, layer_idx, st.block_tables, nb)
        else:
            kw = kc[layer_idx, :, :, :win]  # (B, hk, win, hs)
            vw = vc[layer_idx, :, :, :win]
        # window slot j holds a committed row iff j < start_pos (per row for a tensor
        # start); stale, scratch or garbage slots get a past-seq_len position so the
        # causal compare masks them
        slot = torch.arange(kw.shape[2], device=x.device)
        past = torch.full_like(slot, spec.seq_len + 1)
        if not st.per_row:
            key_pos = torch.cat([torch.where(slot < start, slot, past), st.positions])
        else:  # (B, win) per-row offsets (continuous batching)
            key_pos = torch.cat([torch.where(slot[None, :] < start[:, None], slot, past),
                                 st.positions], dim=1)
        att = gqa_attention(q, torch.cat([kw, k_t], dim=2), torch.cat([vw, v_t], dim=2),
                            st.positions, key_positions=key_pos)
    if st.prologue and prologue_supported(att.shape[-1]):
        # the attention output is quantized by the prologue's kernel, not in the matvec
        aq, asx = quantize_q80_row(att)
        y = qmatmul_q80(aq, asx, bp["wo"], use_kernels=use_kernels, out_dtype=x.dtype)
    elif use_kernels == "fused" and st.mesh is None:
        # the residual add runs in the wo kernel's f32 epilogue (tp partials are reduced
        # before the join, so only without merge points)
        return qmatmul(att, bp["wo"], use_kernels=use_kernels, residual=residual), (k_t, v_t)
    else:
        y = qmatmul(att, bp["wo"], use_kernels=use_kernels)
    y = st.merge(y)
    return (y if residual is None else residual + y), (k_t, v_t)


def _ring_attention(q, k_t, v_t, kl, vl, layer_idx: int, st: _Step):
    """Attention of the chunk against the hot ring (B, hk, R, hs) plus the host's cold
    partial, merged by log-sum-exp. Slot j's newest committed position is
    p_j = j + R·floor((start - 1 - j) / R) (< start by construction; negative: never
    written, masked), so the committed ring covers [max(0, start - R), start) and the
    host segment [0, max(0, start - R)), with no overlap. Returns (B, T, hq, hs) f32."""
    start = st.start_pos
    r = kl.shape[2]
    slot = torch.arange(r, device=q.device)
    # a floor quotient: a truncated one would label a never-written slot committed
    p_j = slot + r * torch.div(start - 1 - slot, r, rounding_mode="floor")
    key_pos = torch.cat([torch.where(p_j >= 0, p_j, torch.full_like(p_j, 1 << 30)),
                         st.positions])
    out_h, lse_h = gqa_attention_lse(q, torch.cat([kl, k_t], dim=2),
                                     torch.cat([vl, v_t], dim=2), st.positions,
                                     key_positions=key_pos)
    out_c, lse_c = st.paged_cold(layer_idx, q.float(), start)
    return merge_attention_partials(out_h, lse_h, out_c.to(out_h.device),
                                    lse_c.to(out_h.device))


def _dense_ffn(x, bp, spec: ModelSpec, use_kernels, residual, prologue: bool = False,
               merge=None):
    """Dense FFN on the pre-norm block input; returns residual + ffn(x). Under the
    prologue the gate/up projections take the normalized row quantized by one kernel and
    come out in f32, and the hidden row is quantized by the prologue's kernel before w2.
    `merge` (a _Step's merge, with a tp mesh) reduces the w2 partials before the join."""
    act = _act(spec)
    if prologue:
        xq, sx = rmsnorm_quantize_q80(x, bp["rms_ffn"], spec.norm_eps)

        def project(name):
            return qmatmul_q80(xq, sx, bp[name], use_kernels=use_kernels,
                               out_dtype=torch.float32)
        if "w13" in bp:
            h = _gated_split(project("w13"), act, gate_first=True)
        else:
            h = act(project("w1")) * project("w3")
    else:
        xb = rmsnorm(x, bp["rms_ffn"], spec.norm_eps)
        if "w13" in bp:
            h = _gated_split(qmatmul(xb, bp["w13"], use_kernels=use_kernels), act,
                             gate_first=True)
        else:
            # separate w1/w3: under "fused" one gate-pair kernel launch
            h = qmatmul_gated(xb, bp["w1"], bp["w3"], act=act, act_name=_act_name(spec),
                              use_kernels=use_kernels)
    if prologue and prologue_supported(h.shape[-1]):
        hq, hsx = quantize_q80_row(h)
        out = qmatmul_q80(hq, hsx, bp["w2"], use_kernels=use_kernels, out_dtype=x.dtype)
    elif use_kernels == "fused" and merge is None:
        return qmatmul(h.to(x.dtype), bp["w2"], use_kernels=use_kernels, residual=residual)
    else:
        out = qmatmul(h.to(x.dtype), bp["w2"], use_kernels=use_kernels)
    return residual + (out if merge is None else merge(out))


def _gated_split(y, act, gate_first: bool):
    """Gated-FFN combine of a merged projection's halves: w13 is [gate | up]
    (act(first) * second), moe_gu is [up | gate] (first * act(second))."""
    hl = y.shape[-1] // 2
    a, b = y[..., :hl], y[..., hl:]
    return act(a) * b if gate_first else a * act(b)


def _expert_out(xb, bp, e, act, use_kernels):
    """Expert e's output down(up(x) * act(gate(x))), from the merged [up | gate] stack or
    the separate pair; e a Python int or a one-element index tensor (`qmatmul`)."""
    def project(x, w):
        return qmatmul(x, w, use_kernels=use_kernels, expert=e)
    if "moe_gu" in bp:
        hb = _gated_split(project(xb, bp["moe_gu"]), act, gate_first=False)
    else:
        hb = project(xb, bp["moe_up"]) * act(project(xb, bp["moe_gate"]))
    return project(hb, bp["moe_down"])


def _gather_expert(w: QTensor, idx: torch.Tensor) -> QTensor:
    """The experts idx (B, T, K) of a stacked QTensor (E, out, in) -> (B, T, K, out, in)."""
    return QTensor(w.ftype, w.data[idx], None if w.scales is None else w.scales[idx],
                   w.layout, w.groups, w.row_groups)


def _route(xb, bp, spec: ModelSpec):
    """The router: f32 logits, softmax over ALL experts, the top k, renormalized
    (grokMoeNormWeights). The top k come from a stable descending sort, so ties go to
    the lower expert index first, as jax.lax.top_k orders them. Returns (top_i (B, T, K)
    int64, weights (B, T, K) f32)."""
    logits = qmatmul(xb, bp["router"], use_kernels=False).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :spec.n_active_experts], top_i[..., :spec.n_active_experts]
    return top_i, top_p / top_p.sum(dim=-1, keepdim=True)


def _moe_ffn(xb, bp, spec: ModelSpec, use_kernels):
    """Top-k MoE FFN on the normalized block input xb (grokMoeRouter..grokMoeBlock2,
    grok1-tasks.cpp:56-228), by the JAX package's gates:
    (a) one row with the kernels on and i4p/i8 stacks: the k experts in top-k order
        through the matvecs' expert entries, out += out_e · w_j;
    (b) b·t·k <= n_experts: gather the chosen experts, dequantize, einsum;
    (c) otherwise: expert-major over all E experts, each expert's rows weighted by its
        routing weight (zero where a token did not choose it), summed in expert order."""
    b, t, _ = xb.shape
    k = spec.n_active_experts
    act = _act(spec)
    top_i, weights = _route(xb, bp, spec)
    merged = "moe_gu" in bp
    stack = bp["moe_gu"] if merged else bp["moe_up"]
    if use_kernels and b * t == 1 and stack.layout in ("i4p", "i8"):
        # the expert index stays on the device: each entry reads it from top_i
        out = torch.zeros_like(xb)
        idx, wts = top_i.reshape(k), weights.reshape(k)
        for j in range(k):
            out = out + _expert_out(xb, bp, idx[j:j + 1], act, True) * wts[j].to(xb.dtype)
        return out
    if b * t * k <= spec.n_experts:
        down_w = _gather_expert(bp["moe_down"], top_i).dequantize(dtype=xb.dtype)
        if merged:
            gu_w = _gather_expert(bp["moe_gu"], top_i).dequantize(dtype=xb.dtype)
            hb = _gated_split(torch.einsum("btd,btkhd->btkh", xb, gu_w), act,
                              gate_first=False)
        else:
            up_w = _gather_expert(bp["moe_up"], top_i).dequantize(dtype=xb.dtype)
            gate_w = _gather_expert(bp["moe_gate"], top_i).dequantize(dtype=xb.dtype)
            hb = (torch.einsum("btd,btkhd->btkh", xb, up_w)
                  * act(torch.einsum("btd,btkhd->btkh", xb, gate_w)))
        out = torch.einsum("btkh,btkdh->btkd", hb, down_w)
        return torch.einsum("btkd,btk->btd", out, weights.to(xb.dtype))
    experts = torch.arange(spec.n_experts, device=xb.device)
    one_hot = (top_i[..., None] == experts).to(xb.dtype)  # (B, T, K, E)
    combine = torch.einsum("btke,btk->ebt", one_hot, weights.to(xb.dtype))
    acc = torch.zeros_like(xb)
    for e in range(stack.shape[0]):  # a Python int: a view, the kernel routes of M > 1
        acc = acc + _expert_out(xb, bp, e, act, use_kernels) * combine[e][..., None]
    return acc


def _block(x, bp, li: int, st: _Step, kc, vc):
    """One transformer block; returns (x, (k_t, v_t))."""
    spec = st.spec
    if spec.arch_type == ArchType.GROK1:
        # the NORMALIZED attention output joins the residual, so wo takes none
        attn_out, kv = _attention(x, bp, li, st, kc, vc, residual=None)
        x = x + rmsnorm(attn_out, bp["rms_ffn"], spec.norm_eps)
        xb = rmsnorm(x, bp["rms_moe"], spec.norm_eps)
        moe_out = st.merge(_moe_ffn(xb, bp, spec, st.use_kernels))
        return x + rmsnorm(moe_out, bp["rms_ffn2"], spec.norm_eps), kv
    x, kv = _attention(x, bp, li, st, kc, vc, residual=x)
    if spec.is_moe:
        xb = rmsnorm(x, bp["rms_ffn"], spec.norm_eps)
        return x + st.merge(_moe_ffn(xb, bp, spec, st.use_kernels)), kv
    return _dense_ffn(x, bp, spec, st.use_kernels, residual=x, prologue=st.prologue,
                      merge=None if st.mesh is None else st.merge), kv


def forward(params: dict[str, Any], spec: ModelSpec, rope: RopeTables,
            tokens: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            start_pos, *, dtype=torch.float32, use_kernels: bool | str = False,
            attn_window: int | None = None, block_tables: torch.Tensor | None = None,
            block_tokens: int = 0, paged_kernel: bool = False,
            fused_prologue: bool = False, paged_cold=None, mesh=None,
            compress_collectives: bool = False):
    """Run T tokens through the model at cache position start_pos.

    tokens: (B, T) integer tensor. start_pos: one offset for all rows — an int, or a
    0-d integer tensor on the device (a captured step reads its position from there; the
    commit writes through a device index) — or a (B,) integer tensor of per-row offsets
    (continuous batching). k_cache/v_cache: dense
    (L, B, hk, S, hs) caches, or with block_tables ((B, W) int32 tensor, per-row
    start_pos required) (L, N, hk, bt, hs) pools with bt = block_tokens. attn_window
    bounds the positions attention reads (must cover start_pos + T; None = all).
    paged_kernel routes the pool layout's attention through kernel 9. fused_prologue
    turns the fused activation prologue on where it applies, as the JAX package gates
    it: kernels on, one row of one token at one start_pos for all rows, and a model width
    the prologue kernels take.

    paged_cold (the host KV spill, runtime/paged_cache.py): the caches are the hot ring
    (L, 1, hk, R, hs) of the R newest positions, and paged_cold(layer, q (B, T, hq, hs)
    f32, start_pos) -> (out, lse) gives attention's partial over the older history. It
    needs a scalar start_pos and T <= R; the chunk's rows commit into slots
    (start_pos + arange(T)) mod R, and forward also returns them for the host store.

    Rows of a mixed batch need not use all T positions: a decode row in a (B, T) prefill
    step puts its one real token at index 0 and scratch beyond; causal masking confines
    token 0's attention to the row's committed history plus itself, and the scratch
    writes land on positions > start_pos that every read masks until the row's own later
    tokens overwrite them.

    mesh (parallel/mesh.py): this rank's tp mesh, its params a shard (parallel/tp.py) and
    its caches its KV heads; the merge points reduce over it, through the Q80 wire with
    compress_collectives. None runs one card's model with no merge points (also what a
    one-member mesh without compression means: parallel/tp.py make_sharded_forward).

    Returns (logits (B, T, vocab) f32, k_cache, v_cache) with the chunk's rows committed
    in place; with paged_cold also (k_rows, v_rows), the chunk's rows (L, B, hk, T, hs)."""
    dev = tokens.device
    t = tokens.shape[1]
    per_row = isinstance(start_pos, torch.Tensor) and start_pos.ndim == 1
    if block_tables is not None and not (per_row and block_tokens >= 1):
        raise ValueError("the block-pool layout needs block_tokens and per-row start_pos")
    if paged_cold is not None and (per_row or block_tables is not None
                                   or t > k_cache.shape[3]):
        raise ValueError(f"the hot-ring layout needs a scalar start_pos, dense caches and "
                         f"a chunk within the {k_cache.shape[3]}-slot ring (T = {t})")
    lengths = layer_ids = None
    if per_row:
        lengths = start_pos.to(device=dev, dtype=torch.int32)
        start_pos = start_pos.to(device=dev, dtype=torch.int64)
        positions = start_pos[:, None] + torch.arange(t, device=dev)[None, :]  # (B, T)
        if block_tables is not None and paged_kernel and tokens.is_cuda:
            layer_ids = torch.arange(spec.n_layers, dtype=torch.int32, device=dev)
    else:
        if isinstance(start_pos, torch.Tensor):
            start_pos = start_pos.to(device=dev, dtype=torch.int64)
        positions = start_pos + torch.arange(t, device=dev)
        if use_kernels and t == 1 and tokens.shape[0] == 1 and tokens.is_cuda:
            layer_ids = torch.arange(spec.n_layers, dtype=torch.int32, device=dev)
    prologue = bool(fused_prologue and use_kernels and t == 1 and tokens.shape[0] == 1
                    and not per_row and prologue_supported(spec.dim))
    st = _Step(spec, rope, start_pos, positions, use_kernels, attn_window, block_tables,
               block_tokens, paged_kernel, lengths, layer_ids, prologue, paged_cold, mesh,
               compress_collectives)
    x = params["embedding"][tokens].to(dtype)
    if spec.arch_type == ArchType.GROK1:
        # the scale in x's dtype, as the JAX package's weakly typed constant
        x = x * torch.tensor(GROK_EMBEDDING_SCALE, dtype=dtype)
    k_rows, v_rows = [], []
    for li in range(spec.n_layers):
        bp = layer_params(params["blocks"], li)
        x, (k_t, v_t) = _block(x, bp, li, st, k_cache, v_cache)
        k_rows.append(k_t)
        v_rows.append(v_t)
    # commit all layers' new rows: (L, B, hk, T, hs)
    k_new, v_new = torch.stack(k_rows), torch.stack(v_rows)
    if block_tables is not None:
        commit_paged(k_cache, v_cache, k_new, v_new, positions, block_tables,
                     block_tokens)
    elif paged_cold is not None:
        # ring commit: position p into slot p mod R (the chunk may wrap); the rows it
        # overwrites live on in the host store, which the caller appends these rows to
        ring = positions % k_cache.shape[3]
        k_cache.index_copy_(3, ring, k_new)
        v_cache.index_copy_(3, ring, v_new)
    elif per_row:
        # per-row offsets, each write clamped into the cache as the JAX package's
        # dynamic_update_slice clamps it
        s = k_cache.shape[3]
        idx = torch.clamp(start_pos, 0, s - t)[:, None] + torch.arange(t, device=dev)[None]
        rows = torch.arange(tokens.shape[0], device=dev)[:, None]
        k_cache[:, rows, :, idx, :] = k_new.permute(1, 3, 0, 2, 4)
        v_cache[:, rows, :, idx, :] = v_new.permute(1, 3, 0, 2, 4)
    else:
        # through the positions on the device: no host integer enters the commit
        k_cache.index_copy_(3, positions, k_new)
        v_cache.index_copy_(3, positions, v_new)
    x = rmsnorm(x, params["rms_final"], spec.norm_eps)
    logits = qmatmul(x, params["wcls"], use_kernels=use_kernels, out_dtype=torch.float32)
    if mesh is not None:
        logits = all_gather_last(logits, mesh)  # wcls is split by vocab rows
    if spec.arch_type == ArchType.GROK1:
        logits = logits * GROK_LOGITS_SCALE
    if paged_cold is not None:
        return logits, k_cache, v_cache, (k_new, v_new)
    return logits, k_cache, v_cache


def commit_paged(k_pool: torch.Tensor, v_pool: torch.Tensor, k_rows: torch.Tensor,
                 v_rows: torch.Tensor, positions: torch.Tensor, block_tables: torch.Tensor,
                 block_tokens: int) -> None:
    """Write a step's new rows (L, B, hk, T, hs) into the (L, N, hk, bt, hs) pools in
    place: position positions[b, t] of row b lands in block tables[b, p // bt] at offset
    p % bt, one scatter per pool through the table the reads used. The advanced indices
    (B, T) lead the indexed shape, as in numpy, so the values are (B, T, L, hk, hs).
    Positions past the table cannot occur by the scheduler's coverage invariant."""
    blk = torch.take_along_dim(
        block_tables.long(),
        torch.clamp(positions // block_tokens, max=block_tables.shape[1] - 1), dim=1)
    off = positions % block_tokens
    k_pool[:, blk, :, off, :] = k_rows.permute(1, 3, 0, 2, 4)
    v_pool[:, blk, :, off, :] = v_rows.permute(1, 3, 0, 2, 4)


def init_kv_cache(spec: ModelSpec, batch: int = 1, dtype=torch.float32, device="cpu",
                  seq_len: int | None = None):
    """Zeroed head-major KV caches (L, B, hk, S, hs)."""
    s = seq_len if seq_len is not None else spec.seq_len
    shape = (spec.n_layers, batch, spec.n_kv_heads, s, spec.head_size)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_pool(spec: ModelSpec, n_blocks: int, block_tokens: int, dtype=torch.float32,
                 device="cpu"):
    """Zeroed KV block pools (L, N, hk, bt, hs)."""
    shape = (spec.n_layers, n_blocks, spec.n_kv_heads, block_tokens, spec.head_size)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
