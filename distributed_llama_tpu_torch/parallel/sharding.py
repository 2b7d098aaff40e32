"""Which axis of each tensor the tp axis splits: the port's copy of the JAX package's
parallel/sharding.py, the reference's slicing layer (src/commands.cpp):

    RowMatmulSlice (split the out axis; commands.cpp:11-43)  -> rows: wq wk wv wqkv w1 w3
                                                                w13 moe_up moe_gate moe_gu
                                                                and wcls (vocab)
    ColMatmulSlice (split the in axis; commands.cpp:45-73)   -> columns: wo w2 moe_down,
                                                                whose outputs are partial
                                                                sums (the forward reduces)
    KvCacheSlice (kvDim/nSlices; commands.cpp:97-102)        -> the cache's head axis
    MultiHeadAttSlice, RopeSlice                              -> implied: heads split
                                                                whole, rope rotates
                                                                within a head
    replicated                                               -> router, norms, embedding

An entry is the index, in the stacked (L, ...) logical shape, of the axis tp splits, or
None. A quantized tensor's data and scales keep the out axis and the block axis at the
same index in every layout (planar (..., out, nb, 16|32), i4p (..., out, K/2) packed per
column group, i8 (..., out, K)), so one index serves both leaves, and every cut of the in
axis lands on a 32-block boundary (check_divisibility).
"""

from __future__ import annotations

from ..models.spec import ModelSpec

# per-layer tensors: the axis of the stacked (L, ...) shape that tp splits
_BLOCK_SPLITS = {
    "wq": 1,          # (L, dim->tp, dim)
    "wk": 1,          # (L, kv_dim->tp, dim)
    "wv": 1,
    # merged matvec groups (models/params.py fuse_matvec_groups): rows interleaved per
    # tp group at fuse time, so a plain row split gives each rank its own [q|k|v] and
    # [gate|up] blocks
    "wqkv": 1,        # (L, (dim+2kv)->tp, dim)
    "w13": 1,         # (L, 2*hidden->tp, dim)
    "wo": 2,          # (L, dim, dim->tp), partial sums
    "w1": 1,          # (L, hidden->tp, dim)
    "w3": 1,
    "w2": 2,          # (L, dim, hidden->tp), partial sums
    "router": None,   # replicated (root-only in the reference)
    "moe_up": 2,      # (L, E, hidden->tp, dim)
    "moe_gate": 2,
    "moe_gu": 2,      # (L, E, 2*hidden->tp, dim), merged up+gate
    "moe_down": 3,    # (L, E, dim, hidden->tp), partial sums
    "rms_att": None,
    "rms_ffn": None,
    "rms_moe": None,
    "rms_ffn2": None,
}

# expert parallelism (the JAX package's moe_sharding="expert"): whole experts over tp.
# Kept for the expert-sharded MoE body, which the port does not run yet
_EP_SPLITS = {
    "moe_up": 1,      # (L, E->tp, hidden, dim), experts whole
    "moe_gate": 1,
    "moe_gu": 1,
    "moe_down": 1,
}


def check_moe_sharding(moe_sharding: str) -> None:
    if moe_sharding == "expert":
        raise ValueError("moe_sharding='expert' (whole experts over tp) is not in the port "
                         "yet (ROADMAP Queue A item 3); use 'slice'")
    if moe_sharding != "slice":
        raise ValueError(f"moe_sharding {moe_sharding!r}: 'slice' or 'expert'")


def param_split_axes(params: dict, moe_sharding: str = "slice") -> dict:
    """The split axis (or None) of every tensor of a params dict, in its shape. The
    expert placement's table is here for the expert-sharded body; shard_params refuses
    it (check_moe_sharding) while the forward has no such body."""
    blocks = {k: _BLOCK_SPLITS[k] for k in params["blocks"]}
    if moe_sharding == "expert":
        blocks.update({k: v for k, v in _EP_SPLITS.items() if k in blocks})
    return {"embedding": None,  # replicated, as the reference's root-only f32 embedding
            "blocks": blocks,
            "rms_final": None,
            "wcls": 0}  # (vocab->tp, dim); the forward gathers the logits


def effective_kv_heads(spec: ModelSpec, tp: int) -> int:
    """KV-head count after tp replication: when tp > n_kv_heads each KV head is
    replicated over tp/n_kv_heads adjacent ranks (rank j holds KV head j*n_kv_heads//tp),
    so every rank's query heads find their KV head locally. The reference hard-fails there
    (transformer.cpp:108-111)."""
    if tp <= spec.n_kv_heads:
        return spec.n_kv_heads
    if tp % spec.n_kv_heads:
        raise ValueError(f"tp={tp} must be a multiple of n_kv_heads={spec.n_kv_heads} to "
                         "replicate KV heads evenly")
    return tp


def check_divisibility(spec: ModelSpec, tp: int, sp: int = 1,
                       moe_sharding: str = "slice") -> None:
    """The even-division checks that replace the reference's 2^n assumption and its
    nSlices <= nKvHeads limit, with the JAX package's messages."""
    hk = effective_kv_heads(spec, tp)
    if hk % tp:
        raise ValueError(f"tp={tp} must divide n_kv_heads={spec.n_kv_heads} (or be a "
                         "multiple of it for KV-head replication)")
    if spec.n_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={spec.n_heads}")
    if spec.dim % tp:
        raise ValueError(f"tp={tp} must divide dim={spec.dim}")
    if spec.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={spec.vocab_size}")
    if (spec.dim // tp) % 32:
        raise ValueError("tp slice must keep 32-wide quant blocks intact")
    if moe_sharding == "expert" and spec.is_moe:
        if spec.n_experts % tp:
            raise ValueError(f"expert sharding: tp={tp} must divide "
                             f"n_experts={spec.n_experts}")
    else:
        if spec.hidden_dim % tp:
            raise ValueError(f"tp={tp} must divide hidden_dim={spec.hidden_dim}")
        if (spec.hidden_dim // tp) % 32:
            raise ValueError("tp slice must keep 32-wide quant blocks intact")
    if spec.seq_len % sp:
        raise ValueError(f"sp={sp} must divide seq_len={spec.seq_len} (sequence-sharded "
                         "KV cache)")
