"""Parameter dicts for the dense Llama architecture, over torch tensors.

Layout convention (as the JAX package's models/params.py): every per-layer tensor is
STACKED along a leading n_layers axis. Weight matrices keep the reference's (out, in)
row-major orientation with quantization blocks along `in`. Tensor inventory mirrors the
`.m` file (transformer.cpp:494-529):

    embedding (vocab, dim) f32           wcls (vocab, dim) [weights ftype]
    per layer: wq (dim, dim), wk (kv_dim, dim), wv (kv_dim, dim), wo (dim, dim),
       dense: w1/gate (hidden, dim), w2/down (dim, hidden), w3/up (hidden, dim)
       moe:   router (n_experts, dim), moe_up/moe_gate (E, hidden, dim),
              moe_down (E, dim, hidden)
       norms: rms_att (dim,), rms_ffn (dim,) [+ grok1: rms_moe, rms_ffn2]
    rms_final (dim,) f32

Leaves are `QTensor`s (quantized matmul weights) or plain float32 tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.q4_matvec import MAX_K as Q4_MAX_K
from ..ops.q8_matvec import MAX_K as Q8_MAX_K
from ..parallel.sharding import effective_kv_heads
from ..quants import FloatType, QTensor
from .spec import ArchType, ModelSpec

Params = dict[str, Any]


def block_tensor_shapes(spec: ModelSpec) -> dict[str, tuple[tuple[int, ...], bool]]:
    """Per-layer tensor name -> (shape-without-layer-axis, is_quantized_matmul).

    Order matters: it is the `.m` file tensor order within a layer
    (transformer.cpp:498-523).
    """
    d, h, kv, e = spec.dim, spec.hidden_dim, spec.kv_dim, spec.n_experts
    shapes: dict[str, tuple[tuple[int, ...], bool]] = {
        "wq": ((d, d), True),
        "wk": ((kv, d), True),
        "wv": ((kv, d), True),
        "wo": ((d, d), True),
    }
    if spec.is_moe:
        shapes["router"] = ((e, d), True)
        shapes["moe_up"] = ((e, h, d), True)
        shapes["moe_gate"] = ((e, h, d), True)
        shapes["moe_down"] = ((e, d, h), True)
    else:
        shapes["w1"] = ((h, d), True)
        shapes["w2"] = ((d, h), True)
        shapes["w3"] = ((h, d), True)
    shapes["rms_att"] = ((d,), False)
    shapes["rms_ffn"] = ((d,), False)
    if spec.arch_type == ArchType.GROK1:
        shapes["rms_moe"] = ((d,), False)
        shapes["rms_ffn2"] = ((d,), False)
    return shapes


def init_random_params(spec: ModelSpec, weights_ftype: FloatType = FloatType.F32,
                       seed: int = 0, scale: float = 0.02) -> Params:
    """Random-weight model for tests (the reference's golden-test pattern: seeded random
    weights, llama2-tasks-test.cpp:527-608). Draws the same numpy stream as the JAX
    package's init_random_params, so one seed gives both packages the same weights."""
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    L = spec.n_layers
    blocks: Params = {}
    for name, (shape, quantized) in block_tensor_shapes(spec).items():
        full = randn(L, *shape)
        if quantized:
            blocks[name] = QTensor.from_float(full, weights_ftype)
        else:
            blocks[name] = torch.from_numpy(full + 1.0)  # norm weights around 1
    return {
        "embedding": torch.from_numpy(randn(spec.vocab_size, spec.dim)),
        "blocks": blocks,
        "rms_final": torch.from_numpy(randn(spec.dim) + 1.0),
        "wcls": QTensor.from_float(randn(spec.vocab_size, spec.dim), weights_ftype),
    }


def params_from_numpy(tree: dict, device="cpu") -> Params:
    """Build the port's params from the JAX package's params given as numpy leaves.

    A quantized leaf is a dict with the JAX QTensor's fields: `ftype`, `data`, `scales`
    (None for dense), `layout` ("planar", "i4p" or "i8"), `groups` and `row_groups`;
    every other leaf is a float array. i4p scales arrive as the int16 bit patterns of the
    f16 deltas and are viewed as float16 (same bits); i8 scales are float32. Nested dicts
    without `ftype` recurse."""

    def leaf(v):
        if isinstance(v, dict) and "ftype" in v:
            if v["layout"] not in ("planar", "i4p", "i8"):
                raise ValueError(f"layout {v['layout']!r} is not part of the port yet")
            scales = v["scales"]
            if scales is not None:
                scales = np.ascontiguousarray(scales)
                if scales.dtype == np.int16:
                    scales = scales.view(np.float16)
                scales = torch.from_numpy(scales).to(device)
            return QTensor(FloatType(int(v["ftype"])),
                           torch.from_numpy(np.ascontiguousarray(v["data"])).to(device),
                           scales, layout=v["layout"], groups=int(v["groups"]),
                           row_groups=int(v["row_groups"]))
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(device)

    return {k: leaf(v) for k, v in tree.items()}


def params_to(params: Params, device) -> Params:
    """Move every leaf of a params dict to `device`."""
    out: Params = {}
    for k, v in params.items():
        out[k] = params_to(v, device) if isinstance(v, dict) else v.to(device)
    return out


# per-layer tensors whose layer slice (and, for the MoE stacks, expert slice) is the 2-D
# matvec the decode kernels consume. The router stays planar: the forward pass runs it
# on the dequantize path, as the JAX package does. Tensors in _COL_SHARDED have their in
# axis split over tp (ColMatmulSlice), so their i4p split-plane pack is applied within
# each tp column group (QTensor.to_i4p_layout(col_groups=)).
_DENSE_MATMULS = {"wq", "wk", "wv", "wo", "w1", "w2", "w3",
                  "moe_up", "moe_gate", "moe_down"}
_COL_SHARDED = {"wo", "w2", "moe_down"}

# merged matvec groups: members share the same activation vector, so one kernel launch
# with the row blocks concatenated replaces 3 (QKV) / 2 (gate+up) launches. moe_gu is
# [up | gate] per expert, the opposite order of w13's [gate | up].
_FUSE_GROUPS = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3"),
                "moe_gu": ("moe_up", "moe_gate")}
# the out axis of each group's stacked leaves: (L, out, ...) or (L, E, out, ...)
_FUSE_ROW_AXIS = {"wqkv": 1, "w13": 1, "moe_gu": 2}


def _kernel_convertible(t) -> bool:
    """Planar Q40 and Q80 weights repack for the decode kernels (the JAX package's
    _I8_CONVERTIBLE); dense weights and tensors already in a kernel layout stay as they
    are."""
    return (isinstance(t, QTensor) and t.ftype in (FloatType.Q40, FloatType.Q80)
            and t.layout == "planar")


def _decode_layout(t: QTensor, tp: int = 1, col_sharded: bool = False) -> QTensor:
    """The decode-kernel layout of one weight, as the JAX package's _decode_layout picks
    it: Q40 whose K per tp column group keeps the split-plane boundary on a block
    boundary (K/groups % 64 == 0, groups = tp for a column-split tensor, else 1) -> i4p
    nibbles packed within each group (0.5625 B/weight, the q4 kernels); every other Q40
    and every Q80 weight -> int8 planes (1.125 B/weight, the q8 kernel). A rank's K wider
    than the kernels stage in shared memory stays planar (the dequantize path); the JAX
    package's TPU VMEM limit on K (q8_shape_supported) is not a property of this card."""
    k = t.shape[-1]
    groups = tp if col_sharded else 1
    kl = k // groups
    if t.ftype == FloatType.Q40 and k % groups == 0 and kl % 64 == 0 and kl <= Q4_MAX_K:
        return t.to_i4p_layout(col_groups=groups)
    return t.to_i8_layout() if kl <= Q8_MAX_K else t


def _interleave_rows(leaves: list[torch.Tensor], tp: int, row_axis: int) -> torch.Tensor:
    """Concatenate leaves along the row axis interleaved per tp group: rows
    [t0_g0, t1_g0, ..., t0_g1, t1_g1, ...] where g_i is rank i's row slice of each, so a
    plain row split lands each rank its own members' slices, contiguous."""
    parts = []
    for a in leaves:
        rows = a.shape[row_axis]
        if rows % tp:
            raise ValueError(f"{tuple(a.shape)}: {rows} rows do not split over tp={tp}")
        parts.append(a.reshape(*a.shape[:row_axis], tp, rows // tp, *a.shape[row_axis + 1:]))
    out = torch.cat(parts, dim=row_axis + 1)
    return out.reshape(*out.shape[:row_axis], -1, *out.shape[row_axis + 2:])


def _moe_expert_whole(name: str, moe_sharding: str) -> bool:
    """A MoE stack that shards by whole experts (moe_sharding="expert"): its rows are
    not interleaved per tp group and its in axis is not packed per tp column group."""
    return moe_sharding == "expert" and name.startswith("moe_")


def fuse_matvec_groups(blocks: Params, spec: ModelSpec | None = None, tp: int = 1,
                       skip: tuple[str, ...] = (), moe_sharding: str = "slice") -> Params:
    """Replace wq/wk/wv -> wqkv, w1/w3 -> w13 and moe_up/moe_gate -> moe_gu with
    row-concatenated planar tensors, interleaved per tp group (row_groups=tp), where
    every member is kernel-convertible and all share one float type, except the groups
    named in `skip`. The QKV group stays separate when KV-head replication is on (tp >
    n_kv_heads rewrites the wk/wv rows at shard time) or cannot be ruled out (tp > 1 and
    no spec), as in the JAX package. Under moe_sharding="expert" moe_gu concatenates
    with no interleave (row_groups=1): whole experts shard over tp, rows stay whole.
    Quant blocks run along the in axis, so row concatenation never touches block
    structure."""
    out = dict(blocks)
    for fused, members in _FUSE_GROUPS.items():
        if fused in skip:
            continue
        ts = [blocks.get(m) for m in members]
        if not all(_kernel_convertible(t) for t in ts) or len({t.ftype for t in ts}) != 1:
            continue
        axis = _FUSE_ROW_AXIS[fused]
        groups = 1 if _moe_expert_whole(fused, moe_sharding) else tp
        if any(t.shape[axis] % groups for t in ts):
            continue
        if fused == "wqkv" and tp > 1 and (
                spec is None or effective_kv_heads(spec, tp) != spec.n_kv_heads):
            continue
        out[fused] = QTensor(ts[0].ftype,
                             _interleave_rows([t.data for t in ts], groups, axis),
                             _interleave_rows([t.scales for t in ts], groups, axis),
                             row_groups=groups)
        for m in members:
            del out[m]
    return out


def _i4p_values(t: QTensor) -> torch.Tensor:
    """The natural-order nibbles (..., K) in [0, 16) of an i4p tensor."""
    wp = t.data.reshape(*t.data.shape[:-1], t.groups, t.data.shape[-1] // t.groups)
    q = torch.cat([wp & 0x0F, wp >> 4], dim=-1)
    return q.reshape(*t.data.shape[:-1], t.data.shape[-1] * 2)


def _regroup(name: str, t: QTensor, tp: int, spec: ModelSpec | None,
             moe_sharding: str = "slice") -> QTensor:
    """A weight already in a kernel layout (drawn or prepared for one card) made ready
    for shard_params at this tp: a fused group's one-group rows interleaved per tp group,
    and a column-split i4p tensor re-packed within each tp column group (int8 planes
    where K/tp breaks the i4p alignment, as _decode_layout decides). Under
    moe_sharding="expert" the MoE stacks stay as one card holds them (whole experts:
    row_groups 1, groups 1); a stack regrouped for "slice" cannot shard by experts."""
    if _moe_expert_whole(name, moe_sharding):
        if t.row_groups != 1 or t.groups != 1:
            raise ValueError(f"{name} is packed for moe_sharding='slice' (row interleave "
                             f"{t.row_groups}, column groups {t.groups}); expert "
                             "sharding keeps whole experts: prepare it from one card's "
                             "layout")
        return t
    if name in _FUSE_GROUPS and t.row_groups != tp:
        if t.row_groups != 1:
            raise ValueError(f"{name} is interleaved for tp={t.row_groups}, not {tp}")
        axis = _FUSE_ROW_AXIS[name]
        rows = t.data.shape[axis]
        if name == "wqkv":
            if spec is None:
                raise ValueError("regrouping a fused wqkv needs the model spec")
            sizes = [spec.dim, spec.kv_dim, spec.kv_dim]
        else:
            sizes = [rows // 2, rows // 2]

        def inter(a):
            return _interleave_rows(list(a.split(sizes, dim=axis)), tp, axis)
        t = QTensor(t.ftype, inter(t.data), inter(t.scales), t.layout, t.groups, tp)
    if name in _COL_SHARDED and t.layout == "i4p" and t.groups != tp:
        k = t.shape[-1]
        q = _i4p_values(t)
        if k % tp == 0 and (k // tp) % 64 == 0 and k // tp <= Q4_MAX_K:
            q = q.reshape(*q.shape[:-1], tp, k // tp)
            half = k // tp // 2
            data = (q[..., :half] | (q[..., half:] << 4)).reshape(*q.shape[:-2], k // 2)
            t = QTensor(t.ftype, data.contiguous(), t.scales, "i4p", tp, t.row_groups)
        else:
            t = QTensor(t.ftype, (q.to(torch.int8) - 8).contiguous(),
                        t.scales.to(torch.float32), "i8", row_groups=t.row_groups)
    return t


def prepare_for_cuda(params: Params, tp: int = 1, spec: ModelSpec | None = None,
                     fuse: bool = True, keep_gate_pair: bool = False,
                     moe_sharding: str = "slice") -> Params:
    """Repack the dense matmul weights and the MoE expert stacks into the decode-kernel
    layouts (i4p packed nibbles for Q40 whose K per tp column group is a multiple of 64,
    int8 planes for every other Q40 and all Q80; the leading layer and expert axes are
    kept), merging the QKV and gate/up groups first when `fuse` (rows interleaved per tp
    group; the spec rules out KV-head replication for the QKV merge at tp > 1).
    keep_gate_pair=True leaves w1/w3 separate for the gate-pair kernel
    (ops/q4_gated_matmul.py), as the fused serving rung wants. The counterpart of the JAX
    package's prepare_for_pallas: the result is the whole model, and parallel/tp.py
    shard_params takes each rank's slice of it.

    Weights already in a kernel layout keep their layout; at tp > 1 a fused group whose
    rows are not interleaved and a column-split i4p tensor packed for another tp are
    regrouped for this tp. Under moe_sharding="expert" (whole experts over tp, the JAX
    package's prepare_for_pallas(moe_sharding=)) the MoE stacks keep one card's layout:
    moe_gu concatenated with no interleave, moe_down packed with groups=1."""
    out: Params = {"embedding": params["embedding"], "blocks": {},
                   "rms_final": params["rms_final"]}
    blocks = (fuse_matvec_groups(params["blocks"], spec, tp,
                                 skip=("w13",) if keep_gate_pair else (),
                                 moe_sharding=moe_sharding)
              if fuse else params["blocks"])
    for name, t in blocks.items():
        if (name in _DENSE_MATMULS or name in _FUSE_GROUPS) and _kernel_convertible(t):
            out["blocks"][name] = _decode_layout(
                t, tp, name in _COL_SHARDED and not _moe_expert_whole(name, moe_sharding))
        elif tp > 1 and isinstance(t, QTensor) and t.layout in ("i4p", "i8"):
            out["blocks"][name] = _regroup(name, t, tp, spec, moe_sharding)
        else:
            out["blocks"][name] = t
    wcls = params["wcls"]
    out["wcls"] = _decode_layout(wcls) if _kernel_convertible(wcls) else wcls
    return out


def localize_qtensors(params: Params) -> Params:
    """A rank's shard as its own kernels see it: a column-split i4p tensor was packed per
    tp column group precisely so that one rank's slice is ONE self-contained split-plane
    pack, so its shard says groups=1 (the JAX package's _localize_qtensors, which runs
    inside its shard_map'd forward)."""
    out: Params = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = localize_qtensors(v)
        elif isinstance(v, QTensor) and v.layout == "i4p" and v.groups != 1:
            out[k] = QTensor(v.ftype, v.data, v.scales, "i4p", 1, v.row_groups)
        else:
            out[k] = v
    return out


def decode_stream_bytes(params: Params, spec: ModelSpec | None = None) -> int:
    """Weight + scale bytes one decode step streams from device memory (embedding row
    reads excluded). An MoE expert stack counts the n_active_experts of its n_experts
    that a token reads, so a MoE model needs its `spec`; the router counts whole."""
    total = 0
    for name, t in list(params["blocks"].items()) + [("wcls", params["wcls"])]:
        n = t.nbytes() if isinstance(t, QTensor) else t.numel() * t.element_size()
        if name.startswith("moe_"):
            if spec is None or not spec.is_moe:
                raise ValueError("decode_stream_bytes of a MoE model needs its spec")
            n = n * spec.n_active_experts // spec.n_experts
        total += n
    return total
