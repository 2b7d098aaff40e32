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
# on the dequantize path, as the JAX package does.
_DENSE_MATMULS = {"wq", "wk", "wv", "wo", "w1", "w2", "w3",
                  "moe_up", "moe_gate", "moe_down"}

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


def _decode_layout(t: QTensor) -> QTensor:
    """The decode-kernel layout of one weight, as the JAX package's _decode_layout picks
    it at tp=1: Q40 whose K keeps the split-plane boundary on a block boundary
    (K % 64 == 0) -> i4p nibbles (0.5625 B/weight, the q4 kernels); every other Q40 and
    every Q80 weight -> int8 planes (1.125 B/weight, the q8 kernel). A K wider than the
    kernels stage in shared memory stays planar (the dequantize path); the JAX package's
    TPU VMEM limit on K (q8_shape_supported) is not a property of this card."""
    k = t.shape[-1]
    if t.ftype == FloatType.Q40 and k % 64 == 0 and k <= Q4_MAX_K:
        return t.to_i4p_layout()
    return t.to_i8_layout() if k <= Q8_MAX_K else t


def fuse_matvec_groups(blocks: Params, skip: tuple[str, ...] = ()) -> Params:
    """Replace wq/wk/wv -> wqkv, w1/w3 -> w13 and moe_up/moe_gate -> moe_gu with
    row-concatenated planar tensors where every member is kernel-convertible and all
    share one float type, except the groups named in `skip`. Quant blocks run along the
    in axis, so row concatenation never touches block structure."""
    out = dict(blocks)
    for fused, members in _FUSE_GROUPS.items():
        if fused in skip:
            continue
        ts = [blocks.get(m) for m in members]
        if not all(_kernel_convertible(t) for t in ts) or len({t.ftype for t in ts}) != 1:
            continue
        axis = _FUSE_ROW_AXIS[fused]
        out[fused] = QTensor(ts[0].ftype, torch.cat([t.data for t in ts], dim=axis),
                             torch.cat([t.scales for t in ts], dim=axis))
        for m in members:
            del out[m]
    return out


def prepare_for_cuda(params: Params, fuse: bool = True,
                     keep_gate_pair: bool = False) -> Params:
    """Repack the dense matmul weights and the MoE expert stacks into the decode-kernel
    layouts (i4p packed nibbles for Q40 with K % 64 == 0, int8 planes for every other
    Q40 and all Q80; the leading layer and expert axes are kept), merging the QKV and
    gate/up groups first when `fuse`. keep_gate_pair=True leaves
    w1/w3 separate for the gate-pair kernel (ops/q4_gated_matmul.py), as the fused
    serving rung wants. Weights already in a kernel layout are left as they are. The
    counterpart of the JAX package's prepare_for_pallas at tp=1."""
    out: Params = {"embedding": params["embedding"], "blocks": {},
                   "rms_final": params["rms_final"]}
    blocks = (fuse_matvec_groups(params["blocks"],
                                 skip=("w13",) if keep_gate_pair else ())
              if fuse else params["blocks"])
    for name, t in blocks.items():
        if (name in _DENSE_MATMULS or name in _FUSE_GROUPS) and _kernel_convertible(t):
            out["blocks"][name] = _decode_layout(t)
        else:
            out["blocks"][name] = t
    wcls = params["wcls"]
    out["wcls"] = _decode_layout(wcls) if _kernel_convertible(wcls) else wcls
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
