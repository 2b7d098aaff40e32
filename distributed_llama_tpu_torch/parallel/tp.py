"""Tensor-parallel execution: this rank's shard of the weights and caches, and its step.

The port's counterpart of the JAX package's parallel/tp.py. There `jax.device_put` with
NamedShardings places every tensor on the mesh and one shard_map'd program runs on every
device; here every rank holds the whole model on its host (as each JAX host loads the
whole `.m` file), cuts its own slice there (`shard_params`), places only that slice on
its device and runs models/forward.py on it with the merge points on
(`make_sharded_forward`). This replaces the reference's weight streaming
to workers (transformer.cpp:432-451) and its per-layer broadcast/gather tasks
(tasks.cpp:44-94).
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.forward import forward
from ..models.params import _FUSE_GROUPS, localize_qtensors
from ..models.spec import ModelSpec
from ..quants import QTensor
from .mesh import Mesh
from .sharding import (check_divisibility, check_moe_sharding, effective_kv_heads,
                       param_split_axes)


def _repeat_kv_rows(t, hk: int, rep: int):
    """Replicate each KV head's row block `rep` times along the row (out) axis of stacked
    (L, hk*hs, ...) leaves, whole heads kept together, so a row split lands KV head
    j*hk//tp on rank j: the head rank j's query heads attend with. Quant blocks run along
    the in axis, so row replication never splits a block."""
    def rep_leaf(a):
        if a is None:
            return None
        rows = a.shape[1]
        if rows % hk:
            raise ValueError(f"{tuple(a.shape)}: rows do not split into {hk} KV heads")
        grouped = a.reshape(a.shape[0], hk, rows // hk, *a.shape[2:])
        return grouped.repeat_interleave(rep, dim=1).reshape(
            a.shape[0], hk * rep * (rows // hk), *a.shape[2:])

    if isinstance(t, QTensor):
        return QTensor(t.ftype, rep_leaf(t.data), rep_leaf(t.scales), t.layout, t.groups,
                       t.row_groups)
    return rep_leaf(t)


def _slice(t, axis: int | None, rank: int, tp: int):
    """Rank `rank`'s contiguous 1/tp of axis `axis` (both leaves of a QTensor), copied so
    the whole tensor can be freed; None: the tensor itself (replicated)."""
    if axis is None or tp == 1:
        return t

    def cut(a):
        if a is None:
            return None
        if a.shape[axis] % tp:
            raise ValueError(f"axis {axis} of {tuple(a.shape)} does not split over tp={tp}")
        n = a.shape[axis] // tp
        return a.narrow(axis, rank * n, n).clone(memory_format=torch.contiguous_format)

    if isinstance(t, QTensor):
        return QTensor(t.ftype, cut(t.data), cut(t.scales), t.layout, t.groups,
                       t.row_groups)
    return cut(t)


def shard_params(params: dict[str, Any], mesh: Mesh, spec: ModelSpec | None = None,
                 moe_sharding: str = "slice") -> dict[str, Any]:
    """This rank's slice of every tensor (param_split_axes), on the device the tensors
    are on: the reference's per-node weight slices (transformer.cpp:480-539) taken from
    the whole model every rank holds.

    Fused matvec groups must carry the row interleave of this tp (prepare_for_cuda with
    the deployment's tp), and a column-split i4p tensor must be packed per tp column
    group: either mismatch would silently scramble the split, so it raises. With the
    spec, the divisibility checks run and, when tp > n_kv_heads, wk/wv rows are
    replicated per KV head first (effective_kv_heads). The shards are localized: a rank's
    i4p shard is one self-contained pack (models/params.py localize_qtensors)."""
    check_moe_sharding(moe_sharding)
    tp, rank = mesh.tp, mesh.rank
    for name, t in params["blocks"].items():
        if name in _FUSE_GROUPS and isinstance(t, QTensor) and t.row_groups != tp:
            raise ValueError(
                f"{name} was fused with row interleave {t.row_groups}, but this mesh "
                f"shards it over {tp} group(s) (tp={tp}, moe_sharding={moe_sharding}): "
                "run prepare_for_cuda with the deployment's tp")
    if spec is not None:
        check_divisibility(spec, tp, moe_sharding=moe_sharding)
        hk_eff = effective_kv_heads(spec, tp)
        if hk_eff != spec.n_kv_heads:
            if "wqkv" in params["blocks"]:
                raise ValueError("KV-head replication rewrites wk/wv rows: a fused wqkv "
                                 "cannot be sharded over tp > n_kv_heads")
            rep = hk_eff // spec.n_kv_heads
            params = dict(params, blocks=dict(params["blocks"]))
            for name in ("wk", "wv"):
                params["blocks"][name] = _repeat_kv_rows(params["blocks"][name],
                                                         spec.n_kv_heads, rep)
    axes = param_split_axes(params, moe_sharding)
    out: dict[str, Any] = {}
    for key, value in params.items():
        if key == "blocks":
            out[key] = {}
            for name, t in value.items():
                ax = axes["blocks"][name]
                if (isinstance(t, QTensor) and t.layout == "i4p" and ax is not None
                        and ax == t.data.ndim - 1 and t.groups != tp):
                    raise ValueError(f"{name} is split along its in axis over tp={tp} but "
                                     f"its i4p pack has {t.groups} column group(s): run "
                                     "prepare_for_cuda with the deployment's tp")
                out[key][name] = _slice(t, ax, rank, tp)
        else:
            out[key] = _slice(value, axes[key], rank, tp)
    return localize_qtensors(out)


def init_sharded_kv_cache(spec: ModelSpec, mesh: Mesh, batch: int = 1,
                          dtype=torch.float32, seq_len: int | None = None):
    """Zeroed KV caches of this rank's heads: (L, B, effective_kv_heads/tp, S, hs) on the
    mesh's device. The one cache constructor of every sharded entry point, so none can
    forget the replicated heads."""
    hk = effective_kv_heads(spec, mesh.tp) // mesh.tp
    s = seq_len if seq_len is not None else spec.seq_len
    shape = (spec.n_layers, batch, hk, s, spec.head_size)
    return (torch.zeros(shape, dtype=dtype, device=mesh.device),
            torch.zeros(shape, dtype=dtype, device=mesh.device))


def merge_mesh(mesh: Mesh | None, compress_collectives: bool) -> Mesh | None:
    """The mesh forward reduces over, or None: the JAX package's tp_axis rule. A
    one-member tp axis has nothing to reduce, so the merge points drop out and the
    residual epilogue of the wo and w2 kernels may run; compressed collectives keep them,
    since the Q80 wire's numerics are part of the result even over one member."""
    if mesh is None or (mesh.tp <= 1 and not compress_collectives):
        return None
    return mesh


def make_sharded_forward(spec: ModelSpec, mesh: Mesh, *, dtype=torch.float32,
                         use_kernels: bool | str = False,
                         compress_collectives: bool = False,
                         attn_window: int | None = None, fused_prologue: bool = False,
                         moe_sharding: str = "slice"):
    """This rank's forward step over the mesh's tp axis: fn(params, rope, tokens,
    k_cache, v_cache, start_pos, attn_window=) -> (logits (B, T, vocab) f32, k_cache,
    v_cache), with the shard from shard_params and the caches from
    init_sharded_kv_cache; `attn_window` defaults to the one given here. Every rank
    calls it with the same tokens and positions. The Engine's steps under a mesh run
    through it."""
    check_moe_sharding(moe_sharding)
    check_divisibility(spec, mesh.tp, moe_sharding=moe_sharding)
    merge = merge_mesh(mesh, compress_collectives)
    window = attn_window

    def step(params, rope, tokens, k_cache, v_cache, start_pos, attn_window=window):
        return forward(params, spec, rope, tokens, k_cache, v_cache, start_pos,
                       dtype=dtype, use_kernels=use_kernels, attn_window=attn_window,
                       fused_prologue=fused_prologue, mesh=merge,
                       compress_collectives=compress_collectives)

    return step
