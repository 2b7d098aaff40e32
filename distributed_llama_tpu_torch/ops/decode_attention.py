"""Kernel 3: one decode token's GQA attention for one layer, read straight out of the
stacked (L, 1, hk, S, hs) KV caches.

Replaces distributed_llama_tpu/ops/pallas_attention.py `fused_decode_attention`
(`_kernel`, one block, and `_kernel_tiled`, the window-tiled flash carry). The CUDA
kernel is csrc/decode_attention.cu over the block body of csrc/attention_tile.cuh, which
it shares with paged_attention (split-K flash decoding on the tensor cores, the last
split block merging, one launch); its header says what bounds it on an H100 and what its
design does about that.

Semantics, shared by the kernel and `decode_attention_plain`: the query attends to the
committed cache slots [0, min(pos, window)) of layer `layer_idx` plus the current token
(k_new, v_new), which is not yet in the cache; scores and softmax in float32. Slots at
or past `pos` are masked in both the scores and the values (the kernel never reads them).

`decode_attention` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors; `launches` counts kernel launches. The kernel reads the position and the
layer index from device memory and sizes its launch from the window alone, so one
captured launch replays at every position below the window: the forward pass hands it
the step's device position and layer id tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_build
from .attention_plan import merge_counters, resident_blocks, split_plan
from .paged_attention import KERNEL_HS

launches = 0

_NEG = -1e30  # f32 mask value; exp(_NEG - max) == 0 exactly in f32
_P, _I, _F = cuda_build.P, cuda_build.I, cuda_build.F
_SIGNATURES = {"decode_attention": [_P] * 12 + [_I] * 7 + [_F, _P],
               "decode_attention_blocks_per_sm": [_I, _I, _I]}


def decode_attention_plain(q, kc, vc, k_new, v_new, layer_idx: int, pos: int,
                           window: int) -> torch.Tensor:
    """The kernel's function in plain torch: q (hk, g, hs), caches (L, 1, hk, S, hs),
    k_new/v_new (hk, 1, hs) -> (hk, g, hs) f32."""
    s = kc.shape[3]
    win = min(window, s)
    kw = kc[layer_idx, 0, :, :win].float()  # (hk, win, hs)
    vw = vc[layer_idx, 0, :, :win].float()
    kn = k_new.float()
    vn = v_new.float()
    q = q.float()
    scale = float(np.float32(1.0 / math.sqrt(q.shape[-1])))
    valid = torch.arange(win, device=q.device) < pos
    s_old = torch.einsum("hgd,hwd->hgw", q, kw) * scale
    s_old = torch.where(valid, s_old, torch.tensor(_NEG, device=q.device))
    s_new = (q * kn).sum(dim=-1, keepdim=True) * scale  # (hk, g, 1) current token
    m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
    p_old = torch.exp(s_old - m)
    p_new = torch.exp(s_new - m)
    denom = p_old.sum(dim=-1, keepdim=True) + p_new
    vw = torch.where(valid[:, None], vw, torch.zeros((), device=q.device))
    out = torch.einsum("hgw,hwd->hgd", p_old, vw)
    return (out + p_new * vn) / denom


def _device_index(x, dtype: torch.dtype, dev: torch.device, what: str) -> torch.Tensor:
    """A one-element device tensor of `dtype` holding x (an int, or a one-element tensor
    already on `dev`)."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor([int(x)], dtype=dtype, device=dev)
    if x.numel() != 1 or x.device != dev or x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"decode_attention kernel takes {what} as an int or a one-element "
                        f"int32/int64 tensor on {dev}, got {x.dtype} {tuple(x.shape)} on "
                        f"{x.device}")
    return x.reshape(1).to(dtype).contiguous()


def _launch(q, kc, vc, k_new, v_new, layer_idx, pos, window: int):
    global launches
    hk, g, hs = q.shape
    nl, b, hk2, s, hs2 = kc.shape
    if b != 1 or hk2 != hk or hs2 != hs or vc.shape != kc.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs caches {tuple(kc.shape)}")
    if k_new.shape != (hk, 1, hs) or v_new.shape != (hk, 1, hs):
        raise ValueError(f"decode_attention: k_new {tuple(k_new.shape)}")
    if kc.dtype not in (torch.bfloat16, torch.float32) or not (
            vc.dtype == k_new.dtype == v_new.dtype == kc.dtype):
        raise TypeError("decode_attention kernel takes bf16 or f32 caches and k/v of the "
                        "same dtype")
    if hs not in KERNEL_HS:
        raise ValueError(f"decode_attention kernel takes hs in {KERNEL_HS}, got {hs}")
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous caches")
    if not isinstance(layer_idx, torch.Tensor) and not 0 <= layer_idx < nl:
        raise ValueError(f"decode_attention: layer {layer_idx} out of {nl}")
    if len({t.device for t in (q, kc, vc, k_new, v_new)}) != 1:
        raise ValueError("decode_attention: tensors on different devices")
    dev = q.device
    pos_t = _device_index(pos, torch.int64, dev, "pos")
    layer_t = _device_index(layer_idx, torch.int32, dev, "layer_idx")
    lib = cuda_build.load("decode_attention", _SIGNATURES)
    win = max(0, min(window, s))
    bf16 = kc.dtype == torch.bfloat16
    npass, nsplit = split_plan(win, g, hk, resident_blocks(
        lib, "decode_attention_blocks_per_sm", bf16, hs, g, dev.index))
    qf = q.float().contiguous()
    kn = k_new.contiguous()
    vn = v_new.contiguous()
    out = torch.empty(hk, g, hs, dtype=torch.float32, device=dev)
    if nsplit > 1:
        part_m = torch.empty(hk, nsplit, g, dtype=torch.float32, device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty(hk, nsplit, g, hs, dtype=torch.float32, device=dev)
        ptrs = (part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                merge_counters(dev, hk * npass).data_ptr())
    else:
        ptrs = (None,) * 4
    scale = float(np.float32(1.0 / math.sqrt(hs)))
    rc = lib.decode_attention(
        qf.data_ptr(), kc.data_ptr(), vc.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        pos_t.data_ptr(), layer_t.data_ptr(), *ptrs, out.data_ptr(),
        int(bf16), hk, g, hs, s, win, nsplit, scale,
        cuda_build.stream_of(q))
    cuda_build.check(rc, "decode_attention")
    launches += 1
    return out


def decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor, layer_idx, pos, *,
                     window: int) -> torch.Tensor:
    """One decode token's attention for one layer against the stacked caches.

    q: (hk, g, hs) — query heads grouped per kv head. kc/vc: (L, 1, hk, S, hs) full
    stacked caches. k_new/v_new: (hk, 1, hs) — the current token's uncommitted k/v, in
    the cache dtype. layer_idx, pos: ints, or one-element integer tensors on q's device
    (the kernel reads them from there; an int is copied to the device first). window:
    read bound (>= pos). Returns (hk, g, hs) f32."""
    if q.device.type == "cuda":
        return _launch(q, kc, vc, k_new, v_new, layer_idx, pos, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, kc, vc, k_new, v_new, int(layer_idx), int(pos),
                                      window)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")
