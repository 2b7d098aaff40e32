"""Rotary position embeddings — the three styles of the reference (src/commands.cpp:140-257).

- ROPE_LLAMA: interleaved pairs (2k, 2k+1), freq_k = theta^(-2k/head_size)
  (LlamaRopeCommand, commands.cpp:140-179).
- ROPE_LLAMA3_1: same rotation with Llama-3.1 frequency-dependent scaling applied to the
  *frequencies* (the Meta-official form; the reference's Llama3_1RopeCommand scales the
  rotated outputs, an upstream bug — commands.cpp:207-227).
- ROPE_FALCON: GPT-NeoX half-rotation layout, pairs (j, j+hs/2)
  (FalconRopeCommand, commands.cpp:229-257).

Tables are computed once per model in float64 numpy, stored as float32 tensors on the
model's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.spec import ModelSpec, RopeType


def _llama31_scale_freqs(freqs: np.ndarray, factor: float, low_freq_factor: float,
                         high_freq_factor: float, orig_max_seq_len: int) -> np.ndarray:
    """Llama-3.1 NTK-by-parts frequency scaling (correct form of commands.cpp:193-205)."""
    wavelens = 2.0 * math.pi / freqs
    low_freq_wavelen = orig_max_seq_len / low_freq_factor
    high_freq_wavelen = orig_max_seq_len / high_freq_factor
    smooth = (orig_max_seq_len / wavelens - low_freq_factor) / (high_freq_factor - low_freq_factor)
    return np.where(
        wavelens < high_freq_wavelen,
        freqs,
        np.where(wavelens > low_freq_wavelen, freqs / factor,
                 (1.0 - smooth) * freqs / factor + smooth * freqs),
    )


@dataclass
class RopeTables:
    """Precomputed per-position cos/sin, shape (seq_len, head_size // 2)."""

    cos: torch.Tensor
    sin: torch.Tensor
    rope_type: RopeType

    @classmethod
    def create(cls, spec: ModelSpec, device="cpu") -> "RopeTables":
        hs = spec.head_size
        k = np.arange(hs // 2, dtype=np.float64)
        freqs = 1.0 / (spec.rope_theta ** (2.0 * k / hs))
        if spec.rope_type == RopeType.LLAMA3_1:
            freqs = _llama31_scale_freqs(
                freqs, spec.rope_scaling_factor, spec.rope_scaling_low_freq_factor,
                spec.rope_scaling_high_freq_factor, spec.rope_scaling_orig_max_seq_len)
        t = np.arange(spec.seq_len, dtype=np.float64)
        angles = np.outer(t, freqs)  # (seq_len, hs//2)
        return cls(
            cos=torch.from_numpy(np.cos(angles).astype(np.float32)).to(device),
            sin=torch.from_numpy(np.sin(angles).astype(np.float32)).to(device),
            rope_type=spec.rope_type,
        )


def apply_rope(x: torch.Tensor, tables: RopeTables, positions: torch.Tensor) -> torch.Tensor:
    """Rotate q or k. x: (..., T, n_heads, head_size); positions: (T,) integer tensor.

    Both interleaved (llama) and half-rotation (neox/falcon) layouts rotate pair
    (a, b) -> (a*cos - b*sin, a*sin + b*cos); only the pairing differs.
    """
    cos = tables.cos[positions][..., :, None, :]  # (..., T, 1, hs//2)
    sin = tables.sin[positions][..., :, None, :]
    hs = x.shape[-1]
    xf = x.float()
    if tables.rope_type in (RopeType.LLAMA, RopeType.LLAMA3_1):
        xp = xf.reshape(*x.shape[:-1], hs // 2, 2)
        a, b = xp[..., 0], xp[..., 1]
        ra = a * cos - b * sin
        rb = a * sin + b * cos
        out = torch.stack([ra, rb], dim=-1).reshape(x.shape)
    elif tables.rope_type == RopeType.FALCON:
        a, b = xf[..., : hs // 2], xf[..., hs // 2 :]
        ra = a * cos - b * sin
        rb = a * sin + b * cos
        out = torch.cat([ra, rb], dim=-1)
    else:
        raise ValueError(tables.rope_type)
    return out.to(x.dtype)
