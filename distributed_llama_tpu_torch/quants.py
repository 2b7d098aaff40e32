"""Block quantization formats (Q40 / Q80) over torch tensors.

Byte-compatible with the reference `.m` tensor encoding (reference: src/quants.hpp:17-25,
src/quants.cpp:137-288, converter/writer.py:29-74). The codecs below work on numpy arrays
(file I/O and tests); `QTensor` holds torch tensors on any device:

    Q40 "planar":  data uint8 (..., n//32, 16)   + scales float16 (..., n//32)
    Q80 "planar":  data int8  (..., n//32, 32)   + scales float16 (..., n//32)
    Q40 "i4p":     data uint8 (..., n//2)        + scales float16 (..., n//32)
    Q40/Q80 "i8":  data int8  (..., n)           + scales float32 (..., n//32)

Nibble semantics match the reference exactly (src/quants.cpp:178-182): byte j of a planar
block holds element j in its low nibble and element j+16 in its high nibble;
value = (nibble-8)*d. The i4p ("split-plane") layout is what the decode kernels read:
byte j of a row holds element j in its low nibble and element j+K/2 in its high nibble.
The i8 ("int8-plane") layout is what the q8 decode kernel reads: one int8 per element
in natural order ((nibble-8) for Q40, the raw value for Q80) beside f32 block scales.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

QK = 32  # block size for both Q40 and Q80 (reference: src/quants.hpp:14-15)
Q40_BLOCK_BYTES = 18  # f16 delta + 16 nibble-pair bytes
Q80_BLOCK_BYTES = 34  # f16 delta + 32 int8

_Q40_STRUCT = np.dtype([("d", "<f2"), ("qs", "u1", (QK // 2,))])
_Q80_STRUCT = np.dtype([("d", "<f2"), ("qs", "i1", (QK,))])


class FloatType(enum.IntEnum):
    """Wire/storage float types (reference: src/quants.hpp:6-12)."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3


def batch_bytes(ftype: FloatType, n: int, d: int = 1) -> int:
    """Bytes for a (d, n) tensor in the given storage type (reference: src/quants.cpp:28-51)."""
    count = n * d
    if ftype == FloatType.F32:
        return count * 4
    if ftype == FloatType.F16:
        return count * 2
    if ftype == FloatType.Q40:
        assert n % QK == 0, (n, d)
        return (count // QK) * Q40_BLOCK_BYTES
    if ftype == FloatType.Q80:
        assert n % QK == 0, (n, d)
        return (count // QK) * Q80_BLOCK_BYTES
    raise ValueError(f"unknown float type {ftype}")


# ---------------------------------------------------------------------------
# Q40: 4-bit blocks, min/max scaling with +8.5 offset (numpy codecs)
# ---------------------------------------------------------------------------


def quantize_q40(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize float array (..., n) to Q40 planar (packed, scales).

    Matches converter/writer.py:29-53: delta = extremum/-8 in f16, q = clip(x/delta+8.5, 0, 15).

    Returns (packed uint8 (..., n//32, 16), scales float16 (..., n//32)).
    """
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[-1]
    assert n % QK == 0, n
    g = x.reshape(*x.shape[:-1], n // QK, QK)
    gmax = g.max(axis=-1)
    gmin = g.min(axis=-1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    deltas16 = deltas.astype(np.float16)
    inv = np.divide(1.0, deltas, out=np.zeros_like(deltas), where=deltas != 0).astype(np.float32)
    q = np.clip(g * inv[..., None] + 8.5, 0, 15).astype(np.uint8)
    packed = q[..., : QK // 2] | (q[..., QK // 2 :] << 4)
    return packed, deltas16


def dequantize_q40(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Planar Q40 -> float32 (..., n). Matches src/quants.cpp:170-183."""
    lo = (packed & 0x0F).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    out = vals * scales[..., None].astype(np.float32)
    return out.reshape(*packed.shape[:-2], packed.shape[-2] * QK)


def q40_to_bytes(packed: np.ndarray, scales: np.ndarray) -> bytes:
    """Planar Q40 -> reference interleaved block stream (BlockQ40[])."""
    nb = int(np.prod(packed.shape[:-1]))
    out = np.empty(nb, dtype=_Q40_STRUCT)
    out["d"] = scales.reshape(nb)
    out["qs"] = packed.reshape(nb, QK // 2)
    return out.tobytes()


def q40_from_bytes(buf, shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Reference BlockQ40[] stream -> planar (packed, scales) for logical shape (..., n)."""
    n = shape[-1]
    assert n % QK == 0, shape
    nb_shape = (*shape[:-1], n // QK)
    nb = int(np.prod(nb_shape))
    arr = np.frombuffer(buf, dtype=_Q40_STRUCT, count=nb)
    return arr["qs"].reshape(*nb_shape, QK // 2).copy(), arr["d"].reshape(nb_shape).copy()


# ---------------------------------------------------------------------------
# Q80: int8 blocks, symmetric absmax/127 scaling (numpy codecs)
# ---------------------------------------------------------------------------


def quantize_q80(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize (..., n) to Q80 planar (values int8 (..., n//32, 32), scales f16 (..., n//32)).

    Matches converter/writer.py:55-74 / src/quants.cpp:186-268 (round-to-nearest-even).
    """
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[-1]
    assert n % QK == 0, n
    g = x.reshape(*x.shape[:-1], n // QK, QK)
    absmax = np.abs(g).max(axis=-1)
    deltas = absmax / 127.0
    deltas16 = deltas.astype(np.float16)
    inv = np.divide(1.0, deltas, out=np.zeros_like(deltas), where=deltas != 0).astype(np.float32)
    q = np.round(g * inv[..., None]).astype(np.int8)
    return q, deltas16


def dequantize_i8(values: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize the int8-plane layout: (..., K) int8 + (..., K/32) scales -> (..., K)
    in `dtype` (value and scale each cast to `dtype` before the product, as the JAX
    package's jnp_dequantize_i8 does)."""
    k = values.shape[-1]
    nb = scales.shape[-1]
    assert nb * QK == k, (tuple(values.shape), tuple(scales.shape))
    g = values.reshape(*values.shape[:-1], nb, QK)
    return (g.to(dtype) * scales.to(dtype)[..., None]).reshape(values.shape)


def dequantize_q80(values: np.ndarray, scales: np.ndarray) -> np.ndarray:
    out = values.astype(np.float32) * scales[..., None].astype(np.float32)
    return out.reshape(*values.shape[:-2], values.shape[-2] * QK)


def q80_to_bytes(values: np.ndarray, scales: np.ndarray) -> bytes:
    nb = int(np.prod(values.shape[:-1]))
    out = np.empty(nb, dtype=_Q80_STRUCT)
    out["d"] = scales.reshape(nb)
    out["qs"] = values.reshape(nb, QK)
    return out.tobytes()


def q80_from_bytes(buf, shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    n = shape[-1]
    assert n % QK == 0, shape
    nb_shape = (*shape[:-1], n // QK)
    nb = int(np.prod(nb_shape))
    arr = np.frombuffer(buf, dtype=_Q80_STRUCT, count=nb)
    return arr["qs"].reshape(*nb_shape, QK).copy(), arr["d"].reshape(nb_shape).copy()


# ---------------------------------------------------------------------------
# QTensor: a quantized-or-not weight tensor over torch tensors
# ---------------------------------------------------------------------------


@dataclass
class QTensor:
    """A weight tensor, stored dense or block-quantized.

    For Q40/Q80 the block axis is the LAST logical axis (the contraction axis `n` of the
    reference's (d, n) row-major weights; src/commands.cpp:22-39). `shape` is derived
    from `data`. `groups` (i4p only) is the number of column groups the split-plane pack
    was applied within; `row_groups` (fused matvec groups only) the row-group count the
    members were interleaved with. Both are 1 on a single card.
    """

    ftype: FloatType
    data: torch.Tensor  # dense values, Q40 packed u8, or Q80 int8
    scales: torch.Tensor | None = None  # per-block deltas: f16, or f32 in the i8 layout
    layout: str = "planar"  # "planar" | "i4p" | "i8"
    groups: int = 1
    row_groups: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical (dequantized) shape."""
        if self.ftype in (FloatType.F32, FloatType.F16):
            return tuple(self.data.shape)
        if self.layout == "i8":
            return tuple(self.data.shape)
        if self.layout == "i4p":
            return (*self.data.shape[:-1], self.data.shape[-1] * 2)
        if self.ftype in (FloatType.Q40, FloatType.Q80):
            return (*self.data.shape[:-2], self.data.shape[-2] * QK)
        raise ValueError(self.ftype)

    def to(self, device) -> "QTensor":
        return QTensor(self.ftype, self.data.to(device),
                       None if self.scales is None else self.scales.to(device),
                       self.layout, self.groups, self.row_groups)

    def to_i4p_layout(self, col_groups: int = 1) -> "QTensor":
        """Repack planar Q40 into split-plane nibbles: data uint8 (..., K/2) with byte
        j = q[j] | (q[j+K/2] << 4) where q = nibble+8; scales keep the file's f16 deltas.
        Both unpacked planes land in natural element order. Same bytes as the reference's
        BlockQ40 stream (src/quants.hpp:17-20).

        col_groups: split-plane pack WITHIN each of `col_groups` equal column groups
        (K/col_groups must be a multiple of 64 so the plane boundary stays on a block
        boundary). A single card uses col_groups=1.
        """
        assert self.layout == "planar" and self.ftype == FloatType.Q40, (
            self.layout, self.ftype)
        packed = self.data  # (..., nb, 16)
        lo = packed & 0x0F  # block elements 0..15
        hi = packed >> 4  # block elements 16..31
        q = torch.cat([lo, hi], dim=-1)  # (..., nb, 32) natural order, in [0,16)
        k = q.shape[-2] * QK
        lead = q.shape[:-2]
        kl = k // col_groups
        assert k % col_groups == 0 and kl % 64 == 0, (k, col_groups)
        q = q.reshape(*lead, col_groups, kl)
        data = q[..., : kl // 2] | (q[..., kl // 2 :] << 4)
        data = data.reshape(*lead, k // 2).contiguous()
        return QTensor(self.ftype, data, self.scales.to(torch.float16), layout="i4p",
                       groups=col_groups, row_groups=self.row_groups)

    def to_i8_layout(self) -> "QTensor":
        """Expand planar Q40/Q80 into int8 planes: data int8 (..., K) holding (nibble-8)
        for Q40 and the raw int8 for Q80, in natural column order; scales f32 (..., K/32)
        (the file's f16 deltas, widened exactly). The same bytes as the JAX package's
        QTensor.to_i8_layout."""
        assert self.layout == "planar", self.layout
        if self.ftype == FloatType.Q40:
            lo = (self.data & 0x0F).to(torch.int8) - 8  # elements 0..15 of each block
            hi = (self.data >> 4).to(torch.int8) - 8  # elements 16..31
            vals = torch.cat([lo, hi], dim=-1)  # (..., nb, 32)
        elif self.ftype == FloatType.Q80:
            vals = self.data.to(torch.int8)
        else:
            raise ValueError(self.ftype)
        data = vals.reshape(*vals.shape[:-2], vals.shape[-2] * QK).contiguous()
        return QTensor(self.ftype, data, self.scales.to(torch.float32), layout="i8",
                       row_groups=self.row_groups)

    def _i4p_unpack(self) -> torch.Tensor:
        """Split-plane nibbles -> natural-order values (..., K) minus the 8 offset, int8."""
        wp = self.data
        kh = wp.shape[-1]
        g = self.groups
        wp = wp.reshape(*wp.shape[:-1], g, kh // g)
        lo = (wp & 0x0F).to(torch.int8) - 8
        hi = (wp >> 4).to(torch.int8) - 8
        out = torch.cat([lo, hi], dim=-1)  # (..., g, K/g) natural within group
        return out.reshape(*out.shape[:-2], kh * 2)

    @classmethod
    def from_float(cls, x: np.ndarray, ftype: FloatType) -> "QTensor":
        x = np.asarray(x)
        if ftype == FloatType.F32:
            return cls(ftype, torch.from_numpy(x.astype(np.float32)))
        if ftype == FloatType.F16:
            return cls(ftype, torch.from_numpy(x.astype(np.float16)))
        if ftype == FloatType.Q40:
            packed, scales = quantize_q40(x)
            return cls(ftype, torch.from_numpy(packed), torch.from_numpy(scales))
        if ftype == FloatType.Q80:
            vals, scales = quantize_q80(x)
            return cls(ftype, torch.from_numpy(vals), torch.from_numpy(scales))
        raise ValueError(ftype)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Materialize logical values on the tensor's device, computed in `dtype`
        (value and scale are each cast to `dtype` before the product, as the JAX
        package's dequantize does)."""
        if self.ftype in (FloatType.F32, FloatType.F16):
            return self.data.to(dtype)
        if self.layout == "i8":
            return dequantize_i8(self.data, self.scales, dtype)
        if self.layout == "i4p":
            vals = self._i4p_unpack()
            nb = self.scales.shape[-1]
            g = vals.reshape(*vals.shape[:-1], nb, QK)
        elif self.ftype == FloatType.Q40:
            lo = (self.data & 0x0F).to(torch.int8) - 8
            hi = (self.data >> 4).to(torch.int8) - 8
            g = torch.cat([lo, hi], dim=-1)
        elif self.ftype == FloatType.Q80:
            g = self.data
        else:
            raise ValueError(self.ftype)
        out = g.to(dtype) * self.scales.to(dtype)[..., None]
        return out.reshape(*g.shape[:-2], g.shape[-2] * QK)

    def to_numpy(self) -> np.ndarray:
        """Logical values as float32 numpy (exact: f16 scales times small integers)."""
        return self.dequantize(torch.float32).cpu().numpy()

    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n
