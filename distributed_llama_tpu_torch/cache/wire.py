"""Shared KV-block wire codec: one serialize/deserialize story for KV rows.

The port's copy of the JAX package's cache/wire.py. Host KV rows are CPU torch tensors
here (numpy has no bfloat16, and the card's caches are bf16); numpy arrays are accepted
wherever rows come in and become tensors of the same dtype. Two consumers:

- `cache/block_pool.py` — the host block pool's Q80 cold tier: `q80_compress` /
  `q80_restore` are its demotion and its cold read, so the in-RAM tier and the wire
  reconstruct through the same arithmetic.
- the block framing (`encode_blocks` / `decode_blocks`) for a KV transfer between
  replicas, in two modes per block:

    * ``raw`` — the engine-dtype bytes verbatim. Bit-exact.
    * ``q80`` — `quants.quantize_q80` over the flattened rows (34 bytes per 32 values).
      Bounded error, not bit-exact. Blocks whose element count is not a multiple of the
      Q80 group size fall back to raw; the mode byte is per block.

The framing is self-describing (dtype name + shape per block) and byte-identical to
the JAX package's for the same rows; a truncated buffer raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..quants import QK, dequantize_q80, quantize_q80

__all__ = ["q80_compress", "q80_restore", "q80_compressible", "host_rows",
           "encode_blocks", "decode_blocks", "block_wire_bytes"]

_MAGIC = b"DKW1"
_RAW, _Q80 = 0, 1
_HDR = struct.Struct("<4sBB")       # magic, mode, ndim  (+ dtype-name pascal)
_DIM = struct.Struct("<I")
_LEN = struct.Struct("<Q")


def host_rows(x) -> torch.Tensor:
    """A fresh contiguous CPU tensor holding x's values in x's dtype (x: a tensor on any
    device, or a numpy array). From the card this is the device->host copy, queued
    behind the work already issued on the current stream."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.empty(tuple(x.shape), dtype=x.dtype).copy_(x)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")  # numpy's names: float32, bfloat16, ...


# ----------------------------------------------------------------------
# Q80 round trip (the block pool's cold tier)
# ----------------------------------------------------------------------

def q80_compressible(shape) -> bool:
    """Q80 quantizes flat groups of QK values; an array whose element count does not
    divide into them stays raw (block_pool keeps such blocks hot)."""
    return int(np.prod(shape)) % QK == 0


def q80_compress(x) -> tuple[np.ndarray, np.ndarray]:
    """(values int8, scales f16) of the flattened rows — the cold tier's storage pair and
    the wire's Q80 payload. The values go through f32 first, which is exact for bf16, so
    the codes equal the JAX package's on the same values."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    n = int(np.prod(x.shape))
    return quantize_q80(np.asarray(x, np.float32).reshape(n))


def q80_restore(pair: tuple[np.ndarray, np.ndarray], shape,
                dtype: torch.dtype) -> torch.Tensor:
    """Dequantize a q80_compress pair back to (shape, dtype) — Q80 round-trip precision,
    not bit-exact."""
    return torch.from_numpy(dequantize_q80(*pair).reshape(tuple(shape))).to(dtype)


# ----------------------------------------------------------------------
# wire framing
# ----------------------------------------------------------------------

def _dtype_from_name(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown KV wire dtype {name!r}")
    return dtype


def _encode_array(arr, q80: bool) -> bytes:
    t = host_rows(arr)
    mode = _Q80 if (q80 and q80_compressible(t.shape)) else _RAW
    name = _dtype_name(t.dtype).encode("ascii")
    head = [_HDR.pack(_MAGIC, mode, t.ndim), bytes([len(name)]), name]
    for d in t.shape:
        head.append(_DIM.pack(d))
    if mode == _RAW:
        payload = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return b"".join(head) + _LEN.pack(len(payload)) + payload
    vals, scales = q80_compress(t)
    vb, sb = vals.tobytes(), np.ascontiguousarray(scales).tobytes()
    return (b"".join(head) + _LEN.pack(len(vb)) + vb
            + _LEN.pack(len(sb)) + sb)


def _decode_array(buf: memoryview, off: int) -> tuple[torch.Tensor, int]:
    magic, mode, ndim = _HDR.unpack_from(buf, off)
    if magic != _MAGIC:
        raise ValueError(f"bad KV wire magic {magic!r} at offset {off}")
    off += _HDR.size
    nlen = buf[off]
    off += 1
    dtype = _dtype_from_name(bytes(buf[off:off + nlen]).decode("ascii"))
    off += nlen
    shape = []
    for _ in range(ndim):
        shape.append(_DIM.unpack_from(buf, off)[0])
        off += _DIM.size
    shape = tuple(shape)
    (n,) = _LEN.unpack_from(buf, off)
    off += _LEN.size
    if off + n > len(buf):
        raise ValueError("truncated KV wire payload")
    if mode == _RAW:
        raw = torch.tensor(np.frombuffer(buf[off:off + n], np.uint8))
        return raw.view(dtype).reshape(shape), off + n
    vals = np.frombuffer(buf[off:off + n], np.int8)
    off += n
    (m,) = _LEN.unpack_from(buf, off)
    off += _LEN.size
    if off + m > len(buf):
        raise ValueError("truncated KV wire scales")
    scales = np.frombuffer(buf[off:off + m], np.float16)
    # re-group the flat payload into quantize_q80's (groups, QK) planar layout so the
    # restore runs the pool's exact dequant arithmetic
    if vals.size != scales.size * QK:
        raise ValueError("KV wire q80 values/scales size mismatch")
    return q80_restore((vals.reshape(-1, QK), scales), shape, dtype), off + m


def encode_blocks(blocks: list, q80: bool = False) -> bytes:
    """Frame a list of (K, V) block pairs — each side an (L, hk, bt, hs) host tensor or
    array — into one wire buffer. `q80` selects the compressed mode per array
    (incompressible shapes fall back to raw)."""
    out = [_LEN.pack(len(blocks))]
    for k, v in blocks:
        out.append(_encode_array(k, q80))
        out.append(_encode_array(v, q80))
    return b"".join(out)


def decode_blocks(data: bytes) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Inverse of encode_blocks (CPU tensors); raises ValueError on any truncation or
    framing corruption."""
    buf = memoryview(data)
    try:
        (count,) = _LEN.unpack_from(buf, 0)
        off = _LEN.size
        blocks = []
        for _ in range(count):
            k, off = _decode_array(buf, off)
            v, off = _decode_array(buf, off)
            blocks.append((k, v))
    except (struct.error, IndexError) as e:
        raise ValueError(f"truncated/corrupt KV wire buffer: {e}") from None
    return blocks


def block_wire_bytes(blocks: list, q80: bool = False) -> int:
    """Exact encoded size without building the buffer (stats/planning)."""
    total = _LEN.size
    for k, v in blocks:
        for arr in (k, v):
            dtype = (arr.dtype if isinstance(arr, torch.Tensor)
                     else torch.from_numpy(np.empty(0, arr.dtype)).dtype)
            n = int(np.prod(arr.shape))
            head = _HDR.size + 1 + len(_dtype_name(dtype)) + _DIM.size * len(arr.shape)
            if q80 and q80_compressible(arr.shape):
                groups = n // QK
                total += head + 2 * _LEN.size + groups * QK + groups * 2
            else:
                total += head + _LEN.size + n * dtype.itemsize
    return total
