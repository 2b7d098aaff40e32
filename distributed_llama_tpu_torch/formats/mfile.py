"""`.m` model file format — byte-compatible reader/writer.

Format (reference: src/transformer.cpp:12-148 for parsing, converter/writer.py:109-143
for writing):

    [magic 0xA00ABCD i32][header_size i32][ (key i32, value i32) * nKv ]
    then raw tensors in fixed order (transformer.cpp:494-529):
        embedding (vocab, dim) F32
        per layer: wq, wk, wv, wo; dense: w1, w2, w3 | moe: router + per-expert
                   (up, gate, down); rms_att F32, rms_ffn F32
                   [+ grok1: rms_moe, rms_ffn2 F32]
        rms_final (dim,) F32
        wcls (vocab, dim) [weights ftype]

    header_size counts magic+size+kv bytes; tensors start at byte header_size. Matmul
    tensors use the header's weights ftype (F32/F16/Q40/Q80 block streams); norms and
    embedding are always F32. Legacy magics 0xABCD00/01 use a fixed 9-int header
    (transformer.cpp:28-43).

The loader memory-maps the file and returns the params dict of models/params.py with
per-layer tensors stacked along a leading n_layers axis, as CPU torch tensors.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np
import torch

from ..models.params import Params, block_tensor_shapes
from ..models.spec import ArchType, HeaderKey, HiddenAct, ModelSpec, RopeType
from ..quants import (
    FloatType,
    QTensor,
    batch_bytes,
    q40_from_bytes,
    q40_to_bytes,
    q80_from_bytes,
    q80_to_bytes,
    quantize_q40,
    quantize_q80,
)

MAGIC = 0xA00ABCD
LEGACY_MAGICS = {0xABCD00: ArchType.LLAMA, 0xABCD01: ArchType.GROK1}


def read_spec(path: str, max_seq_len: int = 0,
              weights_ftype: FloatType | None = None) -> tuple[ModelSpec, FloatType, int]:
    """Parse the header. Returns (spec, weights_ftype, header_size)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<i", f.read(4))[0]
        fields: dict[str, int] = {}
        if magic in LEGACY_MAGICS:
            vals = struct.unpack("<9i", f.read(36))
            (fields["dim"], fields["hidden_dim"], fields["n_layers"], fields["n_heads"],
             fields["n_kv_heads"], fields["n_experts"], fields["n_active_experts"],
             fields["vocab_size"], fields["seq_len"]) = vals
            arch = LEGACY_MAGICS[magic]
            header_size = 4 + 36
            kv: dict[int, int] = {}
        elif magic == MAGIC:
            header_size = struct.unpack("<i", f.read(4))[0]
            n_kv_bytes = header_size - 8
            raw = f.read(n_kv_bytes)
            ints = struct.unpack(f"<{n_kv_bytes // 4}i", raw)
            kv = {ints[i]: ints[i + 1] for i in range(0, len(ints), 2)}
            arch = ArchType(kv[HeaderKey.ARCH_TYPE])
            for name, key in (("dim", HeaderKey.DIM), ("hidden_dim", HeaderKey.HIDDEN_DIM),
                              ("n_layers", HeaderKey.N_LAYERS),
                              ("n_heads", HeaderKey.N_HEADS),
                              ("n_kv_heads", HeaderKey.N_KV_HEADS),
                              ("n_experts", HeaderKey.N_EXPERTS),
                              ("n_active_experts", HeaderKey.N_ACTIVE_EXPERTS),
                              ("vocab_size", HeaderKey.VOCAB_SIZE),
                              ("seq_len", HeaderKey.SEQ_LEN)):
                if key in kv:
                    fields[name] = kv[key]
        else:
            raise ValueError(f"unsupported model file magic {magic:#x}")

    if weights_ftype is None:
        if HeaderKey.WEIGHTS_FLOAT_TYPE not in kv:
            raise ValueError("weights float type not in header and not specified")
        weights_ftype = FloatType(kv[HeaderKey.WEIGHTS_FLOAT_TYPE])

    spec = ModelSpec(
        arch_type=arch,
        hidden_act=HiddenAct(kv.get(HeaderKey.HIDDEN_ACT, HiddenAct.SILU)),
        rope_theta=float(kv.get(HeaderKey.ROPE_THETA, 10000)),
        rope_type=RopeType(kv.get(HeaderKey.ROPE_TYPE, RopeType.UNKNOWN)),
        rope_scaling_factor=float(kv.get(HeaderKey.ROPE_SCALING_FACTOR, 0)),
        rope_scaling_low_freq_factor=float(
            kv.get(HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR, 0)),
        rope_scaling_high_freq_factor=float(
            kv.get(HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTOR, 0)),
        rope_scaling_orig_max_seq_len=kv.get(HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN, 0),
        version=kv.get(HeaderKey.VERSION, 0),
        **fields,
    ).resolved(max_seq_len)
    return spec, weights_ftype, header_size


def model_tensor_bytes(spec: ModelSpec, wft: FloatType) -> int:
    """Total tensor bytes after the header (mirrors the reference's missedBytes check,
    transformer.cpp:531-535)."""
    total = batch_bytes(FloatType.F32, spec.dim, spec.vocab_size)  # embedding
    shapes = block_tensor_shapes(spec)
    for name, (shape, quantized) in shapes.items():
        ft = wft if quantized else FloatType.F32
        d = int(np.prod(shape[:-1], initial=1))
        total += spec.n_layers * batch_bytes(ft, shape[-1], d)
    total += batch_bytes(FloatType.F32, spec.dim, 1)  # rms_final
    total += batch_bytes(wft, spec.dim, spec.vocab_size)  # wcls
    return total


def _tensor_from_bytes(buf: memoryview, shape: tuple[int, ...],
                       ftype: FloatType) -> tuple[np.ndarray, np.ndarray | None]:
    """One tensor's bytes -> (data, scales) numpy arrays (scales None for dense)."""
    if ftype == FloatType.F32:
        return np.frombuffer(buf, "<f4").reshape(shape).copy(), None
    if ftype == FloatType.F16:
        return np.frombuffer(buf, "<f2").reshape(shape).copy(), None
    if ftype == FloatType.Q40:
        return q40_from_bytes(buf, shape)
    if ftype == FloatType.Q80:
        return q80_from_bytes(buf, shape)
    raise ValueError(ftype)


def _stack(tensors: list[tuple[np.ndarray, np.ndarray | None]],
           ftype: FloatType) -> QTensor:
    data = torch.from_numpy(np.stack([d for d, _ in tensors]))
    scales = (None if tensors[0][1] is None
              else torch.from_numpy(np.stack([s for _, s in tensors])))
    return QTensor(ftype, data, scales)


def load_model(path: str, max_seq_len: int = 0,
               weights_ftype: FloatType | None = None) -> tuple[ModelSpec, Params]:
    """Load a `.m` file into (spec, params). Equivalent of Transformer::loadRootFromFile
    (transformer.cpp:467-539) — mmap + per-tensor parse into CPU tensors; the Engine
    moves them to its device."""
    spec, wft, header_size = read_spec(path, max_seq_len, weights_ftype)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    view = memoryview(mm)
    off = header_size

    expected = header_size + model_tensor_bytes(spec, wft)
    if expected != len(mm):
        raise ValueError(
            f"model file size mismatch: expected {expected} bytes for "
            f"{wft.name} weights, file has {len(mm)} (wrong weights float type?)")

    def take(shape: tuple[int, ...], ftype: FloatType):
        nonlocal off
        nbytes = batch_bytes(ftype, shape[-1], int(np.prod(shape[:-1], initial=1)))
        t = _tensor_from_bytes(view[off:off + nbytes], shape, ftype)
        off += nbytes
        return t

    # NOTE: seq-len clamping must not affect tensor layout; file tensors are independent
    # of seq_len, so no adjustment needed.
    embedding = take((spec.vocab_size, spec.dim), FloatType.F32)

    shapes = block_tensor_shapes(spec)
    per_layer: dict[str, list] = {name: [] for name in shapes}
    for _ in range(spec.n_layers):
        layer: dict[str, tuple] = {}
        for name in ("wq", "wk", "wv", "wo"):
            layer[name] = take(shapes[name][0], wft)
        if spec.is_moe:
            layer["router"] = take(shapes["router"][0], wft)
            ups, gates, downs = [], [], []
            e, h, d = spec.n_experts, spec.hidden_dim, spec.dim
            for _e in range(e):
                ups.append(take((h, d), wft))
                gates.append(take((h, d), wft))
                downs.append(take((d, h), wft))
            layer["moe_up"] = (np.stack([d for d, _ in ups]), np.stack([s for _, s in ups]))
            layer["moe_gate"] = (np.stack([d for d, _ in gates]),
                                 np.stack([s for _, s in gates]))
            layer["moe_down"] = (np.stack([d for d, _ in downs]),
                                 np.stack([s for _, s in downs]))
        else:
            layer["w1"] = take(shapes["w1"][0], wft)
            layer["w2"] = take(shapes["w2"][0], wft)
            layer["w3"] = take(shapes["w3"][0], wft)
        layer["rms_att"] = take((spec.dim,), FloatType.F32)
        layer["rms_ffn"] = take((spec.dim,), FloatType.F32)
        if spec.arch_type == ArchType.GROK1:
            layer["rms_moe"] = take((spec.dim,), FloatType.F32)
            layer["rms_ffn2"] = take((spec.dim,), FloatType.F32)
        for name, t in layer.items():
            per_layer[name].append(t)

    rms_final = take((spec.dim,), FloatType.F32)
    wcls = take((spec.vocab_size, spec.dim), wft)

    if off != len(mm):
        raise ValueError(f"model file size mismatch: consumed {off}, file {len(mm)} "
                         "(missing/extra bytes — wrong weights float type?)")

    blocks: Params = {}
    for name, tensors in per_layer.items():
        if shapes[name][1]:
            blocks[name] = _stack(tensors, wft)
        else:
            blocks[name] = torch.from_numpy(np.stack([d for d, _ in tensors]))
    params: Params = {
        "embedding": torch.from_numpy(embedding[0]),
        "blocks": blocks,
        "rms_final": torch.from_numpy(rms_final[0]),
        "wcls": QTensor(wft, torch.from_numpy(wcls[0]),
                        None if wcls[1] is None else torch.from_numpy(wcls[1])),
    }
    return spec, params


# ---------------------------------------------------------------------------
# writer (converter back-end; byte-compatible with converter/writer.py)
# ---------------------------------------------------------------------------


def write_header(f: BinaryIO, spec: ModelSpec, weights_ftype: FloatType) -> None:
    kv: list[tuple[int, int]] = [
        (HeaderKey.VERSION, 0),
        (HeaderKey.ARCH_TYPE, int(spec.arch_type)),
        (HeaderKey.DIM, spec.dim),
        (HeaderKey.HIDDEN_DIM, spec.hidden_dim),
        (HeaderKey.N_LAYERS, spec.n_layers),
        (HeaderKey.N_HEADS, spec.n_heads),
        (HeaderKey.N_KV_HEADS, spec.n_kv_heads),
        (HeaderKey.N_EXPERTS, spec.n_experts),
        (HeaderKey.N_ACTIVE_EXPERTS, spec.n_active_experts),
        (HeaderKey.VOCAB_SIZE, spec.vocab_size),
        (HeaderKey.SEQ_LEN, spec.seq_len),
        (HeaderKey.HIDDEN_ACT, int(spec.hidden_act)),
        (HeaderKey.ROPE_THETA, int(spec.rope_theta)),
        (HeaderKey.WEIGHTS_FLOAT_TYPE, int(weights_ftype)),
    ]
    if spec.rope_type != RopeType.UNKNOWN:
        kv.append((HeaderKey.ROPE_TYPE, int(spec.rope_type)))
    if spec.rope_scaling_factor:
        kv += [
            (HeaderKey.ROPE_SCALING_FACTOR, int(spec.rope_scaling_factor)),
            (HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR, int(spec.rope_scaling_low_freq_factor)),
            (HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTOR,
             int(spec.rope_scaling_high_freq_factor)),
            (HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN, spec.rope_scaling_orig_max_seq_len),
        ]
    data = b"".join(struct.pack("<ii", k, v) for k, v in kv)
    f.write(struct.pack("<i", MAGIC))
    f.write(struct.pack("<i", 8 + len(data)))
    f.write(data)


def write_tensor(f: BinaryIO, x: np.ndarray, ftype: FloatType) -> int:
    """Flattened tensor -> reference byte stream (converter/writer.py:96-107)."""
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    if ftype == FloatType.F32:
        buf = flat.astype("<f4").tobytes()
    elif ftype == FloatType.F16:
        buf = flat.astype("<f2").tobytes()
    elif ftype == FloatType.Q40:
        buf = q40_to_bytes(*quantize_q40(flat))
    elif ftype == FloatType.Q80:
        buf = q80_to_bytes(*quantize_q80(flat))
    else:
        raise ValueError(ftype)
    f.write(buf)
    return len(buf)


def write_model(path: str, spec: ModelSpec, tensors_iter, weights_ftype: FloatType) -> None:
    """Write a `.m` from an iterator of (name, np.ndarray) in file order.

    `tensors_iter` must yield tensors in the exact order documented in load_model; norms
    and embedding are forced F32 regardless of weights_ftype (convert-llama.py:79-85).
    """
    norm_names = {"embedding", "rms_att", "rms_ffn", "rms_moe", "rms_ffn2", "rms_final"}
    with open(path, "wb") as f:
        write_header(f, spec, weights_ftype)
        for name, tensor in tensors_iter:
            ftype = FloatType.F32 if name in norm_names else weights_ftype
            write_tensor(f, tensor, ftype)


def params_file_order(spec: ModelSpec, params: Params):
    """Yield (name, array) in `.m` order from a params dict (testing / re-export)."""
    yield "embedding", params["embedding"].cpu().numpy()
    blocks = params["blocks"]

    def as_np(t, idx):
        return t.to_numpy()[idx] if isinstance(t, QTensor) else t.cpu().numpy()[idx]

    for l in range(spec.n_layers):
        for name in ("wq", "wk", "wv", "wo"):
            yield name, as_np(blocks[name], l)
        if spec.is_moe:
            yield "router", as_np(blocks["router"], l)
            for e in range(spec.n_experts):
                yield "moe_up", as_np(blocks["moe_up"], (l, e))
                yield "moe_gate", as_np(blocks["moe_gate"], (l, e))
                yield "moe_down", as_np(blocks["moe_down"], (l, e))
        else:
            for name in ("w1", "w2", "w3"):
                yield name, as_np(blocks[name], l)
        yield "rms_att", as_np(blocks["rms_att"], l)
        yield "rms_ffn", as_np(blocks["rms_ffn"], l)
        if spec.arch_type == ArchType.GROK1:
            yield "rms_moe", as_np(blocks["rms_moe"], l)
            yield "rms_ffn2", as_np(blocks["rms_ffn2"], l)
    yield "rms_final", params["rms_final"].cpu().numpy()
    wcls = params["wcls"]
    yield "wcls", wcls.to_numpy() if isinstance(wcls, QTensor) else wcls.cpu().numpy()
