"""Model hyperparameter spec — equivalent of the reference's TransformerSpec.

Mirrors the reference header schema (src/transformer.hpp:10-90, parsing at
src/transformer.cpp:12-148): same arch types, activation enum, rope types, derived
head_size/kv_dim, seq-len clamping, and the `.m` header key numbering (used by
formats/mfile.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class ArchType(enum.IntEnum):
    """Reference: src/transformer.hpp:44-48 (also the legacy file magics)."""

    LLAMA = 0xABCD00
    GROK1 = 0xABCD01
    MIXTRAL = 0xABCD02


class HiddenAct(enum.IntEnum):
    GELU = 0
    SILU = 1


class RopeType(enum.IntEnum):
    UNKNOWN = -1
    LLAMA = 0
    FALCON = 1
    LLAMA3_1 = 2


# .m header key ids (reference: src/transformer.hpp:10-30 / converter/writer.py:109-130)
class HeaderKey(enum.IntEnum):
    VERSION = 0
    ARCH_TYPE = 1
    DIM = 2
    HIDDEN_DIM = 3
    N_LAYERS = 4
    N_HEADS = 5
    N_KV_HEADS = 6
    N_EXPERTS = 7
    N_ACTIVE_EXPERTS = 8
    VOCAB_SIZE = 9
    SEQ_LEN = 10
    HIDDEN_ACT = 11
    ROPE_THETA = 12
    WEIGHTS_FLOAT_TYPE = 13
    ROPE_SCALING_FACTOR = 14
    ROPE_SCALING_LOW_FREQ_FACTOR = 15
    ROPE_SCALING_HIGH_FREQ_FACTOR = 16  # reference spells this "FACTORY"
    ROPE_SCALING_ORIG_MAX_SEQ_LEN = 17
    ROPE_TYPE = 18


@dataclass(frozen=True)
class ModelSpec:
    arch_type: ArchType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    n_experts: int = 0
    n_active_experts: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    rope_type: RopeType = RopeType.UNKNOWN
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    orig_seq_len: int = 0
    version: int = 0
    norm_eps: float = 1e-5

    # --- derived (reference: transformer.cpp:102-106) ---
    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def q_group(self) -> int:
        """GQA group size: query heads per kv head."""
        return self.n_heads // self.n_kv_heads

    def resolved(self, max_seq_len: int = 0) -> "ModelSpec":
        """Fill in defaults the way loadSpecFromFile does (transformer.cpp:88-106)."""
        spec = self
        if spec.rope_type == RopeType.UNKNOWN:
            if spec.arch_type == ArchType.LLAMA:
                spec = replace(spec, rope_type=RopeType.LLAMA)
            elif spec.arch_type in (ArchType.GROK1, ArchType.MIXTRAL):
                spec = replace(spec, rope_type=RopeType.FALCON)
            else:
                raise ValueError(f"cannot resolve rope type for arch {spec.arch_type}")
        orig = spec.orig_seq_len or spec.seq_len
        seq = spec.seq_len
        if max_seq_len > 0 and seq > max_seq_len:
            seq = max_seq_len
        spec = replace(spec, seq_len=seq, orig_seq_len=orig)
        assert spec.dim % spec.n_heads == 0, (spec.dim, spec.n_heads)
        assert spec.n_heads % spec.n_kv_heads == 0, (spec.n_heads, spec.n_kv_heads)
        return spec

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0
