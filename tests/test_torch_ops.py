"""PyTorch port: elementwise ops, rope (all three styles) and the T>1 GQA attention
against the JAX package's ops on the same seeded inputs, in float32 (atol 1e-6: the same
f32 formulas, only reduction order may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import ArchType, ModelSpec, RopeType
from distributed_llama_tpu.ops import attention as jatt
from distributed_llama_tpu.ops import kernels as jk
from distributed_llama_tpu.ops import rope as jrope
from distributed_llama_tpu_torch.models.spec import ArchType as TArch
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.models.spec import RopeType as TRope
from distributed_llama_tpu_torch.ops import attention as tatt
from distributed_llama_tpu_torch.ops import kernels as tk
from distributed_llama_tpu_torch.ops import rope as trope

ATOL = 1e-6


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def test_elementwise_ops():
    x, w = _r(3, 64), _r(64, seed=1)
    _close(tk.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jk.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    _close(tk.silu(torch.from_numpy(x)), jk.silu(jnp.asarray(x)))
    _close(tk.gelu_tanh(torch.from_numpy(x)), jk.gelu_tanh(jnp.asarray(x)))
    mask = _r(3, 64, seed=2) > 0
    mask[1] = False  # a fully masked row gives zeros
    _close(tk.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask)),
           jk.masked_softmax(jnp.asarray(x), jnp.asarray(mask)))


def test_rmsnorm_bf16_activation():
    x, w = _r(2, 128), _r(128, seed=3)
    got = tk.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    want = jk.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), atol=0)


_ROPES = {
    "llama": dict(rope_type=RopeType.LLAMA),
    "falcon": dict(rope_type=RopeType.FALCON),
    "llama3_1": dict(rope_type=RopeType.LLAMA3_1, rope_theta=500000.0,
                     rope_scaling_factor=8.0, rope_scaling_low_freq_factor=1.0,
                     rope_scaling_high_freq_factor=4.0,
                     rope_scaling_orig_max_seq_len=16),
}


@pytest.mark.parametrize("style", sorted(_ROPES))
def test_rope_styles(style):
    kw = dict(dim=128, hidden_dim=256, n_layers=1, n_heads=4, n_kv_heads=2,
              vocab_size=32, seq_len=64)
    opts = _ROPES[style]
    jspec = ModelSpec(arch_type=ArchType.LLAMA, **kw, **opts).resolved()
    topts = dict(opts, rope_type=TRope(int(opts["rope_type"])))
    tspec = TSpec(arch_type=TArch.LLAMA, **kw, **topts).resolved()
    jt, tt = jrope.RopeTables.create(jspec), trope.RopeTables.create(tspec)
    _close(tt.cos, jt.cos, atol=0)
    _close(tt.sin, jt.sin, atol=0)
    x = _r(1, 5, 4, 32, seed=4)
    pos = np.arange(7, 12)
    got = trope.apply_rope(torch.from_numpy(x), tt, torch.from_numpy(pos))
    want = jrope.apply_rope(jnp.asarray(x), jt, jnp.asarray(pos))
    _close(got, want)


@pytest.mark.parametrize("t,s,g", [(1, 24, 1), (5, 24, 2), (8, 40, 4)])
def test_gqa_attention_deferred_layout(t, s, g):
    """[window slots ++ chunk] keys with stale slots pushed past seq_len, as the
    deferred-write forward passes them."""
    hk, hs, start = 2, 16, 9
    q = _r(1, t, hk * g, hs, seed=5)
    k, v = _r(1, hk, s + t, hs, seed=6), _r(1, hk, s + t, hs, seed=7)
    slot = np.arange(s)
    key_pos = np.concatenate([np.where(slot < start, slot, 1000), start + np.arange(t)])
    positions = start + np.arange(t)
    got = tatt.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(positions), torch.from_numpy(key_pos))
    want = jatt.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(positions), key_positions=jnp.asarray(key_pos))
    _close(got, want)
