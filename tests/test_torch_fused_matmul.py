"""PyTorch port: the fused serving epilogues and the M > 1 routing of ops/matmul.py
against the JAX package on the same seeded numpy weights.

- `q4_matmul_res_plain` against JAX `_q4_matmul_res` and `q4_gated_matmul_plain` (silu
  and gelu_tanh) against JAX `_q4_gated_matmul`, both Pallas kernels in interpret mode.
  Both sides use bf16 operands and float32 sums in another order: max|Δ| <= 1e-5·max|y|
  (the measured gap is ~1e-7·max), and every row's argmax is identical.
- Routing: `qmatmul` at use_kernels="all" takes the kernel only where the JAX package's
  shape gate `q4_mm_supported` does (K/2 a multiple of 128, M <= 512); elsewhere both
  compute the f32 dequantize product and agree to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import matmul as jmm
from distributed_llama_tpu.ops import pallas_q4_mm as jq4
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.quants import QTensor as JQTensor
from distributed_llama_tpu_torch.ops import matmul as tmm
from distributed_llama_tpu_torch.ops import q4_gated_matmul as tg
from distributed_llama_tpu_torch.ops import q4_matmul as tq4
from distributed_llama_tpu_torch.quants import QTensor

K = 512  # K/2 = 256: one 256-wide K tile of the JAX kernel


def _weights(n, k, seed):
    """(JAX i4p QTensor, port i4p QTensor) of the same seeded weights."""
    rng = np.random.RandomState(seed)
    jw = JQTensor.from_float(rng.randn(n, k).astype(np.float32) * 0.02,
                             FloatType.Q40).to_i4p_layout()
    data = np.asarray(jw.data)
    scales = np.asarray(jw.scales).view(np.float16)
    tw = QTensor(FloatType.Q40, torch.from_numpy(data.copy()),
                 torch.from_numpy(scales.copy()), layout="i4p")
    return jax.tree_util.tree_map(jnp.asarray, jw), tw


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_residual_plain_matches_jax_interpret():
    m, n = 8, 384
    jw, tw = _weights(n, K, seed=1)
    rng = np.random.RandomState(2)
    x = (rng.randn(m, K) * 0.5).astype(np.float32)
    res = (rng.randn(m, n) * 0.1).astype(np.float32)
    want = jq4._q4_matmul_res(jnp.asarray(x), jw.data, jw.scales, jnp.asarray(res),
                              interpret=True)
    got = tq4.q4_matmul_res_plain(torch.from_numpy(x), tw.data, tw.scales,
                                  torch.from_numpy(res))
    _close(got.numpy(), want)
    # the wrapper's residual mode on CPU tensors is the same plain version
    y = tq4.q4_matmul(torch.from_numpy(x), tw, out_dtype=torch.float32,
                      residual=torch.from_numpy(res))
    np.testing.assert_array_equal(y.numpy(), got.numpy())


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_gated_plain_matches_jax_interpret(act):
    m, n = 8, 384
    jw1, tw1 = _weights(n, K, seed=3)
    jw3, tw3 = _weights(n, K, seed=4)
    x = (np.random.RandomState(5).randn(m, K) * 0.5).astype(np.float32)
    want = jq4._q4_gated_matmul(jnp.asarray(x), jw1.data, jw1.scales, jw3.data,
                                jw3.scales, act=act, interpret=True)
    got = tg.q4_gated_matmul_plain(torch.from_numpy(x), (tw1.data, tw1.scales),
                                   (tw3.data, tw3.scales), act)
    _close(got.numpy(), want)


@pytest.mark.parametrize("m,k", [(4, 192), (520, 256), (8, 256)])
def test_routing_follows_jax_shape_gate(m, k):
    """K = 192 (K/2 = 96, not a multiple of 128) and M = 520 (> 512) take the
    dequantize route in both packages; M = 8, K = 256 takes the kernel in both."""
    jw, tw = _weights(64, k, seed=m + k)
    x = np.random.RandomState(6).randn(m, k).astype(np.float32)
    jmm.reset_kernel_selections()
    tmm.reset_kernel_selections()
    want = np.asarray(jmm.qmatmul(jnp.asarray(x), jw, use_pallas="all"))
    got = tmm.qmatmul(torch.from_numpy(x), tw, use_kernels="all").numpy()
    kernel = jq4.q4_mm_supported(jw, m)
    assert tmm.q4_mm_supported(tw, m) == kernel
    assert set(tmm.kernel_selections().values()) == {"q4_mm" if kernel else "dequant"}
    assert set(jmm.kernel_selections().values()) == {"q4_mm" if kernel else "xla"}
    if kernel:
        _close(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
