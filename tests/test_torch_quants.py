"""PyTorch port: Q40/Q80 codecs, QTensor layouts and the i4p repack against the JAX
package (distributed_llama_tpu/quants.py, models/params.py) on the same seeded inputs.
Codecs and layouts are integer/discrete, so parity is exact (bytes and bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu import quants as jq
from distributed_llama_tpu.models import params as jparams
from distributed_llama_tpu.models.spec import ArchType, ModelSpec
from distributed_llama_tpu_torch import quants as tq
from distributed_llama_tpu_torch.models import params as tparams
from distributed_llama_tpu_torch.models.spec import ArchType as TArch
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec


def _x(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 64), (3, 2, 128)])
def test_q40_q80_codecs_byte_identical(shape):
    x = _x(shape)
    p_j, s_j = jq.quantize_q40(x)
    p_t, s_t = tq.quantize_q40(x)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(s_t.view(np.int16), s_j.view(np.int16))
    buf = tq.q40_to_bytes(p_t, s_t)
    assert buf == jq.q40_to_bytes(p_j, s_j)
    p2, s2 = tq.q40_from_bytes(buf, shape)
    np.testing.assert_array_equal(p2, p_j)
    np.testing.assert_array_equal(tq.dequantize_q40(p2, s2), jq.dequantize_q40(p_j, s_j))

    v_j, d_j = jq.quantize_q80(x)
    v_t, d_t = tq.quantize_q80(x)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(d_t.view(np.int16), d_j.view(np.int16))
    buf = tq.q80_to_bytes(v_t, d_t)
    assert buf == jq.q80_to_bytes(v_j, d_j)
    v2, d2 = tq.q80_from_bytes(buf, shape)
    np.testing.assert_array_equal(v2, v_j)
    np.testing.assert_array_equal(tq.dequantize_q80(v2, d2), jq.dequantize_q80(v_j, d_j))


@pytest.mark.parametrize("col_groups", [1, 2])
def test_i4p_planes_byte_identical_and_dequantize_equal(col_groups):
    x = _x((2, 6, 256), seed=1)
    jt = jq.QTensor.from_float(x, jq.FloatType.Q40)
    tt = tq.QTensor.from_float(x, tq.FloatType.Q40)
    np.testing.assert_array_equal(tt.to_numpy(), jt.to_numpy())
    ji = jt.to_i4p_layout(col_groups=col_groups)
    ti = tt.to_i4p_layout(col_groups=col_groups)
    assert ti.shape == ji.shape and ti.groups == ji.groups == col_groups
    np.testing.assert_array_equal(ti.data.numpy(), np.asarray(ji.data))
    # i4p scales: the JAX package keeps the f16 bits as int16; the port views them as f16
    np.testing.assert_array_equal(ti.scales.numpy().view(np.int16), np.asarray(ji.scales))
    np.testing.assert_array_equal(ti.to_numpy(), ji.to_numpy())
    np.testing.assert_array_equal(ti.to_numpy(), tt.to_numpy())
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = ti.dequantize(dtype).float().numpy()
        want = np.asarray(ji.dequantize(jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


def test_q80_qtensor_dequantize_equal():
    x = _x((5, 96), seed=2)
    jt = jq.QTensor.from_float(x, jq.FloatType.Q80)
    tt = tq.QTensor.from_float(x, tq.FloatType.Q80)
    assert tt.shape == jt.shape == (5, 96)
    np.testing.assert_array_equal(tt.to_numpy(), jt.to_numpy())
    np.testing.assert_array_equal(tt.dequantize(torch.float32).numpy(),
                                  np.asarray(jt.dequantize(jnp.float32)))


def test_prepare_for_cuda_matches_prepare_for_pallas():
    """Fused wqkv/w13 and the i4p repack give the JAX package's planes byte for byte."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=96, seq_len=32)
    jspec = ModelSpec(arch_type=ArchType.LLAMA, **kw).resolved()
    tspec = TSpec(arch_type=TArch.LLAMA, **kw).resolved()
    jp = jparams.prepare_for_pallas(jparams.init_random_params(jspec, jq.FloatType.Q40,
                                                               seed=4), spec=jspec)
    tp = tparams.prepare_for_cuda(tparams.init_random_params(tspec, tq.FloatType.Q40,
                                                             seed=4))
    assert set(tp["blocks"]) == set(jp["blocks"]) >= {"wqkv", "w13", "wo", "w2"}
    for name, jt in list(jp["blocks"].items()) + [("wcls", jp["wcls"])]:
        tt = tp["wcls"] if name == "wcls" else tp["blocks"][name]
        if isinstance(jt, jq.QTensor):
            assert tt.layout == jt.layout == "i4p", name
            np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
            np.testing.assert_array_equal(tt.scales.numpy().view(np.int16),
                                          np.asarray(jt.scales))
        else:
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tparams.decode_stream_bytes(tp) == jparams.decode_stream_bytes(jp, jspec)
