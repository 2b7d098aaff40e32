"""PyTorch port: the plain versions of the three CUDA kernels against the JAX package's
Pallas kernels run in interpret mode, on the same seeded inputs.

- q4_matvec: the Q80 row quantizer is bit-identical; y within rtol 1e-5 plus
  atol 1e-5·max|y| (the integer block dots are exact, the f32 sum over blocks is taken in
  another order).
- q4_matmul: bf16 operands rounded identically, f32 sums in another order: rtol 1e-5,
  atol 1e-5·max|y|.
- decode_attention: f32 softmax in both; atol 1e-5, against both the one-block and the
  window-tiled forms of the TPU kernel, with the position and layer given as ints or
  as one-element tensors (as the forward pass hands them to the kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_attention
from distributed_llama_tpu.ops.pallas_q4 import q4_matvec as j_q4_matvec
from distributed_llama_tpu.ops.pallas_q4_mm import q4_matmul as j_q4_matmul
from distributed_llama_tpu.ops.pallas_q8 import _quantize_row
from distributed_llama_tpu.quants import FloatType, QTensor
from distributed_llama_tpu_torch.ops import decode_attention as tda
from distributed_llama_tpu_torch.ops import q4_matmul as tmm
from distributed_llama_tpu_torch.ops import q4_matvec as tmv
from distributed_llama_tpu_torch.ops.matmul import kernel_selections, qmatmul
from distributed_llama_tpu_torch.quants import QTensor as TQTensor


def _i4p(n, k, seed):
    rng = np.random.RandomState(seed)
    w = QTensor.from_float(rng.randn(n, k).astype(np.float32) * 0.02,
                           FloatType.Q40).to_i4p_layout()
    packed = torch.from_numpy(np.asarray(w.data))
    scales = torch.from_numpy(np.asarray(w.scales).view(np.float16))
    return w, packed, scales


def _close_scaled(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_quantize_row_bit_identical():
    for seed, scale in ((0, 1.0), (1, 37.0), (2, 1e-3)):
        x = np.random.RandomState(seed).randn(256).astype(np.float32) * scale
        x[:32] = 0.0  # an all-zero block quantizes to zeros with a zero scale
        jq, js = _quantize_row(jnp.asarray(x), 8)
        tq, ts = tmv.quantize_row(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])


@pytest.mark.parametrize("n,k", [(96, 256), (40, 704)])
def test_q4_matvec_plain_matches_pallas(n, k):
    w, packed, scales = _i4p(n, k, seed=n)
    x = np.random.RandomState(k).randn(1, k).astype(np.float32)
    before = tmv.launches
    want = j_q4_matvec(jnp.asarray(x), w, interpret=True)
    got = tmv.q4_matvec(torch.from_numpy(x), TQTensor(w.ftype, packed, scales, "i4p"))
    assert got.shape == (1, n)
    _close_scaled(got.numpy(), want)
    assert tmv.launches == before  # CPU tensors take the plain version, never the kernel


@pytest.mark.parametrize("m,n,k", [(8, 96, 256), (3, 130, 512)])
def test_q4_matmul_plain_matches_pallas(m, n, k):
    w, packed, scales = _i4p(n, k, seed=m)
    x = np.random.RandomState(n).randn(m, k).astype(np.float32)
    before = tmm.launches
    want = j_q4_matmul(jnp.asarray(x), w, out_dtype=jnp.float32, interpret=True)
    got = tmm.q4_matmul(torch.from_numpy(x), TQTensor(w.ftype, packed, scales, "i4p"),
                        out_dtype=torch.float32)
    _close_scaled(got.numpy(), want)
    assert tmm.launches == before


def test_qmatmul_dispatch_selects_kernels():
    # K = 256: K/2 = 128 passes the M > 1 kernel's shape gate (q4_mm_supported)
    w, packed, scales = _i4p(64, 256, seed=3)
    tw = TQTensor(w.ftype, packed, scales, "i4p")
    x1, x4 = torch.randn(1, 1, 256), torch.randn(1, 4, 256)
    qmatmul(x1, tw, use_kernels=True)
    qmatmul(x4, tw, use_kernels=True)
    qmatmul(x4, tw, use_kernels="all")
    sel = kernel_selections()
    assert sel["m=1,n=64,k=256,layout=i4p,op=mm"] == "q4_matvec"
    assert sel["m=4,n=64,k=256,layout=i4p,op=mm"] == "q4_mm"
    # the dequantize path equals the dequantized weights' f32 product
    got = qmatmul(x4, tw, use_kernels=False)
    want = x4 @ tw.dequantize(torch.float32).T
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _attn_inputs(hk, g, hs, s, seed):
    rng = np.random.RandomState(seed)
    kc = rng.randn(3, 1, hk, s, hs).astype(np.float32)
    vc = rng.randn(3, 1, hk, s, hs).astype(np.float32)
    kn = rng.randn(hk, 1, hs).astype(np.float32)
    vn = rng.randn(hk, 1, hs).astype(np.float32)
    q = rng.randn(hk, g, hs).astype(np.float32)
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("pos,window", [(0, 32), (5, 32), (31, 32), (32, 64), (50, 64)])
def test_decode_attention_plain_matches_pallas(monkeypatch, tiled, pos, window):
    if tiled:  # force the window-tiled flash form with 16-slot tiles
        monkeypatch.setattr(pallas_attention, "_FUSED_ONE_BLOCK_LIMIT", 0)
        monkeypatch.setattr(pallas_attention, "_WT", 16)
    q, kc, vc, kn, vn = _attn_inputs(2, 2, 32, 64, seed=pos + window)
    before = tda.launches
    want = pallas_attention.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
        jnp.asarray(vn), 1, pos, window=window, interpret=True)
    got = tda.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), 1, pos,
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert tda.launches == before


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("pos,window", [(0, 32), (5, 32), (32, 32), (50, 64)])
def test_decode_attention_takes_device_style_position(monkeypatch, tiled, pos, window):
    """pos and layer_idx as one-element tensors (int64 and int32, the forward pass's
    step positions and layer ids) give the int call's result, and the TPU kernel's."""
    if tiled:
        monkeypatch.setattr(pallas_attention, "_FUSED_ONE_BLOCK_LIMIT", 0)
        monkeypatch.setattr(pallas_attention, "_WT", 16)
    q, kc, vc, kn, vn = _attn_inputs(2, 4, 32, 64, seed=3 * pos + window)
    ts = [torch.from_numpy(a) for a in (q, kc, vc, kn, vn)]
    want = pallas_attention.fused_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, kn, vn)), 2, pos, window=window,
        interpret=True)
    by_int = tda.decode_attention(*ts, 2, pos, window=window)
    by_tensor = tda.decode_attention(*ts, torch.tensor([2], dtype=torch.int32),
                                     torch.tensor([pos], dtype=torch.int64), window=window)
    torch.testing.assert_close(by_tensor, by_int, rtol=0, atol=0)
    np.testing.assert_allclose(by_tensor.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_decode_attention_plain_masks_stale_values():
    """A NaN left in a slot at or past pos reaches neither the scores nor the values."""
    q, kc, vc, kn, vn = _attn_inputs(2, 1, 32, 16, seed=1)
    clean = tda.decode_attention_plain(*(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)),
                                       0, 5, 16)
    kc[0, 0, :, 5:] = np.nan
    vc[0, 0, :, 5:] = np.nan
    dirty = tda.decode_attention_plain(*(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)),
                                       0, 5, 16)
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)
