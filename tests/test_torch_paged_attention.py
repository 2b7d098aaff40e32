"""PyTorch port: paged attention over the block pool (ops/paged_attention.py) against the
JAX package's ops/pallas_paged_attention.py on the same seeded numpy inputs.

- `paged_attention_plain` against the Pallas kernel in interpret mode, with NaN written
  into the scratch block, into blocks no table uses, and into the rows of live blocks
  at or past a row's length: max|Δ| < 2e-5 (the gate of perf/paged_attn_bench.py).
- Without NaN, against `paged_attention_xla` (the gather + dense attention oracle):
  max|Δ| < 2e-5.
- `paged_gather_kv` equals the JAX gather exactly.
Ragged lengths include an empty row; T in {1, 5}, GQA groups g in {1, 2}."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_paged_attention as jpa
from distributed_llama_tpu_torch.ops import paged_attention as tpa

L, N, BT, HS, HK = 2, 12, 4, 16, 2
LENGTHS = [0, 5, 13]  # ragged, one empty row
W = 5  # table entries per row; 13 + T=5 positions fit in 5 blocks of 4


def _inputs(t: int, g: int, nan: bool, seed: int = 0):
    rng = np.random.RandomState(seed)
    b = len(LENGTHS)
    kc = rng.randn(L, N, HK, BT, HS).astype(np.float32)
    vc = rng.randn(L, N, HK, BT, HS).astype(np.float32)
    tables = np.zeros((b, W), np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for r, n in enumerate(LENGTHS):
        nb = -(-n // BT)
        tables[r, :nb] = perm[used:used + nb]
        used += nb
    if nan:
        live = set(tables[tables > 0].tolist())
        for blk in range(N):
            if blk not in live:  # the scratch block 0 and blocks no table holds
                kc[:, blk] = np.nan
                vc[:, blk] = np.nan
        for r, n in enumerate(LENGTHS):
            if n % BT:  # garbage rows of a live block past the row's length
                kc[:, tables[r, n // BT], :, n % BT:] = np.nan
                vc[:, tables[r, n // BT], :, n % BT:] = np.nan
    q = rng.randn(b, t, HK * g, HS).astype(np.float32)
    k_new = rng.randn(b, HK, t, HS).astype(np.float32)
    v_new = rng.randn(b, HK, t, HS).astype(np.float32)
    return q, kc, vc, k_new, v_new, tables, np.asarray(LENGTHS, np.int32)


def _port(q, kc, vc, k_new, v_new, tables, lengths, layer):
    t = [torch.from_numpy(a) for a in (q, kc, vc, k_new, v_new, tables, lengths)]
    return tpa.paged_attention_plain(*t, layer, n_read=W).numpy()


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_matches_jax_kernel_interpret_with_nan_garbage(t, g):
    args = _inputs(t, g, nan=True, seed=10 * t + g)
    want = np.asarray(jpa.paged_attention(*[jnp.asarray(a) for a in args], 1,
                                          n_read=W, interpret=True))
    got = _port(*args, 1)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_matches_jax_xla_oracle(t, g):
    args = _inputs(t, g, nan=False, seed=7 + t + g)
    want = np.asarray(jpa.paged_attention_xla(*[jnp.asarray(a) for a in args], 0,
                                              n_read=W))
    got = _port(*args, 0)
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("g", [1, 2])
def test_plain_matches_jax_kernel_when_the_window_ends_inside_the_chunk(g):
    """n_read = 4 blocks (16 slots) holds every committed row (13 at most), but the
    chunk of 5 reaches position 17: a slot past a row's length must stay masked there
    too, as the kernel never reads it (NaN garbage in it must not reach the output)."""
    args = _inputs(5, g, nan=True, seed=40 + g)
    want = np.asarray(jpa.paged_attention(*[jnp.asarray(a) for a in args], 1,
                                          n_read=4, interpret=True))
    t = [torch.from_numpy(a) for a in args]
    got = tpa.paged_attention_plain(*t, 1, n_read=4).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 2e-5
    np.testing.assert_allclose(got, _port(*args, 1), atol=1e-6, rtol=0)


def test_gather_matches_jax_and_cpu_route_is_plain():
    q, kc, vc, k_new, v_new, tables, lengths = _inputs(3, 2, nan=False, seed=3)
    jk, jv = jpa.paged_gather_kv(jnp.asarray(kc), jnp.asarray(vc), 1,
                                 jnp.asarray(tables), 4)
    tk, tv = tpa.paged_gather_kv(torch.from_numpy(kc), torch.from_numpy(vc), 1,
                                 torch.from_numpy(tables), 4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    before = tpa.launches
    ts = [torch.from_numpy(a) for a in (q, kc, vc, k_new, v_new, tables, lengths)]
    out = tpa.paged_attention(*ts, torch.tensor([1], dtype=torch.int32), n_read=W)
    assert tpa.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(out.numpy(), _port(q, kc, vc, k_new, v_new, tables,
                                                     lengths, 1))
