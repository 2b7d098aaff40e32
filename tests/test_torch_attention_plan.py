"""PyTorch port: the launch plan of the two attention kernels (ops/attention_plan.py)
and the key assignment of csrc/attention_tile.cuh, emulated here in numpy.

The kernels deal a row's committed slots to the splits in 64-slot tiles (split j: tiles
j, j + nsplit, ...) and append the chunk keys after the row's last slot, in the split
that holds it. The emulation below mirrors that assignment (attention_block: ct_all, ct,
owner, nc, n_keys) and the merge — per split a flash (m, l, acc) carry in log2 units,
then a running-max fold in split order — so these tests check on the CPU that every
key is read exactly once and that the split-and-merge arithmetic equals the plain
version (and the JAX package's paged kernel in interpret mode) at atol 1e-5, on the
edge cases: R = T·g not a multiple of 16 (T = 5, g = 4), an empty row, pos = 0 and
pos = win, a length ending inside a tile, and 512 query rows (eight passes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_paged_attention as jpa
from distributed_llama_tpu_torch.ops import attention_plan as ap
from distributed_llama_tpu_torch.ops import paged_attention as tpa

KT = ap.TILE_SLOTS
NEG = -1e30


def block_keys(n_comm: int, t: int, nsplit: int, split: int) -> list[tuple[str, int]]:
    """The keys of one split block in list order, as attention_block walks them:
    ("slot", s) for a committed slot, ("chunk", tau) for a chunk key."""
    ct_all = -(-n_comm // KT)
    ct = -(-(ct_all - split) // nsplit) if ct_all > split else 0
    owner = split == ((ct_all - 1) % nsplit if ct_all > 0 else 0)
    nc = n_comm - (ct_all - 1) * KT + (ct - 1) * KT if owner and ct > 0 else ct * KT
    keys = [("slot", (split + (v // KT) * nsplit) * KT + v % KT) for v in range(nc)]
    return keys + [("chunk", tau) for tau in range(t if owner else 0)]


@pytest.mark.parametrize("n_comm", [0, 1, 63, 64, 65, 131, 256, 1027, 2048])
@pytest.mark.parametrize("nsplit", [1, 3, 4, 8, 32])
@pytest.mark.parametrize("t", [1, 5, 64])
def test_every_key_is_read_once(n_comm, nsplit, t):
    seen = [k for j in range(nsplit) for k in block_keys(n_comm, t, nsplit, j)]
    assert sorted(s for kind, s in seen if kind == "slot") == list(range(n_comm))
    assert sorted(s for kind, s in seen if kind == "chunk") == list(range(t))


@pytest.mark.parametrize("n_slots,rows,heads,resident,want", [
    (2048, 1, 256, 264, (1, 1)),     # 8 rows x 32 heads of serving decode: one wave
    (2048, 64, 256, 264, (1, 1)),    # 64-token chunks, the same grid
    (256, 1, 32, 264, (1, 4)),       # one-sequence decode, window 256: a split a tile
    (2048, 1, 32, 264, (1, 8)),      # window 2048: the blocks the card holds
    (2048, 4, 8, 264, (1, 32)),      # g = 4: capped at MAX_SPLITS
    (2048, 20, 8, 132, (1, 16)),     # T = 5, g = 4: R = 20 rows in one pass
    (2048, 512, 8, 264, (8, 4)),     # T = 64, g = 8: eight passes of 64 rows
    (32, 6, 12, 264, (1, 1)),        # a window inside one tile
    (0, 1, 32, 264, (1, 1)),         # nothing committed: split 0 carries the chunk
    (2048, 1, 300, 264, (1, 1)),     # more heads than the card holds: still one split
])
def test_split_plan(n_slots, rows, heads, resident, want):
    assert ap.split_plan(n_slots, rows, heads, resident) == want
    npass, nsplit = want
    assert (npass - 1) * ap.PASS_ROWS < rows <= npass * ap.PASS_ROWS
    assert 1 <= nsplit <= min(ap.MAX_SPLITS, max(1, -(-n_slots // KT)))
    assert nsplit == 1 or npass * heads * nsplit <= resident


@pytest.mark.parametrize("bad", [(-1, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0)])
def test_split_plan_rejects_empty_launches(bad):
    with pytest.raises(ValueError):
        ap.split_plan(*bad)


def _emulate(q, kw, vw, k_new, v_new, lengths, nsplit):
    """The kernel's arithmetic on dense windows: q (B, T, hq, hs), kw/vw (B, hk, win,
    hs) f64, chunk k/v (B, hk, T, hs); per (row, kv head, split) a log2-unit carry over
    the block's keys, then the running-max fold over the splits in order."""
    b, t, hq, hs = q.shape
    hk = kw.shape[1]
    g = hq // hk
    scale2 = np.log2(np.e) / np.sqrt(hs)
    out = np.zeros((b, t, hq, hs))
    for r in range(b):
        for h in range(hk):
            rows = q[r, :, h * g:(h + 1) * g].reshape(t * g, hs)  # row ti·g + gi
            ti = np.arange(t * g) // g
            parts = []
            for j in range(nsplit):
                m = np.full(t * g, NEG)
                l = np.zeros(t * g)
                acc = np.zeros((t * g, hs))
                for kind, i in block_keys(int(lengths[r]), t, nsplit, j):
                    kv = (kw, vw) if kind == "slot" else (k_new, v_new)
                    kr, vr = kv[0][r, h, i], kv[1][r, h, i]
                    s = np.where(ti >= i if kind == "chunk" else True,
                                 rows @ kr * scale2, NEG)
                    mn = np.maximum(m, s)
                    p = np.where(s == NEG, 0.0, np.exp2(s - mn))
                    al = np.exp2(m - mn)
                    l = l * al + p
                    acc = acc * al[:, None] + p[:, None] * vr[None]
                    m = mn
                parts.append((m, l, acc))
            mx = np.full(t * g, NEG)
            den = np.zeros(t * g)
            a = np.zeros((t * g, hs))
            for m, l, acc in parts:
                mn = np.maximum(mx, m)
                fo, fj = np.exp2(mx - mn), np.exp2(m - mn)
                den = den * fo + l * fj
                a = a * fo[:, None] + acc * fj[:, None]
                mx = mn
            res = (a / den[:, None]).reshape(t, g, hs)
            out[r, :, h * g:(h + 1) * g] = res
    return out


@pytest.mark.parametrize("t,g,lengths,nsplit", [
    (1, 1, [0, 1, 64, 131], 3),      # decode: an empty row, a tile's edge, mid-tile
    (5, 4, [100, 45, 63, 129], 4),   # R = 20: not a multiple of 16
    (3, 2, [20, 9, 0], 1),           # one split: the block writes the output itself
    (1, 2, [256, 128], 8),           # pos = win, more splits than the row's tiles
])
def test_split_and_merge_match_plain_and_jax(t, g, lengths, nsplit):
    rng = np.random.RandomState(len(lengths) + t + nsplit)
    bt, hk, hs = 16, 2, 32
    w = -(-(max(lengths) + t) // bt)
    b = len(lengths)
    n_blocks = b * w + 1
    kc = rng.randn(2, n_blocks, hk, bt, hs).astype(np.float32)
    vc = rng.randn(2, n_blocks, hk, bt, hs).astype(np.float32)
    tables = (np.arange(b * w, dtype=np.int32).reshape(b, w) + 1)[:, rng.permutation(w)]
    q = rng.randn(b, t, hk * g, hs).astype(np.float32)
    kn = rng.randn(b, hk, t, hs).astype(np.float32)
    vn = rng.randn(b, hk, t, hs).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    kw, vw = tpa.paged_gather_kv(torch.from_numpy(kc), torch.from_numpy(vc), 1,
                                 torch.from_numpy(tables), w)
    got = _emulate(q.astype(np.float64), kw.numpy().astype(np.float64),
                   vw.numpy().astype(np.float64), kn.astype(np.float64),
                   vn.astype(np.float64), lens, nsplit)
    plain = tpa.paged_attention_plain(*(torch.from_numpy(a) for a in (
        q, kc, vc, kn, vn, tables, lens)), 1, n_read=w).numpy()
    jax = np.asarray(jpa.paged_attention(*(jnp.asarray(a) for a in (
        q, kc, vc, kn, vn, tables, lens)), 1, n_read=w, interpret=True))
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, jax, atol=1e-5, rtol=0)
