"""PyTorch port: the device block pool's host metadata (cache/device_pool.py) against the
JAX package's DeviceKVPool under one seeded random sequence of alloc / incref / decref:
identical results, refcounts and free lists after every operation."""

import numpy as np
import pytest

from distributed_llama_tpu.cache.device_pool import DeviceKVPool as JPool
from distributed_llama_tpu_torch.cache.device_pool import (SCRATCH_BLOCK, DeviceKVPool,
                                                           KVPoolExhausted)
from distributed_llama_tpu_torch.resilience.errors import classify


def test_pool_matches_jax_under_random_operations():
    rng = np.random.RandomState(0)
    jp, tp = JPool(17, 16), DeviceKVPool(17, 16)
    held: list[int] = []  # one entry per reference the test holds
    for step in range(400):
        op = rng.choice(["alloc", "incref", "decref"], p=[0.4, 0.2, 0.4])
        if op == "alloc":
            n = int(rng.randint(1, 6))
            got, want = tp.alloc(n), jp.alloc(n)
            assert got == want, step
            held += got or []
        elif op == "incref" and held:
            ids = [held[i] for i in rng.choice(len(held), size=min(3, len(held)),
                                               replace=False)]
            tp.incref(ids)
            jp.incref(ids)
            held += ids
        elif op == "decref" and held:
            idx = sorted(rng.choice(len(held), size=min(3, len(held)), replace=False),
                         reverse=True)
            ids = [held.pop(i) for i in idx]
            assert tp.decref(ids) == jp.decref(ids), step
        np.testing.assert_array_equal(tp.refcounts(), jp.refcounts())
        assert tp._free == jp._free, step
        assert tp.free_blocks() == jp.free_blocks(), step
        assert tp.refcounts()[SCRATCH_BLOCK] == 1


def test_scratch_block_is_never_freed_and_exhaustion_is_request_scoped():
    pool = DeviceKVPool(3, 4)
    assert pool.alloc(3) is None and pool.alloc(2) == [1, 2]
    with pytest.raises(AssertionError):
        pool.decref([SCRATCH_BLOCK])
    assert classify(KVPoolExhausted("full")) == "request"
    assert classify(RuntimeError("device fault")) == "engine"
