"""Device-resident paged KV: the host metadata of the block pool.

A copy of the JAX package's cache/device_pool.py `DeviceKVPool`, `KVPoolExhausted` and
`SCRATCH_BLOCK`, without its metrics and without the radix directory
(`PagedPrefixCache`), which the port does not have yet. KV lives in a device POOL of
fixed-size blocks, (L, N, hk, block_tokens, hs) per side, and each slot carries a BLOCK
TABLE mapping virtual positions [0, seq_len) to pool blocks (position p lives in block
table[p // bt] at offset p % bt). The tensors stay on the Engine; this module owns the
refcounts and the free list over the N block ids.

Block 0 is a permanent SCRATCH block: idle rows park their masked garbage writes there
and unpopulated table entries point at it, so a dispatch never needs a "no block"
sentinel. A block with refcount 1 is exclusively owned by its holder and may be written.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["DeviceKVPool", "KVPoolExhausted", "SCRATCH_BLOCK"]

SCRATCH_BLOCK = 0  # permanent garbage target; never allocated, never read


class KVPoolExhausted(RuntimeError):
    """The device block pool could not serve an allocation even after reclaiming idle
    slots. Attributable to the request whose growth needed the blocks: the scheduler
    fails only it."""

    fault_scope = "request"


class DeviceKVPool:
    """Refcount + free-list metadata for the device block pool. The tensors live on the
    Engine; `n_blocks` must match their N axis."""

    def __init__(self, n_blocks: int, block_tokens: int):
        assert n_blocks >= 2, "pool needs the scratch block plus one real block"
        assert block_tokens >= 1
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self._lock = threading.Lock()  # guards: _refs, _free
        self._refs = np.zeros(n_blocks, np.int32)
        self._refs[SCRATCH_BLOCK] = 1  # permanently pinned, never allocatable
        self._free = list(range(n_blocks - 1, 0, -1))  # stack, low ids first out

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n blocks (refcount 1 each), all-or-nothing. None when fewer than n
        are free — the caller reclaims and retries."""
        with self._lock:
            if len(self._free) < n:
                return None
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                assert self._refs[b] == 0, (b, int(self._refs[b]))
                self._refs[b] = 1
            return ids

    def incref(self, ids) -> None:
        with self._lock:
            for b in ids:
                assert self._refs[b] > 0, f"incref on free block {b}"
                self._refs[b] += 1

    def decref(self, ids) -> int:
        """Drop one reference per id; blocks reaching zero return to the free list.
        Returns how many were freed."""
        freed = 0
        with self._lock:
            for b in ids:
                assert b != SCRATCH_BLOCK and self._refs[b] > 0, (b, int(self._refs[b]))
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    self._free.append(b)
                    freed += 1
        return freed

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def refcounts(self) -> np.ndarray:
        """Snapshot for tests/stats."""
        with self._lock:
            return self._refs.copy()
