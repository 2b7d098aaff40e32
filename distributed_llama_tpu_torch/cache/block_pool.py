"""Bounded host-side KV block store (engine-dtype hot tier + optional Q80 cold tier),
and the RAM-or-disc K/V arena of the host spill.

The port's copy of the JAX package's cache/block_pool.py: `KVBlockPool`, and
`HostKVArena`, the storage of the long-context paged engine's authoritative store
(runtime/paged_cache.py `HostKVStore`). Rows and blocks are CPU torch tensors in the
engine dtype, so bf16 keeps its exact bits (numpy has no bfloat16); a disc arena holds
bf16 in an int16 memmap viewed as bfloat16, the same raw bits as the JAX package's file.

Each block holds the committed (K, V) rows of `block_tokens` consecutive positions for
every layer — shape (L, hk, block_tokens, hs) per side: what the dense engine's admission
seed and finish harvest scatter and gather, and what the paged directory
(cache/device_pool.py) demotes a device block into.

Tiering: hot blocks keep the engine dtype bit-exactly (a hot hit reproduces the
original prefill's rows and therefore its tokens); when the hot tier overflows its
budget, the LRU hot blocks are demoted to Q80 (quantize_q80 over the flattened rows —
34 bytes per 32 values) and a cold hit pays one dequantize. Blocks whose element count
is not a multiple of the Q80 group stay hot.

The pool never evicts on its own: cache/prefix_cache.py drives eviction through the
radix index (which knows refcounts and LRU order) and calls `free` with the handles the
tree surrenders. No internal lock for the same reason — the facade's single lock covers
tree + pool together.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .wire import host_rows, q80_compress, q80_compressible, q80_restore

__all__ = ["HostKVArena", "KVBlockPool"]

# the numpy storage dtype of a memmap'd arena: bf16 has none, so its raw bits live in
# int16 and the tensor is a bfloat16 view of them
_MEMMAP_DTYPE = {torch.float32: np.float32, torch.float16: np.float16,
                 torch.bfloat16: np.int16}


class HostKVArena:
    """A (K, V) pair of CPU tensors in host RAM ("host") or over an np.memmap'd file
    pair ("disc", files `names` in `directory`). A directory this arena created itself
    (a fresh temp dir) is removed at GC or exit through weakref.finalize, never atexit
    (which would pin every arena for the process lifetime); a caller's directory is
    kept. The one storage backend of the host KV spill."""

    def __init__(self, shape: tuple, dtype: torch.dtype = torch.float32, *,
                 storage: str = "host", directory: str | None = None,
                 names: tuple[str, str] = ("key.cache", "value.cache")):
        import os

        assert storage in ("host", "disc"), storage
        self.storage = storage
        self.paths: tuple[str, str] | None = None
        self._owned_dir: str | None = None
        self._memmaps = None
        if storage == "disc":
            import shutil
            import tempfile
            import weakref

            if dtype not in _MEMMAP_DTYPE:
                raise ValueError(f"no memmap storage for {dtype}")
            if directory is None:
                directory = tempfile.mkdtemp(prefix="dlt_kv_cache_")
                self._owned_dir = directory
                self._finalizer = weakref.finalize(
                    self, shutil.rmtree, directory, ignore_errors=True)
            os.makedirs(directory, exist_ok=True)
            self.paths = (os.path.join(directory, names[0]),
                          os.path.join(directory, names[1]))
            self._memmaps = tuple(np.memmap(path, dtype=_MEMMAP_DTYPE[dtype], mode="w+",
                                            shape=tuple(shape)) for path in self.paths)
            self.k, self.v = (torch.from_numpy(mm).view(dtype) for mm in self._memmaps)
        else:
            self.k = torch.zeros(tuple(shape), dtype=dtype)
            self.v = torch.zeros(tuple(shape), dtype=dtype)

    def cleanup(self) -> None:
        """Delete the file pair and the directory IF this arena created the directory
        itself. Idempotent; detaches the GC/exit finalizer."""
        if not self._owned_dir:
            return
        self._owned_dir = None
        self.k = self.v = self._memmaps = None  # drop the memmaps before unlinking
        self._finalizer()

    def nbytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()


class _Block:
    __slots__ = ("k", "v", "kq", "vq", "shape", "dtype", "seq")

    def __init__(self, k: torch.Tensor, v: torch.Tensor, seq: int):
        self.k = k            # hot: CPU tensor (L, hk, N, hs); None when cold
        self.v = v
        self.kq = None        # cold: (values int8, scales f16) of the flat rows
        self.vq = None
        self.shape = tuple(k.shape)
        self.dtype = k.dtype
        self.seq = seq        # hot-LRU clock value of the last touch

    @property
    def cold(self) -> bool:
        return self.k is None

    def nbytes(self) -> int:
        if self.cold:
            return sum(q[0].nbytes + q[1].nbytes for q in (self.kq, self.vq))
        return self.k.nbytes + self.v.nbytes


class KVBlockPool:
    def __init__(self, max_blocks: int, hot_blocks: int | None = None,
                 q80: bool = False):
        assert max_blocks >= 1
        self.max_blocks = max_blocks
        # q80 off => everything stays hot (the bit-exact default)
        self.hot_blocks = (max_blocks if not q80
                           else max(1, hot_blocks if hot_blocks is not None
                                    else max_blocks // 4))
        self.q80 = q80
        self._blocks: dict[int, _Block] = {}
        self._next_handle = 0
        # LRU clock. itertools.count: get() runs outside the facade lock
        # (prefix_cache.fetch) concurrently with locked put/demote
        self._seq = itertools.count(1)
        self.demoted_blocks = 0  # lifetime hot->Q80 demotions (stats)
        # listener(event, handle or handles, tag): "put" (a block landed under the
        # handle, from the rows the caller tagged), "free" and "q80" (blocks demoted to
        # the Q80 tier). A tp leader's BatchEngine sets it, so every follower's
        # ShadowBlockPool takes the same decisions for its own KV heads
        self.listener = None

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def full(self) -> bool:
        return len(self._blocks) >= self.max_blocks

    def hot_count(self) -> int:
        return sum(1 for b in self._blocks.values() if not b.cold)

    def nbytes(self) -> int:
        return sum(b.nbytes() for b in self._blocks.values())

    # ------------------------------------------------------------------

    def put(self, k, v, tag: int = 0) -> int | None:
        """Commit one block (copies taken; tensors on any device, or numpy arrays);
        returns a handle, or None when the pool is at capacity (caller evicts via the
        radix index and retries). `tag` goes to the listener: the block's first token
        within the rows the caller read (ShadowBlockPool.put)."""
        if self.full:
            return None
        assert tuple(k.shape) == tuple(v.shape)
        h = self._next_handle
        self._next_handle += 1
        self._blocks[h] = _Block(host_rows(k), host_rows(v), next(self._seq))
        if self.listener is not None:
            self.listener("put", h, tag)
        self._maybe_demote()
        return h

    def get(self, handle: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Block data in its original dtype/shape; a cold block dequantizes (Q80
        round-trip precision, not bit-exact). Tolerates a concurrent demotion between
        the tier check and the read (demotion sets kq/vq before clearing k/v)."""
        b = self._blocks[handle]
        b.seq = next(self._seq)
        k, v = b.k, b.v
        if k is not None and v is not None:
            return k, v
        k = q80_restore(b.kq, b.shape, b.dtype)
        v = q80_restore(b.vq, b.shape, b.dtype)
        return k, v

    def is_cold(self, handle: int) -> bool:
        return self._blocks[handle].cold

    def free(self, handle: int) -> None:
        del self._blocks[handle]
        if self.listener is not None:
            self.listener("free", handle, 0)

    # ------------------------------------------------------------------

    def _maybe_demote(self) -> None:
        if not self.q80:
            return
        import heapq

        hot = [b for b in self._blocks.values() if not b.cold]
        excess = len(hot) - self.hot_blocks
        if excess <= 0:
            return
        compressible = (b for b in hot if q80_compressible(b.shape))
        demoted = heapq.nsmallest(excess, compressible, key=lambda b: b.seq)
        for b in demoted:
            b.kq = q80_compress(b.k)
            b.vq = q80_compress(b.v)
            b.k = b.v = None
            self.demoted_blocks += 1
        if demoted and self.listener is not None:
            ids = {id(b) for b in demoted}
            self.listener("q80", [h for h, b in self._blocks.items() if id(b) in ids], 0)


class ShadowBlockPool:
    """A tp follower's host tier: the blocks of its own KV heads under the handles its
    leader's KVBlockPool gave out, with the leader's decisions replayed (parallel/
    replay.py): `read` holds the rows the leader's next puts take (a demoted pool block
    or a harvested span), `put` files a block of them under the leader's handle, `q80`
    moves blocks to the Q80 tier as the leader's LRU did, `free` drops one. No policy of
    its own: every rank's tier holds its heads of the same blocks in the same tier."""

    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self._rows: tuple | None = None  # (k, v) host rows (L, hk, n, hs) last read
        self._blocks: dict[int, _Block] = {}

    def read(self, k, v) -> None:
        self._rows = (host_rows(k), host_rows(v))

    def put(self, handle: int, tag: int) -> None:
        k, v = self._rows
        bt = self.block_tokens
        self._blocks[handle] = _Block(k[:, :, tag:tag + bt].clone(),
                                      v[:, :, tag:tag + bt].clone(), 0)

    def q80(self, handles) -> None:
        for h in handles:
            b = self._blocks[h]
            b.kq, b.vq = q80_compress(b.k), q80_compress(b.v)
            b.k = b.v = None

    def free(self, handle: int) -> None:
        del self._blocks[handle]

    def get(self, handle: int) -> tuple[torch.Tensor, torch.Tensor]:
        b = self._blocks[handle]
        if not b.cold:
            return b.k, b.v
        return q80_restore(b.kq, b.shape, b.dtype), q80_restore(b.vq, b.shape, b.dtype)
