"""Shared-prefix KV cache facade: radix index + block pool + leases.

The port's copy of the JAX package's cache/prefix_cache.py, without its process-wide
metric families (every per-instance `stats()` counter is kept). A finished request's
committed prefix is harvested into the host block pool (copy-out), and a new request
whose prompt shares a cached block-prefix seeds its cache rows from the pool (copy-in),
so prefill runs only on the uncached suffix. The paged engine uses the directory over
device blocks instead (cache/device_pool.py); this facade serves the dense BatchEngine
(`paged_kv=False`) and the single-sequence Engine (cache/single_slot.py).

Leases: a lookup that hits acquires the matched nodes' refcounts and returns a
`PrefixLease` the caller holds for the request's lifetime (eviction respects in-flight
requests). The seeded data is a copy, so a lease is an anti-churn pin, not a data
dependency; `shrink` releases the tail of a lease when the scheduler truncates a slot's
reusable history (clamped parks).

Locking: one lock covers the tree and the pool together — lookups come from the
BatchEngine scheduler thread and (single-slot) HTTP handler threads.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch

from .block_pool import KVBlockPool
from .radix import RadixIndex, RadixNode

__all__ = ["PrefixCache", "PrefixLease"]


@dataclass
class PrefixLease:
    """Refcount pin on the radix chain a request was seeded from. `tokens` is the seeded
    token count (may end mid-block: block data is copied, so partial use of the last
    block is free)."""

    nodes: list[RadixNode] = field(default_factory=list)
    tokens: int = 0


class PrefixCache:
    def __init__(self, max_blocks: int, block_tokens: int = 16,
                 hot_blocks: int | None = None, q80: bool = False):
        self.block_tokens = block_tokens
        self.radix = RadixIndex(block_tokens)
        self.pool = KVBlockPool(max_blocks, hot_blocks=hot_blocks, q80=q80)
        self._lock = threading.Lock()  # guards: radix, hits, misses, unused_hits, hit_tokens, resident_tokens, evicted_blocks, prompt_tokens
        # hits/hit_tokens count APPLIED seeds (mark_seeded), not mere matches — a match
        # the slot rewind already covered served nothing from the pool (mark_unused)
        self.hits = 0
        self.misses = 0
        self.unused_hits = 0
        self.hit_tokens = 0
        self.resident_tokens = 0
        self.evicted_blocks = 0
        self.prompt_tokens = 0  # all prompt tokens seen by lookup()

    # ------------------------------------------------------------------
    # lookup / release
    # ------------------------------------------------------------------

    def lookup(self, prompt: list[int], cap: int | None = None
               ) -> PrefixLease | None:
        """Longest cached block-prefix of `prompt`, as an acquired lease.

        The reuse length is capped at len(prompt) - 1 (the last prompt token must be
        re-inferred for logits) and at `cap` (callers pass seq_len - 1). Returns None on
        a miss; on a match the lease MUST be handed back exactly once: mark_seeded + a
        release at request end, or mark_unused. No block data is read here."""
        with self._lock:
            self.prompt_tokens += len(prompt)
            nodes = self.radix.match(prompt)
            n = len(nodes) * self.block_tokens
            n = min(n, len(prompt) - 1)
            if cap is not None:
                n = min(n, cap)
            if n < 1:
                self.misses += 1
                return None
            nodes = nodes[:(n + self.block_tokens - 1) // self.block_tokens]
            self.radix.acquire(nodes)
        return PrefixLease(nodes, n)

    def fetch(self, lease: PrefixLease, skip: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The lease's rows [skip, lease.tokens) as (K, V) CPU tensors of shape
        (L, hk, lease.tokens - skip, hs): views into one fetch_packed buffer."""
        packed = self.fetch_packed(lease, skip)
        return packed[0], packed[1]

    def fetch_packed(self, lease: PrefixLease, skip: int = 0) -> torch.Tensor:
        """The lease's rows [skip, lease.tokens) as ONE contiguous CPU tensor of shape
        (2, L, hk, n, hs) ([0] = K, [1] = V), each block copied straight into place, so
        a seed pays one host->device transfer.

        Runs outside the facade lock: a cold fetch dequantizes, which must not stall
        concurrent lookups/inserts. The lease's refs pin the blocks."""
        bt = self.block_tokens
        n = lease.tokens - skip
        first = skip // bt
        off = skip - first * bt
        out = None
        col = 0
        for node in lease.nodes[first:]:
            bk, bv = self.pool.get(node.handle)
            if out is None:
                L, hk, _, hs = bk.shape
                out = torch.empty((2, L, hk, n, hs), dtype=bk.dtype)
            m = min(bk.shape[2] - off, n - col)
            out[0, :, :, col:col + m] = bk[:, :, off:off + m]
            out[1, :, :, col:col + m] = bv[:, :, off:off + m]
            col += m
            off = 0
            if col >= n:
                break
        return out

    def mark_seeded(self, lease: PrefixLease, used_tokens: int) -> None:
        """The caller scattered this lease's rows: count the hit. `used_tokens` is the
        seeded span beyond what the slot's own rewind already covered."""
        with self._lock:
            self.hits += 1
            self.hit_tokens += used_tokens

    def note_resident(self, tokens: int) -> None:
        """The engine's own slot rewind covered `tokens` leading prompt tokens before the
        pool was consulted (counted apart from hit_tokens: nothing was read)."""
        if tokens <= 0:
            return
        with self._lock:
            self.resident_tokens += tokens

    def mark_unused(self, lease: PrefixLease | None) -> None:
        """The caller discarded the lease without applying it (the rewind already
        covered the match, or the seed failed): releases it, counted aside."""
        if lease is None:
            return
        with self._lock:
            self.unused_hits += 1
        self.release(lease)

    def release(self, lease: PrefixLease | None) -> None:
        if lease is None:
            return
        with self._lock:
            # take-and-clear under the lock: two racing releasers must not
            # double-decrement the refcounts
            nodes, lease.nodes = lease.nodes, []
            lease.tokens = 0
            if nodes:
                self.radix.release(nodes)

    def shrink(self, lease: PrefixLease, n_tokens: int) -> None:
        """Truncate a lease to `n_tokens`: blocks no part of [0, n_tokens) touches are
        released (the scheduler truncated the slot's reusable history)."""
        if n_tokens >= lease.tokens:
            return
        keep = (max(n_tokens, 0) + self.block_tokens - 1) // self.block_tokens
        with self._lock:
            drop, lease.nodes = lease.nodes[keep:], lease.nodes[:keep]
            lease.tokens = max(n_tokens, 0)
            if drop:
                self.radix.release(drop)

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------

    def insert(self, tokens: list[int], harvest) -> int:
        """Commit `tokens`' full blocks; returns how many NEW blocks landed.

        `harvest(t0, t1) -> (k, v)` supplies the (L, hk, t1-t0, hs) rows for positions
        [t0, t1) — called at most once, for the whole missing suffix (missing blocks are
        always a suffix: prefix-closed tree), so a device harvest pays one transfer.
        Tokens past the last full block are dropped."""
        bt = self.block_tokens
        n_blocks = len(tokens) // bt
        blocked = tokens[:n_blocks * bt]
        if n_blocks == 0:
            return 0
        with self._lock:
            prefix_nodes = self.radix.match(blocked)
            have = len(prefix_nodes)
            if have >= n_blocks:
                return 0
            # pin the existing prefix: the harvest below runs outside the lock, and the
            # batched eviction further down must never take this chain's ancestors
            self.radix.acquire(prefix_nodes)
        created = 0
        try:
            k_rows, v_rows = harvest(have * bt, n_blocks * bt)
            with self._lock:
                # a concurrent insert of the same prefix may have landed blocks
                # meanwhile; radix.insert skips them
                missing = n_blocks - len(self.radix.match(blocked))
                room = self.pool.max_blocks - len(self.pool)
                if room < missing:
                    freed = self.radix.evict(missing - room)
                    for h in freed:
                        self.pool.free(h)
                    self.evicted_blocks += len(freed)

                def make_handle(i: int) -> int | None:
                    nonlocal created
                    lo = (i - have) * bt
                    h = self.pool.put(k_rows[:, :, lo:lo + bt],
                                      v_rows[:, :, lo:lo + bt])
                    if h is not None:  # None: leases pinned the whole pool
                        created += 1
                    return h

                self.radix.insert(blocked, make_handle)
        finally:
            with self._lock:
                self.radix.release(prefix_nodes)
        return created

    def total_refs(self) -> int:
        """Live reservation count, read under the lock."""
        with self._lock:
            return self.radix.total_refs()

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """JSON-able snapshot (the JAX class's keys)."""
        with self._lock:
            looked = self.hits + self.unused_hits + self.misses
            return {
                "hits": self.hits, "misses": self.misses,
                "unused_hits": self.unused_hits,
                "hit_tokens": self.hit_tokens,
                "resident_tokens": self.resident_tokens,
                "prompt_tokens": self.prompt_tokens,
                "hit_rate": (self.hit_tokens / self.prompt_tokens
                             if self.prompt_tokens else 0.0),
                "reuse_rate": ((self.hit_tokens + self.resident_tokens)
                               / self.prompt_tokens
                               if self.prompt_tokens else 0.0),
                "lookup_hit_rate": ((self.hits + self.unused_hits) / looked
                                    if looked else 0.0),
                "evicted_blocks": self.evicted_blocks,
                "pool_blocks": len(self.pool),
                "pool_hot_blocks": self.pool.hot_count(),
                "pool_capacity_blocks": self.pool.max_blocks,
                "pool_bytes": self.pool.nbytes(),
                "demoted_blocks": self.pool.demoted_blocks,
                "tree_nodes": self.radix.nodes,
                "block_tokens": self.block_tokens,
                "q80_tier": self.pool.q80,
            }
