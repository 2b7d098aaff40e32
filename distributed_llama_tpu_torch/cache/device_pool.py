"""Device-resident paged KV: block-pool metadata + the radix *directory*.

The port's copy of the JAX package's cache/device_pool.py, with its process-wide metric
families beside every per-instance counter and `stats()` key. KV lives in a
device POOL of fixed-size blocks, (L, N, hk, block_tokens, hs) per side, and each slot
carries a BLOCK TABLE mapping virtual positions [0, seq_len) to pool blocks (position p
lives in block table[p // bt] at offset p % bt). The tensors stay on the Engine and are
only ever written in place (the captured decode steps read the storage they saw); this
module owns the host metadata:

- `DeviceKVPool` — refcounts + free list over the N block ids. Block 0 is a permanent
  SCRATCH block: idle rows park their masked garbage writes there and unpopulated table
  entries point at it, so a dispatch never needs a "no block" sentinel. A block with
  refcount 1 is exclusively owned by its holder and may be written; refcount > 1 means
  shared (a slot appending into a shared block must copy-on-write first — the engine
  does the device copy, this module answers `shared()`).

- `PagedPrefixCache` — the radix index (cache/radix.py) as a *directory* over device
  blocks: a node's handle is a ("dev", block_id) reference (one pool refcount held per
  node), so a prefix hit is a refcounted block-table REMAP — zero bytes moved — and a
  finished slot's harvest is an incref, not a copy. Under pool pressure, LRU
  unreferenced directory nodes DEMOTE their blocks device→host into a
  cache/block_pool.py KVBlockPool (hot engine-dtype or Q80 tier); a later hit on a
  ("cold", handle) node pays one host→device upload and promotes back.

Locking: `DeviceKVPool` has its own lock (alloc/free/refs are touched from the scheduler
thread and release_idle); the directory keeps the PrefixCache convention of one lock
over tree + tier state.
"""

from __future__ import annotations

import threading

import numpy as np

from ..obs import metrics
from .prefix_cache import (_EVICTED, _HIT_TOKENS, _HITS, _INSERTED, _MISSES,
                           _RESIDENT_TOKENS, _UNUSED)
from .radix import RadixIndex, RadixNode

__all__ = ["DeviceKVPool", "PagedPrefixCache", "PagedLease", "KVPoolExhausted",
           "SCRATCH_BLOCK"]

SCRATCH_BLOCK = 0  # permanent garbage target; never allocated, never read

# the JAX package's families; every value is host metadata (no device read)
_POOL_BLOCKS = metrics.gauge(
    "paged_kv_pool_blocks", "Device KV pool capacity in blocks (--kv-pool-blocks)")
_POOL_FREE = metrics.gauge(
    "paged_kv_free_blocks", "Device KV pool blocks currently unallocated")
_REMAPPED = metrics.counter(
    "paged_kv_remapped_blocks_total",
    "Directory blocks remapped into a slot's table at admission "
    "(zero-copy prefix reuse — no KV bytes moved)")
_COW = metrics.counter(
    "paged_kv_cow_blocks_total",
    "Copy-on-write block duplications (a slot about to append into a "
    "shared block gets a private device-side copy)")
_DEMOTED = metrics.counter(
    "paged_kv_demoted_blocks_total",
    "Directory blocks demoted device->host under pool pressure (into the "
    "unified cache/block_pool.py tier)")
_PROMOTED = metrics.counter(
    "paged_kv_promoted_blocks_total",
    "Cold directory blocks promoted host->device on a prefix hit")
_SEED_BYTES = metrics.counter(
    "paged_kv_seed_bytes_total",
    "KV bytes moved host->device at admission seeding (0 for device-tier "
    "hits — the zero-copy remap claim, asserted by the shared-prefix bench; "
    "nonzero only when a cold block is promoted)")


class KVPoolExhausted(RuntimeError):
    """The device block pool could not serve an allocation even after reclaiming the
    directory and idle slots. Attributable to the request whose growth needed the blocks: the scheduler
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
        self.cow_blocks = 0  # copy-on-write duplications the engine made (note_cow)
        _POOL_BLOCKS.set(n_blocks)
        _POOL_FREE.set(len(self._free))

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
            _POOL_FREE.set(len(self._free))
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
            _POOL_FREE.set(len(self._free))
        return freed

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def reset(self) -> None:
        """Drop every allocation (engine re-initialization: nothing references the old
        blocks any more). Metadata only: the pool tensors, which the captured steps
        read by address, are not touched."""
        with self._lock:
            self._refs[:] = 0
            self._refs[SCRATCH_BLOCK] = 1
            self._free = list(range(self.n_blocks - 1, 0, -1))
            _POOL_FREE.set(len(self._free))

    def refcounts(self) -> np.ndarray:
        """Snapshot for tests/stats."""
        with self._lock:
            return self._refs.copy()

    def shared(self, bid: int) -> bool:
        """True when more than one holder references the block — a slot must
        copy-on-write before appending into it."""
        with self._lock:
            return int(self._refs[bid]) > 1

    def used_blocks(self) -> int:
        with self._lock:
            return self.n_blocks - 1 - len(self._free)

    def note_cow(self) -> None:
        with self._lock:
            self.cow_blocks += 1
        _COW.inc()

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
        return {"pool_blocks": self.n_blocks, "free_blocks": free,
                "block_tokens": self.block_tokens, "cow_blocks": self.cow_blocks}


class PagedLease:
    """Refcount pin on the directory chain a request was admitted against (the paged
    analog of prefix_cache.PrefixLease — same lifecycle: mark_seeded/mark_unused +
    release, shrink on history truncation)."""

    __slots__ = ("nodes", "tokens")

    def __init__(self, nodes: list[RadixNode], tokens: int):
        self.nodes = nodes
        self.tokens = tokens


class PagedPrefixCache:
    """Radix directory over device blocks + host cold tier.

    Node handles are ("dev", block_id) — one DeviceKVPool reference held per node — or
    ("cold", host_handle) into `cold` (a cache/block_pool.py KVBlockPool, the one
    demotion target). The public surface mirrors PrefixCache so the scheduler keeps one
    vocabulary."""

    def __init__(self, pool: DeviceKVPool, block_tokens: int,
                 cold_blocks: int = 0, q80: bool = False):
        from .block_pool import KVBlockPool

        self.pool = pool
        self.block_tokens = block_tokens
        self.radix = RadixIndex(block_tokens)
        self.cold = (KVBlockPool(cold_blocks, q80=q80)
                     if cold_blocks > 0 else None)
        self._lock = threading.Lock()  # guards: radix, hits, misses, unused_hits, hit_tokens, resident_tokens, evicted_blocks, demoted, promoted, prompt_tokens
        self.hits = 0
        self.misses = 0
        self.unused_hits = 0
        self.hit_tokens = 0
        self.resident_tokens = 0
        self.evicted_blocks = 0
        self.demoted = 0
        self.promoted = 0
        self.prompt_tokens = 0

    # ------------------------------------------------------------------
    # lookup / lease lifecycle (PrefixCache-compatible)
    # ------------------------------------------------------------------

    def lookup(self, prompt: list[int], cap: int | None = None
               ) -> PagedLease | None:
        """Longest directory block-prefix of `prompt` as an acquired lease — the same
        reuse caps as PrefixCache.lookup (len-1, caller cap). No data is touched: the
        engine resolves each node's tier when it adopts the chain into a slot table."""
        with self._lock:
            self.prompt_tokens += len(prompt)
            nodes = self.radix.match(prompt)
            n = len(nodes) * self.block_tokens
            n = min(n, len(prompt) - 1)
            if cap is not None:
                n = min(n, cap)
            if n < 1:
                self.misses += 1
                _MISSES.inc()
                return None
            nodes = nodes[:(n + self.block_tokens - 1) // self.block_tokens]
            self.radix.acquire(nodes)
        return PagedLease(nodes, n)

    def mark_seeded(self, lease: PagedLease, used_tokens: int) -> None:
        with self._lock:
            self.hits += 1
            self.hit_tokens += used_tokens
        _HITS.inc()
        _HIT_TOKENS.inc(used_tokens)

    def note_resident(self, tokens: int) -> None:
        if tokens <= 0:
            return
        with self._lock:
            self.resident_tokens += tokens
        _RESIDENT_TOKENS.inc(tokens)

    def mark_unused(self, lease: PagedLease | None) -> None:
        if lease is None:
            return
        with self._lock:
            self.unused_hits += 1
        _UNUSED.inc()
        self.release(lease)

    def release(self, lease: PagedLease | None) -> None:
        if lease is None:
            return
        with self._lock:
            nodes, lease.nodes = lease.nodes, []
            lease.tokens = 0
            if nodes:
                self.radix.release(nodes)

    def shrink(self, lease: PagedLease, n_tokens: int) -> None:
        if n_tokens >= lease.tokens:
            return
        keep = (max(n_tokens, 0) + self.block_tokens - 1) // self.block_tokens
        with self._lock:
            drop, lease.nodes = lease.nodes[keep:], lease.nodes[:keep]
            lease.tokens = max(n_tokens, 0)
            if drop:
                self.radix.release(drop)

    # ------------------------------------------------------------------
    # directory mutation
    # ------------------------------------------------------------------

    def insert_blocks(self, tokens: list[int], block_ids: list[int]) -> int:
        """Attach the slot's committed full blocks to the directory BY REFERENCE: node i
        takes a pool ref on block_ids[i]. No data moves — the zero-copy harvest. Block
        positions the tree already covers keep their existing blocks. Returns how many
        new nodes were created."""
        bt = self.block_tokens
        n_blocks = min(len(tokens) // bt, len(block_ids))
        if n_blocks == 0:
            return 0
        blocked = tokens[:n_blocks * bt]
        created = 0

        def make_handle(i: int):
            nonlocal created
            self.pool.incref([block_ids[i]])
            created += 1
            return ("dev", block_ids[i])

        with self._lock:
            self.radix.insert(blocked, make_handle)
        _INSERTED.inc(created)
        return created

    def insert_cold(self, tokens: list[int], blocks: list) -> int:
        """Import externally supplied HOST rows as COLD directory nodes: `blocks[i]` is
        the (k, v) host pair for token block i of `tokens`. No device work — admission
        promotes cold nodes on the first hit, on the scheduler thread. Positions the tree
        already covers keep their existing blocks. A full cold tier first evicts its LRU
        unreferenced subtrees; if it still refuses, the chain stops at the last block
        that fit. Returns how many blocks of `tokens` the directory COVERS afterwards."""
        if self.cold is None:
            return 0
        bt = self.block_tokens
        n_blocks = min(len(tokens) // bt, len(blocks))
        if n_blocks == 0:
            return 0
        blocked = tokens[:n_blocks * bt]
        created = 0
        dev_freed: list[int] = []

        def make_handle(i: int):
            nonlocal created
            k, v = blocks[i]
            h = self.cold.put(k, v)
            if h is None:
                dev_freed.extend(self._evict_cold_locked(1))
                h = self.cold.put(k, v)
            if h is None:
                return None  # cold tier pinned full: stop extending
            created += 1
            return ("cold", h)

        with self._lock:
            chain = self.radix.insert(blocked, make_handle)
        if dev_freed:
            # dev-tier descendants dropped with an evicted cold subtree surrender their
            # pool refs (the same contract as reclaim())
            self.pool.decref(dev_freed)
        _INSERTED.inc(created)
        return len(chain)

    def promote(self, node: RadixNode, new_bid: int) -> None:
        """A cold node's rows were uploaded into freshly allocated device block
        `new_bid` (the engine did the transfer): the directory adopts the device copy
        and frees the host block."""
        with self._lock:
            tier, h = node.handle
            assert tier == "cold", node.handle
            self.pool.incref([new_bid])
            node.handle = ("dev", new_bid)
            if self.cold is not None:
                self.cold.free(h)
            self.promoted += 1
        _PROMOTED.inc()

    def reclaim(self, n_blocks: int, read_block) -> int:
        """Free up to n_blocks device blocks by demoting (or, with no cold tier,
        evicting) LRU UNREFERENCED device-tier nodes. `read_block(bid) -> (k, v)` host
        rows (L, hk, bt, hs) performs the device→host copy for demotion. Returns how
        many device blocks went back to the pool's free list (shared blocks drop the
        directory's ref but stay alive for the slots still holding them)."""
        with self._lock:
            victims = []
            stack = [self.radix.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (node is not self.radix.root and node.refs == 0
                        and isinstance(node.handle, tuple)
                        and node.handle[0] == "dev"):
                    victims.append(node)
            victims.sort(key=lambda v: v.stamp)
            released = []
            for node in victims:
                if len(released) >= n_blocks:
                    break
                # walk past victims that release nothing (a block still shared with a
                # slot's table, or a subtree drop aborted by a lease pin)
                if node.handle[0] != "dev":
                    continue  # already detached/demoted via an ancestor drop
                bid = node.handle[1]
                if self.cold is not None:
                    try:
                        k, v = read_block(bid)
                        h = self.cold.put(k, v)
                    except Exception:
                        h = None  # demotion is best-effort; evict instead
                    if h is None and len(self.cold) > 0:
                        # cold tier full: drop its oldest nodes outright (their dev-tier
                        # descendants surrender their refs through `released`)
                        released.extend(self._evict_cold_locked(1))
                        if node.handle[0] != "dev":
                            continue  # the victim rode out with the dropped subtree
                        try:
                            k, v = read_block(bid)
                            h = self.cold.put(k, v)
                        except Exception:
                            h = None
                    if h is not None:
                        node.handle = ("cold", h)
                        self.demoted += 1
                        _DEMOTED.inc()
                        released.append(bid)
                        continue
                # no cold tier (or it refused): evict the node and its whole subtree
                released.extend(self._drop_subtree_locked(node))
            freed = 0
        if released:
            freed = self.pool.decref(released)
        return freed

    def _drop_subtree_locked(self, node: RadixNode) -> list[int]:  # holds: self._lock
        """Remove `node` and every descendant from the tree; returns the device block
        ids whose directory refs must be dropped. A descendant with refs > 0 (a live
        lease) aborts the drop of that branch."""
        stack, doomed = [node], []
        for n in stack:
            stack.extend(n.children.values())
            doomed.append(n)
        if any(n.refs > 0 for n in doomed):
            return []
        del node.parent.children[node.key]
        self.radix.nodes -= len(doomed)
        self.evicted_blocks += len(doomed)
        _EVICTED.inc(len(doomed))
        dev_ids = []
        for n in doomed:
            tier, h = n.handle
            if tier == "dev":
                dev_ids.append(h)
            elif tier == "cold" and self.cold is not None:
                self.cold.free(h)
            n.handle = ("dropped", None)  # a stale victims entry must not release twice
        return dev_ids

    def _evict_cold_locked(self, n: int) -> list[int]:  # holds: self._lock
        """Drop the n LRU unreferenced cold-tier subtrees (frees host room for an
        incoming demotion). Returns the DEVICE block ids of dev-tier descendants dropped
        with them — the caller must decref those, or the blocks leak."""
        cold_nodes = []
        stack = [self.radix.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (node is not self.radix.root and node.refs == 0
                    and isinstance(node.handle, tuple)
                    and node.handle[0] == "cold"):
                cold_nodes.append(node)
        cold_nodes.sort(key=lambda v: v.stamp)
        dev_ids: list[int] = []
        for node in cold_nodes[:n]:
            if node.handle[0] == "cold":  # not already dropped via an ancestor
                dev_ids.extend(self._drop_subtree_locked(node))
        return dev_ids

    def fetch_cold(self, handle: int):
        """Host rows of a cold block (dequantized when Q80) — the promotion's upload
        payload. Outside the lock; the caller's lease pins the node."""
        assert self.cold is not None
        return self.cold.get(handle)

    def reset(self) -> None:
        """Drop the whole directory (every dev handle is stale)."""
        with self._lock:
            self.radix = RadixIndex(self.block_tokens)
            if self.cold is not None:
                for h in list(self.cold._blocks):
                    self.cold.free(h)

    def total_refs(self) -> int:
        with self._lock:
            return self.radix.total_refs()

    # ------------------------------------------------------------------
    # stats (PrefixCache-compatible keys + paged extras)
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            looked = self.hits + self.unused_hits + self.misses
            dev_nodes = 0
            cold_nodes = 0
            stack = [self.radix.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is not self.radix.root:
                    if node.handle[0] == "dev":
                        dev_nodes += 1
                    else:
                        cold_nodes += 1
            return {
                "paged": True,
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
                "demoted_blocks": self.demoted,
                "promoted_blocks": self.promoted,
                "tree_nodes": self.radix.nodes,
                "dev_blocks": dev_nodes, "cold_blocks": cold_nodes,
                "pool_blocks": self.pool.n_blocks,
                "pool_free_blocks": self.pool.free_blocks(),
                "block_tokens": self.block_tokens,
                "q80_tier": self.cold.q80 if self.cold is not None else False,
            }
