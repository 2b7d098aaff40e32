"""Token-block radix index: prefix -> KV block handles, refcounted, LRU-evicted.

A copy of the JAX package's cache/radix.py (stdlib only).

The reference's NaiveCache (dllama-api.cpp:187-232) and the BatchEngine's
per-slot descendant can only reuse a prefix when a free slot *happens* to still
hold a matching conversation. This index decouples prefix identity from slots:
token prefixes are chopped into fixed-size blocks (`block_tokens` tokens each)
and arranged in a radix tree whose nodes carry opaque block handles (owned by
cache/block_pool.py). Any request — whichever slot it lands on — can look up
the longest cached block-prefix of its prompt.

Because blocks are fixed-size, every edge is exactly one `block_tokens`-tuple,
so the "radix tree" degenerates to a block-granular trie; the radix property
that matters is the structural invariant it enforces: a node exists only if
its whole ancestor chain exists, so a match is always a contiguous prefix and
cached data can never be a mid-sequence island.

Concurrency: this structure is NOT internally locked — cache/prefix_cache.py
owns the single lock covering the tree and the pool together.

Invariants (the JAX package tests them against a brute-force oracle; the port's copy
is held to the JAX class under random operations):
- prefix-closed: every non-root node's parent chain is present;
- `refs >= 0` everywhere; eviction never removes a node with `refs > 0`
  or with live children (leaves first, so the tree stays prefix-closed);
- eviction order among evictable leaves is LRU by last touch (match/insert).
"""

from __future__ import annotations

__all__ = ["RadixIndex", "RadixNode"]


class RadixNode:
    __slots__ = ("key", "parent", "children", "handle", "refs", "stamp")

    def __init__(self, key: tuple[int, ...] | None, parent: "RadixNode | None",
                 handle: int | None = None):
        self.key = key          # the block of tokens labeling the edge from parent
        self.parent = parent
        self.children: dict[tuple[int, ...], RadixNode] = {}
        self.handle = handle    # opaque block-pool handle (None only at the root)
        self.refs = 0           # in-flight leases pinning this block
        self.stamp = 0          # LRU clock value of the last touch


class RadixIndex:
    def __init__(self, block_tokens: int = 16):
        assert block_tokens >= 1
        self.block_tokens = block_tokens
        self.root = RadixNode(None, None)
        self._clock = 0
        self.nodes = 0

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens: list[int]):
        n = self.block_tokens
        for i in range(0, len(tokens) - n + 1, n):
            yield tuple(tokens[i:i + n])

    # ------------------------------------------------------------------
    # queries / mutation
    # ------------------------------------------------------------------

    def match(self, tokens: list[int]) -> list[RadixNode]:
        """Longest chain of cached full blocks prefixing `tokens` (root-first).
        Touches the chain's LRU stamps; does NOT acquire references."""
        out: list[RadixNode] = []
        node = self.root
        stamp = self._tick()
        for blk in self._blocks(tokens):
            child = node.children.get(blk)
            if child is None:
                break
            child.stamp = stamp
            out.append(child)
            node = child
        return out

    def acquire(self, nodes: list[RadixNode]) -> None:
        stamp = self._tick()
        for n in nodes:
            n.refs += 1
            n.stamp = stamp

    def release(self, nodes: list[RadixNode]) -> None:
        for n in nodes:
            assert n.refs > 0, "radix release without matching acquire"
            n.refs -= 1

    def insert(self, tokens: list[int], make_handle) -> list[RadixNode]:
        """Ensure a chain for every full block of `tokens`; returns the chain.

        `make_handle(block_index)` is called for each MISSING block (missing
        blocks are always a suffix of the chain — the prefix-closed invariant)
        and must return a pool handle, or None to stop extending (pool full and
        nothing evictable). Existing blocks are never re-made.

        The chain built so far is ref-pinned while make_handle runs: a
        make_handle that evicts to free pool room (cache/prefix_cache.py)
        must never be handed this chain's own freshly-attached ancestors —
        evicting one would detach the node the next block attaches under."""
        node = self.root
        stamp = self._tick()
        chain: list[RadixNode] = []
        try:
            for i, blk in enumerate(self._blocks(tokens)):
                child = node.children.get(blk)
                if child is None:
                    handle = make_handle(i)
                    if handle is None:
                        break
                    child = RadixNode(blk, node, handle)
                    node.children[blk] = child
                    self.nodes += 1
                child.refs += 1  # pin against self-eviction (released below)
                child.stamp = stamp
                chain.append(child)
                node = child
        finally:
            for c in chain:
                c.refs -= 1
        return chain

    # ------------------------------------------------------------------
    # eviction
    # ------------------------------------------------------------------

    def _evictable_leaves(self) -> list[RadixNode]:
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children and n.refs == 0:
                out.append(n)
        return out

    def evict(self, n_blocks: int) -> list[int]:
        """Remove up to `n_blocks` LRU unreferenced leaves; returns their
        handles (for the pool to free). Removing a leaf may expose its parent —
        the sweep cascades so one call can free a whole cold branch."""
        import heapq

        heap = [(leaf.stamp, id(leaf), leaf) for leaf in self._evictable_leaves()]
        heapq.heapify(heap)
        freed: list[int] = []
        while heap and len(freed) < n_blocks:
            _, _, leaf = heapq.heappop(heap)
            parent = leaf.parent
            del parent.children[leaf.key]
            self.nodes -= 1
            freed.append(leaf.handle)
            if (parent is not self.root and not parent.children
                    and parent.refs == 0):
                heapq.heappush(heap, (parent.stamp, id(parent), parent))
        return freed

    # ------------------------------------------------------------------
    # introspection (tests / stats)
    # ------------------------------------------------------------------

    def chains(self) -> list[tuple[tuple[int, ...], ...]]:
        """Every stored block-chain as a tuple of block keys (tests/oracle)."""
        out = []
        stack = [(self.root, ())]
        while stack:
            node, prefix = stack.pop()
            for key, child in node.children.items():
                chain = prefix + (key,)
                out.append(chain)
                stack.append((child, chain))
        return out

    def total_refs(self) -> int:
        total = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            total += n.refs
        return total
