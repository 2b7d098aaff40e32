"""Shared-prefix KV cache subsystem (the port's copy of the JAX package's cache/).

- `radix.py`       — token-block radix index (refcounts, LRU, hit accounting)
- `wire.py`        — the Q80 round trip and the KV block wire framing
- `block_pool.py`  — bounded host block store (hot engine-dtype tier + optional Q80 tier),
  and `HostKVArena`, the RAM-or-disc (memmap) K/V arena of the paged engine's host
  spill (runtime/paged_cache.py)
- `prefix_cache.py` — the facade over both: lookup/insert/leases/eviction + stats
- `device_pool.py` — device-resident paged KV: block-pool refcounts + the radix
  DIRECTORY over device blocks (zero-copy remap hits, device→host demotion into the
  KVBlockPool tier)
- `single_slot.py` — the single-sequence Engine's client (api_server --batch 1)

The BatchEngine integrates directly (runtime/batch_engine.py: admission in `_assign`,
harvest in `_finish`). Submodules are imported lazily (PEP 562).
"""

from __future__ import annotations

__all__ = ["DeviceKVPool", "HostKVArena", "KVBlockPool", "PagedPrefixCache", "PrefixCache",
           "PrefixLease", "RadixIndex", "SingleSlotCache", "default_pool_blocks",
           "make_prefix_cache", "warn_degraded"]

_LAZY = {"DeviceKVPool": "device_pool", "HostKVArena": "block_pool",
         "KVBlockPool": "block_pool",
         "PagedPrefixCache": "device_pool", "PrefixCache": "prefix_cache",
         "PrefixLease": "prefix_cache", "RadixIndex": "radix",
         "SingleSlotCache": "single_slot"}


def __getattr__(name: str):
    try:
        mod = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f".{mod}", __name__), name)


def make_prefix_cache(cache_shape, itemsize: int, *, slots: int, prefix_cache=True,
                      blocks: int = 0, block_tokens: int = 16, q80: bool = False):
    """The one PrefixCache construction path for the dense entry points (the BatchEngine
    with paged_kv=False, and the single-slot ApiState): resolves the enable flag /
    passthrough-instance convention and the auto pool sizing."""
    from .prefix_cache import PrefixCache

    if not prefix_cache:
        return None
    if isinstance(prefix_cache, PrefixCache):
        return prefix_cache
    n = blocks or default_pool_blocks(cache_shape, itemsize, block_tokens, slots)
    return PrefixCache(max_blocks=n, block_tokens=block_tokens, q80=q80)


def warn_degraded(what: str, exc: Exception) -> None:
    """Uniform stderr warning for cache degradations (seed/insert failures): the cache
    is an optimization, never a correctness gate — callers fall back to plain
    prefill/no-harvest after calling this."""
    import sys

    print(f"⚠️  prefix-cache {what} failed ({type(exc).__name__}: {exc}); "
          "continuing without it", file=sys.stderr)


def default_pool_blocks(cache_shape, itemsize: int, block_tokens: int, slots: int,
                        byte_budget: int = 1 << 30) -> int:
    """Default pool capacity: 4 full contexts per slot set, hard-capped by a host byte
    budget (~1 GiB), which wins even when it holds less than one full context. The
    engine dtype's itemsize sizes the blocks (2 for bf16 on the card, 4 for f32)."""
    n_layers, _b, hk, seq_len, hs = cache_shape
    blocks_per_seq = -(-seq_len // block_tokens)
    block_bytes = 2 * n_layers * hk * block_tokens * hs * itemsize
    cap = max(byte_budget // block_bytes, 1)
    return int(min(4 * max(slots, 1) * blocks_per_seq, cap))
