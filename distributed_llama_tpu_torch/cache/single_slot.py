"""Single-slot (Engine) client of the shared-prefix cache.

The port's copy of the JAX package's cache/single_slot.py: the reference's NaiveCache
resident-conversation rewind (dllama-api.cpp:187-232) PLUS the cross-conversation radix
path — after conversation A is displaced by conversation B, a return to A (or any prompt
sharing A's system-prompt blocks) seeds the engine cache from the pool instead of
re-prefilling.

Two reuse sources, best wins:
- resident: the engine's cache still holds the previous conversation; the longest common
  token prefix rewinds `pos` (Engine.seek) — token-granular, zero copies.
- radix: cached blocks cover a longer prefix than the resident rows do; the rows beyond
  the resident-common point are written into the engine's cache in place
  (Engine.seed_rows) and `pos` moves FORWARD to the seeded length.

The API server's generation lock serializes callers, so begin/end pairs never
interleave; the PrefixCache itself is still internally locked.
"""

from __future__ import annotations

from ..obs import trace
from .prefix_cache import PrefixCache, PrefixLease

__all__ = ["SingleSlotCache"]


class SingleSlotCache:
    def __init__(self, engine, cache: PrefixCache | None):
        self.engine = engine
        self.cache = cache
        self.resident: list[int] = []  # tokens whose KV the engine holds
        self._lease: PrefixLease | None = None

    def _resident_common(self, prompt: list[int]) -> int:
        n = 0
        for a, b in zip(self.resident, prompt):
            if a != b:
                break
            n += 1
        # never reuse the full prompt — the last token must be re-inferred
        return min(n, max(len(prompt) - 1, 0))

    def begin(self, prompt: list[int]) -> int:
        """Prepare the engine for `prompt`; returns how many leading tokens are already
        in its cache (the caller prefills only prompt[reuse:])."""
        eng = self.engine
        reuse = self._resident_common(prompt)
        if self.cache is not None:
            self.cache.note_resident(reuse)
            lease = self.cache.lookup(prompt, cap=eng.spec.seq_len - 1)
            if lease is not None and lease.tokens > reuse:
                try:
                    with trace.span("api.prefix_seed",
                                    {"tokens": lease.tokens, "resident": reuse}):
                        eng.seek(min(reuse, eng.pos))
                        # fetch only beyond the resident rows
                        ck, cv = self.cache.fetch(lease, skip=reuse)
                        eng.seed_rows(reuse, ck, cv)
                except Exception as e:
                    # a partial write may have corrupted rows >= reuse of the resident
                    # conversation too — truncate the reuse record to the rows still
                    # known-good and fall back to plain prefill
                    self.cache.mark_unused(lease)
                    self.resident = self.resident[:reuse]
                    from . import warn_degraded

                    warn_degraded("seed", e)
                    eng.seek(min(reuse, eng.pos))
                    return reuse
                self._lease = lease
                self.cache.mark_seeded(lease, lease.tokens - reuse)
                self.resident = list(prompt[:lease.tokens])
                return lease.tokens
            self.cache.mark_unused(lease)
        eng.seek(min(reuse, eng.pos))
        return reuse

    def end(self, committed: list[int]) -> None:
        """Record the finished request's engine-resident tokens and harvest their full
        blocks into the pool. `committed` must be exactly the tokens whose KV is written
        — (prompt + out)[:engine.pos]."""
        eng = self.engine
        try:
            if self.cache is not None and committed:
                with trace.span("api.prefix_insert", {"tokens": len(committed)}):
                    self.cache.insert(committed, eng.read_rows)
        except Exception as e:
            # the generation succeeded — a failed harvest must neither fail the request
            # nor leak the lease
            from . import warn_degraded

            warn_degraded("insert", e)
        finally:
            if self.cache is not None:
                self.cache.release(self._lease)
            self._lease = None
            self.resident = list(committed)

    def invalidate(self) -> None:
        """Generation failed mid-write: the engine's cache is not trustworthy."""
        if self.cache is not None:
            self.cache.release(self._lease)
        self._lease = None
        self.resident = []

    def stats(self) -> dict | None:
        return self.cache.stats() if self.cache is not None else None
