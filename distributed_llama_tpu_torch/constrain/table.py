"""Device-resident stacked constraint tables (the port's counterpart of the JAX package's
constrain/table.py).

Every attached grammar's local automaton is rebased into ONE pair of fixed-capacity
arrays, so the masked decode/verify steps read the same buffers whichever grammars are
co-batched:

  mask  (cap, W) 32-bit words   per-GLOBAL-state packed allowed bitmask
  delta (cap, V) int32          GLOBAL next state per token

Row 0 is the universal state — mask all-ones, every token self-loops — and is what
unconstrained co-batched rows ride: for them the masked step's `where(allowed, rows,
NEG)` is the identity and the state gather is loop-invariant, so their tokens are
bit-identical to the unmasked step's. Local dead transitions (-1) rebase to state 0;
they are unreachable under masked sampling (the mask already excluded the token) and
only ever indexed past a rejected verify position, where the result is discarded.

Unlike the JAX table, which builds fresh device arrays whenever an attach or detach
dirtied the host copy, the device pair here is allocated ONCE, on the engine's device,
at construction: a captured CUDA graph holds the addresses it saw at capture, so a fresh
tensor would leave every captured masked step reading freed memory. An attach or detach
marks its row span dirty, and device() copies the dirty spans into the same storage
(stream-ordered behind the dispatches already issued), at most once per attach or
detach, never per dispatch. torch has no full uint32 arithmetic on CUDA, so the device
mask holds the same bits as int32 (runtime/device_loop._apply_token_mask tests bit
`v & 31` with an arithmetic shift and `& 1`, where the sign extension is harmless).

Scheduler-thread-only (allocation at admission, release at finish).
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.step_graph import upload
from .automaton import TokenAutomaton


class ConstraintTable:
    def __init__(self, vocab_size: int, capacity: int = 512, device="cpu"):
        self.vocab = vocab_size
        self.words = (vocab_size + 31) // 32
        self.cap = capacity
        self._mask = np.zeros((capacity, self.words), np.uint32)
        self._mask[0] = 0xFFFFFFFF
        self._delta = np.zeros((capacity, vocab_size), np.int32)
        self._regions: dict[int, tuple[int, int]] = {}  # row -> (off, n)
        # the device pair, allocated once; (off, n) row spans not yet copied into it
        self.mask_dev = torch.zeros((capacity, self.words), dtype=torch.int32,
                                    device=device)
        self.delta_dev = torch.zeros((capacity, vocab_size), dtype=torch.int32,
                                     device=device)
        self._dirty: list[tuple[int, int]] = [(0, 1)]
        self.uploads = 0  # device() calls that copied at least one span

    @property
    def active_rows(self) -> int:
        return len(self._regions)

    def room_for(self, n_states: int) -> bool:
        return n_states <= self.cap - 1

    def alloc(self, row: int, aut: TokenAutomaton) -> int | None:
        """Rebase `aut` into a free span; returns the global offset, or None when the
        table is full (the engine degrades that row to unconstrained — a capacity
        condition, not a client error)."""
        assert row not in self._regions
        n = aut.n_states
        off = self._find_span(n)
        if off is None:
            return None
        self._mask[off:off + n] = aut.mask
        self._delta[off:off + n] = np.where(aut.delta >= 0, aut.delta + off, 0)
        self._regions[row] = (off, n)
        self._dirty.append((off, n))
        return off

    def free(self, row: int) -> None:
        reg = self._regions.pop(row, None)
        if reg is None:
            return
        off, n = reg
        self._mask[off:off + n] = 0
        self._delta[off:off + n] = 0
        self._dirty.append((off, n))

    def _find_span(self, n: int) -> int | None:
        # first-fit over the gaps between allocated regions (row 0 reserved)
        taken = sorted(self._regions.values())
        cur = 1
        for off, size in taken:
            if off - cur >= n:
                return cur
            cur = max(cur, off + size)
        return cur if self.cap - cur >= n else None

    def dirty_payload(self) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """The spans device() will copy next, with their rows: [(off, mask rows int32,
        delta rows)]. A tp leader sends them with its masked dispatch, so every
        follower's table (apply_payload) holds the same states."""
        return [(off, self._mask[off:off + n].view(np.int32).copy(),
                 self._delta[off:off + n].copy()) for off, n in self._dirty]

    def apply_payload(self, spans) -> None:
        """A follower's side of dirty_payload: write the leader's rows and mark them for
        the next device()."""
        for off, mask, delta in spans:
            n = len(mask)
            self._mask[off:off + n] = mask.view(np.uint32)
            self._delta[off:off + n] = delta
            self._dirty.append((off, n))

    def device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(mask, delta) on the device: always the same two tensors, with every span an
        attach or detach dirtied copied in first."""
        if self._dirty:
            for off, n in self._dirty:
                upload(self.mask_dev[off:off + n],
                       self._mask[off:off + n].view(np.int32))
                upload(self.delta_dev[off:off + n], self._delta[off:off + n])
            self._dirty = []
            self.uploads += 1
        return self.mask_dev, self.delta_dev
