"""Launch planning shared by the two attention kernels (csrc/attention_tile.cuh).

A launch has one block per (query pass of 64 rows, slot split, batch row and kv head).
`split_plan` sizes the splits from the readable window alone — never from a row's
length or position — so the launch does not change while a window bucket lasts and a
captured CUDA graph replays it; `resident_blocks` asks the kernel how many of its blocks
the card holds at once. `merge_counters` is the per-device int32 buffer of
per-tile counters the kernels use to find the last split block of a tile; the kernels
leave it zero.
"""

from __future__ import annotations

import torch

from . import cuda_build

PASS_ROWS = 64   # query rows per block (attention_tile.cuh kPassRows)
TILE_SLOTS = 64  # slots per tile; split j takes tiles j, j + nsplit, ... (kKT)
MAX_SPLITS = 32  # splits of one (row, head, pass) at most (kMaxSplits)


def split_plan(n_slots: int, rows: int, heads: int, resident: int) -> tuple[int, int]:
    """(npass, nsplit) for `heads` (batch row, kv head) pairs of `rows` query rows each
    over `n_slots` readable slots: passes of PASS_ROWS rows, and as many splits as keep
    the launch within the `resident` blocks the card holds at once (a second, partial
    wave would double the time), at most one per TILE_SLOTS-slot tile of the window and
    at most MAX_SPLITS, at least one (split 0 carries the chunk keys). Split j takes the
    tiles j, j + nsplit, ..., so the splits share the work at any row length."""
    if n_slots < 0 or rows < 1 or heads < 1 or resident < 1:
        raise ValueError(f"split_plan: n_slots={n_slots}, rows={rows}, heads={heads}, "
                         f"resident={resident}")
    npass = -(-rows // PASS_ROWS)
    tiles = -(-n_slots // TILE_SLOTS)
    nsplit = max(1, min(MAX_SPLITS, tiles, resident // (npass * heads)))
    return npass, nsplit


def resident_blocks(lib, fn: str, cache_bf16: bool, hs: int, rows: int,
                    device_index: int) -> int:
    """Blocks of one kernel build (cache dtype, head size, and the narrow body for at
    most 8 query rows or the wide one) the card holds at once: the kernel's own
    occupancy query `fn` times the SM count, asked once per build."""
    args = (int(cache_bf16), hs, 8 if rows <= 8 else 64)
    return cuda_build.resident_blocks(lib, fn, args, device_index)


def merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least `n` zeroed int32 counters on `device`, the same buffer from call to call
    (so a captured graph keeps its address); a buffer outgrown stays allocated."""
    return cuda_build.device_buffer("merge_counters", device, n, torch.int32, 4096)
