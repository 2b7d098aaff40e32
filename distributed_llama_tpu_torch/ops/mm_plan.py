"""Launch planning for the Q40 dequant-matmul family (csrc/q4_mm_tile.cuh): q4_matmul
(one weight stream) and q4_gated_matmul (two).

A block tile is `bw` weight rows of each stream by `bn` activation rows; the tile is
chosen by M (`pick_tile`). K is cut into chunks of 32 packed bytes (one Q40 block of
each plane), and `plan` splits the chunks into contiguous runs, split z taking chunks
[z·per_split, (z + 1)·per_split), as many splits as keep the (tile, split) items within
the blocks the card holds at once (`resident`, from the kernel's own occupancy query),
each a whole number of ring stages;
the grid is at most one wave of them, and a block walks the items in strides of the
grid. The last split block of a tile sums the splits in split order (the kernel's
workspace and per-tile counters come from `workspace` and `attention_plan.merge_counters`:
the same buffers from call to call, so a captured CUDA graph keeps their addresses;
calls share them in stream order).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import cuda_build

CHUNK = 32  # packed bytes of one Q40 block of each plane (q4_mm_tile.cuh kChunk)
MIN_SPLIT_STAGES = 2  # a split runs at least this many ring stages where K allows


@dataclass(frozen=True)
class Tile:
    """One kernel configuration: a warp owns wt 16-row weight tiles (of each stream) by
    nt 8-row activation tiles; ww x wn warps; a ring stage holds ch chunks
    (q4_mm_tile.cuh Cfg)."""
    wt: int
    nt: int
    ww: int
    wn: int
    ch: int

    @property
    def bw(self) -> int:
        return self.ww * self.wt * 16

    @property
    def bn(self) -> int:
        return self.wn * self.nt * 8

    @property
    def threads(self) -> int:
        return 32 * self.ww * self.wn


# the tiles of csrc/q4_matmul.cu and csrc/q4_gated_matmul.cu (the same in both; only
# their ring depths differ), by the `cfg` index pick_tile returns
TILES = (Tile(1, 1, 4, 1, 4), Tile(1, 2, 4, 1, 4), Tile(1, 8, 4, 1, 2),
         Tile(1, 16, 4, 1, 2))
_TILE_ROWS = (8, 16, 64)  # largest M of tiles 0, 1, 2; tile 3 takes the rest


@dataclass(frozen=True)
class Plan:
    cfg: int          # index into TILES
    tiles_w: int      # weight-row tiles
    tiles_m: int      # activation-row tiles
    chunks: int       # K / 64
    splits: int
    per_split: int    # chunks per split (the last split may take fewer)
    grid: int
    part_floats: int  # f32 workspace the splits need (0 without a split)

    @property
    def tiles(self) -> int:
        return self.tiles_w * self.tiles_m


def pick_tile(m: int) -> int:
    """The tile index for M activation rows."""
    if m < 1:
        raise ValueError(f"pick_tile: m={m}")
    for i, rows in enumerate(_TILE_ROWS):
        if m <= rows:
            return i
    return len(_TILE_ROWS)


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, streams: int, resident: int) -> Plan:
    """The launch of one call: tile, splits of K and grid for (M, K) activations against
    `streams` weights of (N, K), with `resident` blocks of the tile on the card at once."""
    if m < 1 or n < 1 or k < 64 or k % 64 or streams not in (1, 2) or resident < 1:
        raise ValueError(f"mm_plan.plan: m={m}, n={n}, k={k}, streams={streams}, "
                         f"resident={resident}")
    cfg = pick_tile(m)
    tile = TILES[cfg]
    tiles_w, tiles_m = -(-n // tile.bw), -(-m // tile.bn)
    tiles = tiles_w * tiles_m
    chunks = k // 2 // CHUNK
    splits = max(1, min(resident // tiles, chunks // (MIN_SPLIT_STAGES * tile.ch)))
    per_split = -(-chunks // splits)
    per_split += -per_split % tile.ch  # whole stages: a split starts on a stage boundary
    splits = -(-chunks // per_split)  # no empty split
    part = tiles * splits * tile.threads * 4 * streams * tile.wt * tile.nt if splits > 1 else 0
    return Plan(cfg, tiles_w, tiles_m, chunks, splits, per_split,
                min(tiles * splits, resident), part)


def resident_blocks(lib, fn: str, cfg: int, device_index: int) -> int:
    """Blocks of tile `cfg` the card holds at once, from the kernel's occupancy query."""
    return cuda_build.resident_blocks(lib, fn, (cfg,), device_index)


def workspace(device: torch.device, n: int) -> torch.Tensor:
    """At least `n` f32 of split workspace on `device`, the same buffer from call to call
    (a buffer outgrown stays allocated, for graphs captured on it)."""
    return cuda_build.device_buffer("mm_workspace", device, n, torch.float32, 1 << 20)
