"""Launch planning for the decode matvec kernels (csrc/matvec_stream.cuh): q4_matvec
(i4p weights) and q8_matvec (i8 weights), each with the float row quantized in the
kernel ("quantize"), a pre-quantized row ("q80") or, for i8, the f32 row ("precise").

A block owns a contiguous range of rows; their packed bytes stream through a ring of
`stages` slots of `rs` whole rows each (one bulk copy per slot), `gw` warps sharing a row
(`ring`); the pre-quantized entry, launched behind the fused prologue with programmatic
stream serialization, issues `pre` of those slots before it waits for the prologue.
The grid is one wave of blocks, from the kernel's own occupancy query, and rows are
split evenly over it: block b takes rows [b·N/G, (b+1)·N/G) (`plan`,
`row_ranges`). `layout` gives the block's shared memory as the kernel lays it out.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from . import cuda_build

THREADS = 256            # matvec_stream.cuh kThreads
WARPS = THREADS // 32
MAX_SMEM = 232448        # shared memory a block may take on an H100 (kMaxSmem)
SLOT_MAX = 32 * 1024     # weight bytes of a ring slot with one row per warp group
SLOT_MIN = 16 * 1024     # a slot of short rows takes more rows per warp group, up to this
RING_BYTES = 64 * 1024   # weight bytes of the ring a block aims for
MIN_STAGES, MAX_STAGES = 3, 8
FORMATS = ("i4p", "i8")
MODES = ("quantize", "q80", "precise")
MAX_K = 32768            # the quantized row and its scales (1.25·K bytes) in shared memory
PRECISE_MAX_K = 12288    # the precise row's f32 chunks fit each lane's registers
# slots of static weights the pre-quantized entry issues before griddepcontrol.wait (the
# kernel issues at most all but one of a block's slots, and at least one): 2 ran the
# Q40 layer chain faster than 1 or the whole ring, and the whole ring held the matvecs
# alone back (their row's loads queued behind it; PERF.md §6)
PRE_SLOTS = 2


def _up128(b: int) -> int:
    return -(-b // 128) * 128


def row_bytes(k: int, fmt: str) -> int:
    """Packed bytes of one weight row."""
    return k // 2 if fmt == "i4p" else k


def scale_bytes(k: int, fmt: str) -> int:
    """Scale bytes of one weight row: f16 (i4p) or f32 (i8) per 32 columns."""
    return k // 32 * (2 if fmt == "i4p" else 4)


def check(k: int, fmt: str, mode: str) -> None:
    """Raise ValueError unless the kernels take rows of K columns in this format and
    mode: i4p K % 64 == 0, i8 K % 32 == 0, K <= 32768 (precise: 12288)."""
    if fmt not in FORMATS or mode not in MODES or (fmt == "i4p" and mode == "precise"):
        raise ValueError(f"mv_plan: no {mode} mode for {fmt} weights")
    align = 64 if fmt == "i4p" else 32
    top = PRECISE_MAX_K if mode == "precise" else MAX_K
    if k < align or k % align or k > top:
        raise ValueError(f"mv_plan: {fmt} {mode} takes K % {align} == 0 up to {top}, "
                         f"got K={k}")


@dataclass(frozen=True)
class Layout:
    """Byte offsets of a block's shared memory (matvec_stream.cuh `layout`)."""
    stage: int   # one weight slot
    sstage: int  # one scale slot
    ring: int
    sring: int
    row: int     # xq (or the f32 row of the precise mode)
    sx: int
    ssum: int
    red: int
    bars: int
    total: int


def layout(k: int, fmt: str, mode: str, rs: int, stages: int, gw: int) -> Layout:
    """The kernel's shared-memory layout, each region on 128 bytes: the weight ring, the
    scale ring, the row (xq, sx and for i4p the block sums of xq; none for the precise
    mode, whose row passes through ring slots 1.. into registers), two slots' per-warp
    partials, one mbarrier per slot."""
    nb = k // 32
    stage = _up128(rs * row_bytes(k, fmt))
    sstage = _up128(rs * scale_bytes(k, fmt))
    sring = stages * stage
    row = sring + stages * sstage
    if mode == "precise":  # the f32 row passes through the ring into registers
        sx = ssum = red = row
    else:
        sx = row + _up128(k)
        ssum = sx + _up128(4 * nb)
        red = ssum + (_up128(4 * nb) if fmt == "i4p" else 0)
    bars = red + _up128(2 * rs * gw * 4)
    return Layout(stage, sstage, 0, sring, row, sx, ssum, red, bars, bars + 8 * stages)


@dataclass(frozen=True)
class Ring:
    gw: int      # warps per row
    rs: int      # rows per slot
    stages: int  # slots
    smem: int    # shared memory of a block
    cpl: int     # 32-byte chunks of a row per lane, at most (matvec_stream.cuh cpl_of)
    pre: int     # slots issued before the wait for the prologue (q80; 0 otherwise)


@functools.lru_cache(maxsize=1024)
def ring(k: int, fmt: str, mode: str) -> Ring:
    """The ring of one (K, format, mode): the fewest warps per row (1, 2, 4, 8) whose
    rows in flight (one per warp group) fit a slot of SLOT_MAX bytes (8 where none do)
    and leave each lane at most 4 chunks of the row (2 for the precise mode's f32 row:
    its registers); as many rows per warp group as make SLOT_MIN bytes; at least
    MIN_STAGES slots, as many as make RING_BYTES, and for the precise mode enough for
    the f32 row to pass through all slots but the first; for the q80 mode PRE_SLOTS of
    them issued before the wait for the prologue."""
    check(k, fmt, mode)
    rb = row_bytes(k, fmt)
    top = 2 if mode == "precise" else 4  # chunks per lane
    gw = next((g for g in (1, 2, 4) if WARPS // g * rb <= SLOT_MAX
               and -(-(rb // 32) // (32 * g)) <= top), WARPS)
    groups = WARPS // gw
    rs = groups * max(1, SLOT_MIN // (groups * rb))
    stages = min(MAX_STAGES, max(MIN_STAGES, -(-RING_BYTES // (rs * rb))))
    if mode == "precise":
        stages = max(stages, 1 + -(-4 * k // _up128(rs * rb)))
    cpl = -(-(rb // 32) // (32 * gw))
    pre = min(PRE_SLOTS, stages) if mode == "q80" else 0
    return Ring(gw, rs, stages, layout(k, fmt, mode, rs, stages, gw).total, cpl, pre)


@dataclass(frozen=True)
class Plan:
    ring: Ring
    grid: int


@functools.lru_cache(maxsize=4096)
def plan(n: int, k: int, fmt: str, mode: str, sms: int, blocks_per_sm: int) -> Plan:
    """The launch of one call against (N, K) weights: the ring, and a grid of one wave
    (blocks_per_sm, the kernel's occupancy query with this ring, times the SM count),
    at most one block per row."""
    r = ring(k, fmt, mode)
    if n < 1 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"mv_plan.plan: n={n}, sms={sms}, blocks_per_sm={blocks_per_sm}")
    if r.smem > MAX_SMEM:
        raise ValueError(f"mv_plan: K={k} {fmt} {mode} needs {r.smem} B of shared memory")
    return Plan(r, min(n, sms * blocks_per_sm))


def row_ranges(p: Plan, n: int) -> list[tuple[int, int]]:
    """Rows [r0, r1) of each block, as the kernel splits them."""
    return [(b * n // p.grid, (b + 1) * n // p.grid) for b in range(p.grid)]


def bulk_copies(p: Plan, n: int, k: int, fmt: str):
    """(block, slot, source byte offset, bytes) of every bulk copy of a call, in the
    order each block issues them."""
    rb = row_bytes(k, fmt)
    for b, (r0, r1) in enumerate(row_ranges(p, n)):
        for j in range(-(-(r1 - r0) // p.ring.rs)):
            rows = min(p.ring.rs, r1 - r0 - j * p.ring.rs)
            yield b, j % p.ring.stages, (r0 + j * p.ring.rs) * rb, rows * rb


def for_call(lib, fit_fn: str, n: int, k: int, fmt: str, mode: str, x_bf16: bool,
             device_index: int) -> Plan:
    """The plan of one launch on a card: the ring, the kernel's occupancy query with it
    (`fit_fn` of the built library, asked once per ring and device), one wave."""
    r = ring(k, fmt, mode)
    sms = cuda_build.sm_count(device_index)
    resident = cuda_build.resident_blocks(
        lib, fit_fn, (MODES.index(mode), int(x_bf16), k, r.rs, r.stages, r.gw), device_index)
    return plan(n, k, fmt, mode, sms, resident // sms)
