"""Launch shapes of the fused activation prologue (csrc/prologue.cu): rmsnorm_q80 and
quantize_q80 of one row of K values.

The row is cut into 16-byte pieces (4 f32 or 8 bf16 values). A CTA of T threads holds
T·L pieces, L a thread, all loaded before any is used and kept in registers; C CTAs
take consecutive slices of T·L pieces, piece c·T·L + i·T + t going to thread t of CTA c.
The row is split over up to 8 CTAs: a plain grid for quantize_q80, one
thread-block cluster for rmsnorm_q80, whose CTAs exchange their partial sums of
squares through distributed shared memory (`plan`).

What a sweep of every launch shape found on an H100 (PERF.md §6): a launch takes
longer the more bytes one SM loads, and hardly depends on how many loads a thread has
in flight, so rows spread over CTAs of one piece a thread are fastest; the cluster's
exchange of partial sums costs rmsnorm_q80 more than spreading its loads saves up to
~32 KB of row and norm weight, and its CTAs of 1024 threads ran slower than those of
512.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

THREADS = (128, 256, 512, 1024)  # the CTA sizes csrc/prologue.cu is built for
PER_THREAD = (1, 2, 4)           # pieces a thread
MAX_CTAS = 8                     # the portable cluster size (kMaxCtas)
MAX_K = 1 << 16
REGISTERS = 65536                # 32-bit registers of an SM
MAX_THREAD_REGISTERS = 255
BASE_REGISTERS = 32              # indices, the sums, the quantized words

# the choices of `plan`, from that sweep: rmsnorm_q80 keeps rows of up to this many
# bytes of row and norm weight on one CTA, and its CTAs to this many threads
NORM_ONE_CTA_BYTES = 32 * 1024
NORM_MAX_THREADS = 512


def values_per_piece(x_bf16: bool) -> int:
    return 8 if x_bf16 else 4


def pieces(k: int, x_bf16: bool) -> int:
    """16-byte pieces of a row of K values."""
    return k // values_per_piece(x_bf16)


def registers(threads: int, per_thread: int, x_bf16: bool, norm: bool) -> int:
    """What a thread holds in registers, as 32-bit words: its pieces of the row (4 a
    piece), the norm weight's values beside them (one a value), and BASE_REGISTERS."""
    vals = values_per_piece(x_bf16) if norm else 0
    return BASE_REGISTERS + per_thread * (4 + vals)


def register_budget(threads: int) -> int:
    """Registers a thread may take with one CTA of `threads` on an SM."""
    return min(MAX_THREAD_REGISTERS, REGISTERS // threads)


@dataclass(frozen=True)
class Plan:
    threads: int     # T
    per_thread: int  # L
    ctas: int        # C
    cluster: bool    # the CTAs form one cluster (rmsnorm_q80 over more than one CTA)


def check(k: int) -> None:
    if k < 32 or k % 32 or k > MAX_K:
        raise ValueError(f"prologue: K must be a multiple of 32 up to {MAX_K}, got {k}")


def fits(p: Plan, x_bf16: bool, norm: bool) -> bool:
    """A shape the kernel is built for, within the register budget and the cluster
    limit."""
    return (p.threads in THREADS and p.per_thread in PER_THREAD
            and 1 <= p.ctas <= MAX_CTAS
            and registers(p.threads, p.per_thread, x_bf16, norm)
            <= register_budget(p.threads))


def row_bytes(k: int, x_bf16: bool, norm: bool) -> int:
    """Bytes the kernel loads: the row, and the norm weight (f32) for rmsnorm_q80."""
    return k * (2 if x_bf16 else 4) + (4 * k if norm else 0)


@functools.lru_cache(maxsize=None)
def plan(k: int, x_bf16: bool, norm: bool) -> Plan:
    """The launch of one row: the fewest pieces a thread, then the fewest threads a CTA
    (rmsnorm_q80: at most NORM_MAX_THREADS), whose CTAs hold the row on at most
    MAX_CTAS CTAs — on one CTA for an rmsnorm_q80 row of at most NORM_ONE_CTA_BYTES."""
    check(k)
    n = pieces(k, x_bf16)
    top = NORM_MAX_THREADS if norm else THREADS[-1]
    limit = 1 if norm and row_bytes(k, x_bf16, norm) <= NORM_ONE_CTA_BYTES else MAX_CTAS
    for per in PER_THREAD:
        for t in THREADS:
            ctas = -(-n // (t * per))
            p = Plan(t, per, ctas, norm and ctas > 1)
            if t <= top and p.ctas <= limit and fits(p, x_bf16, norm):
                return p
    raise AssertionError(f"prologue_plan: no launch shape for K={k}")
