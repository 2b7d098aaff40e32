"""Continuous-batching engine: concurrent sequences share one batched step.

The counterpart of the JAX package's runtime/batch_engine.py: the same scheduling
decisions, the same host sampling, the same K-step device super-steps, pipelined, the
same speculation (prompt lookup, the grammar's forced chains and the model drafter), the
same grammar-constrained decoding, the same shared-prefix cache and the same tenancy,
so a request served here gets the tokens the JAX engine gives it in the same
configuration.

- B cache "slots", each holding one sequence's KV (a block table into the device pool,
  or a row of dense caches) and host-side state. One scheduler thread owns the device.
- Prefill never stalls decode: a prefill chunk (64, 8 or 1 tokens) dispatches TOGETHER
  with the active decode rows in one mixed (B, chunk) step — the prefill row carries its
  chunk, each decode row its next token at index 0 (its other positions are scratch
  writes on masked future slots), and each decode row's logits are read at index 0.
- With no prefill pending, every active row advances in one batched T=1 dispatch: at
  superstep 1 one step, sampled on the host with each request's Sampler; at superstep
  K >= 2, when nothing waits for admission and some row may take 2 or more tokens, a
  super-step of K steps with sampling on the device (runtime/device_loop.py
  make_batched_decode_loop; on the card each step is one CUDA graph replay). The host
  reads the (K, B) token block after one fence, delivers it row by row with the
  stop/EOS/max checks, and rolls a row that stopped mid-block back to its frontier
  (the over-decoded tail sits on masked slots). Each request's xorshift* state goes to
  the device before the dispatch; delivery advances the host sampler one coin per
  delivered token, before the token is emitted. On the card a one-token step or a
  prefill picks its stochastic rows' tokens too with the device sampler, in one call on
  the step's logits with one coin from each row's Sampler (_step), so a request's
  stream does not depend on where the schedule sampled each token.
- Pipelining (superstep >= 2): super-step N+1 is issued from N's device carry (last
  token, positions, sampler state) before N's block is delivered, on a schedule that
  assumes N delivers every budgeted token; N+1 is kept only if it did, else it is
  flushed (its writes land past every row's frontier) and the next dispatch starts from
  host state again. An admission breaks the chain.
- Speculation (speculative=K): where the rows' n-gram proposers (runtime/speculative.py,
  one index per slot over prompt and delivered tokens) draft at least SPEC_MIN_DRAFT
  tokens, the dispatch is one (B, T) verify block instead of a super-step: each row's
  pending token and its draft, padded to a bucket T of 2, 3, 5, 9, ...; the device
  samples a target at every position and counts the accepted drafts
  (make_batched_verify_loop; on the card one CUDA graph per bucket), and delivery emits
  acc + 1 tokens per row. Each row's draft length follows its own accept EMA
  (AdaptiveK). The device carry is rewound to each row's frontier, so a super-step may
  chain from a verify; while the engine's accept EMA is at or above SPEC_CHAIN_EXPECT,
  chaining is declined (flush reason "spec") in favour of the next verify.
- Idle rows ride along with their start parked at their current position: their writes
  land at future positions that are masked now and overwritten when those positions
  really decode.
- A new request lands on the free slot sharing the longest token prefix with its
  history and rewinds instead of re-prefilling (the reference's NaiveCache,
  dllama-api.cpp:187-232, per slot).
- Paged KV (default): KV lives in a (L, N, hk, bt, hs) device block pool and each slot
  holds a block table (cache/device_pool.py); blocks are allocated as a slot grows and
  reclaimed from the directory and idle slots under pressure. A pool that cannot serve
  fails only the request whose growth needed the blocks. The (B, W) table is one static
  device buffer that a table edit is copied into, so a captured step always reads the
  current table.
- The prefix cache (default on): with paged KV a radix DIRECTORY over device blocks
  (cache/device_pool.py PagedPrefixCache) — a finished request's full blocks join it by
  reference, and a prompt that shares full blocks with it gets them remapped into its
  table (zero KV bytes moved) and prefills only the rest; a slot about to write into a
  shared block copies it first (copy-on-write), and under pool pressure unreferenced
  directory blocks are demoted to a host tier (engine dtype, or Q80) and promoted back
  by one upload on a later hit. Dense caches use the host PrefixCache (copy-in seeds,
  copy-out harvests). Every write into the pool tensors is in place, so the captured
  steps read the blocks the tables name.
- Request control and recovery (resilience/): `submit(deadline=, ttl=)` and the
  engine's `queue_ttl` expire requests (finish "deadline", DeadlineExceeded before the
  first token), `max_queue` sheds with EngineSaturated and a Retry-After from the
  measured drain rate, every device dispatch retries transient failures raised before
  its first launch (`_dispatched`), a request-scope fault fails only its request,
  `close(drain=True)` lets in-flight and queued requests finish, and
  `recover_wedged()` (resilience/supervisor.py) abandons a scheduler thread stuck in a
  dispatch, fails its requests with the retriable EngineWedged and re-initializes the
  device side in place: the captured steps are dropped and captured again, the KV pool
  keeps its storage. `submit(resume_tokens=k)` admits a durable resume (prompt plus k
  tokens delivered elsewhere, the sampler fast-forwarded by the caller).
- Tenancy (resilience/tenancy.py): `submit(tenant=, klass=)` debits the tenant's token
  bucket (QuotaExceeded, refunded when the request is then shed) and queues the request
  in a two-class weighted-fair queue: interactive before batch, tenants by weight. At
  submit, SLO shedding refuses a class whose projected queue wait (`slo_ttft_*`, only
  with a backlog) or the measured decode pace (`slo_tpot_interactive`, batch only) is
  past its target; an interactive arrival that would be refused evicts the least
  entitled queued batch request instead, and at max_queue a batch arrival more entitled
  than the queue's worst batch resident displaces it. With no free slot, an interactive
  head preempts the batch row with the least output at the super-step boundary: the
  victim's blocks join the prefix cache (dense rows are copied to the host before the
  slot is handed on), its request is re-queued and re-admitted later as prompt plus
  delivered tokens — mostly a directory remap — and continues as the uninterrupted run.
- Disaggregated prefill (fleet/disagg.py): `submit(export_kv=True)` snapshots the
  prompt's full KV blocks to the host at finish (`req.kv_export`), and
  `import_kv_blocks` takes blocks shipped from another replica into the prefix cache
  (cold directory nodes, or the dense host cache), so the admission after it prefills
  only the tail.

  The captured steps read and write their buffers in place, so an abandoned thread
  must never reach the stream again: each scheduler thread carries the epoch it was
  born into, and a dispatch checks it after its fault point and before its first
  launch (and after the call); a mismatch unwinds the thread through _StaleEpoch
  without touching engine state.
- Observability (obs/): the JAX engine's metric families (queue, slots, dispatch
  times by shape, super-step tokens, rollback, parked rows, tokens, requests by finish,
  prefix seeding, errors, retries, sheds, deadlines, scheduler liveness, dispatch age
  and gap, pipeline depth and flushes, resume, tenants, preemption, SLO sheds, quotas,
  drain rate, wedge recoveries), its spans and its flight-recorder events, at the same
  host sites: admission, dispatch, delivery and finish. None is inside a captured step
  (a replay runs no host code), and none reads the device: the dispatch times are the
  host clocks the scheduler already keeps. `submit(rid=, ctx=)` names the request and
  its trace context (by default the caller's bound one, api_server's handler thread);
  the scheduler re-enters each request's context around its work, so its spans carry
  the request's trace id.
- Grammar-constrained decoding (constrain/): `submit(constraint=, constraint_hash=)`
  binds a compiled TokenAutomaton to the request. At admission its states are rebased
  into a region of the engine's ConstraintTable (`constrain_states` rows, created at the
  first constrained admission, its device buffers allocated once and re-uploaded in
  place, so the captured steps keep reading them); a dispatch with a live constrained
  row runs the masked build of the super-step or verify (its own graph keys), where each
  row's GLOBAL state rides the carry and disallowed logits fall to MASK_NEG before the
  sampler; an all-unconstrained batch keeps the unmasked graphs. The host samples of
  constrained rows (and the card's device picks) are masked the same way; delivery
  advances a host mirror of each row's state. A full table, a fault at
  `constrain.mask` or a delivered token outside the grammar degrades the row to
  unconstrained decoding (constrain_degraded_total, a flight event), never fails it.
- The model drafter (draft/): `draft_model=` (a `.m` path, or a (spec, params) pair)
  loads a second, small model beside the target that drafts up to `draft_k` tokens per
  row in one scan dispatch. The proposer is a ProposerMux: a row's grammar proposer
  first (forced chains, certain accepts), then the model drafter, then n-gram lookup. A
  drafter that fails to load or propose (its own failure: a speculative.DrafterError
  such as a vocab mismatch, or an injected `draft.*` fault) gives way to n-gram
  drafting; any other exception, a kernel's or the card's among them, propagates.
- Tensor parallelism (`tp=`, `mesh=`, `compress_collectives=`, `moe_sharding=`,
  parallel/): every rank constructs the engine, holding its shard of the weights (a MoE
  model's experts sliced, or E/tp of them whole under moe_sharding="expert") and its KV
  heads of the block pool. Rank 0 leads: it runs the scheduler, the samplers, the
  prefix directory, tenancy and the grammars, and sends each device-side operation to
  the other ranks as a descriptor of host data (`_mirror`, parallel/replay.py) just
  after `_before_launch`, so an operation it retries runs once there. The others call
  `follow()`, which replays each operation on their shard in the same order (`_replay`)
  until rank 0's close: steps, super-steps (a chained one from the follower's own device
  carry: the gathered logits, hence the device samples, are the same on every rank),
  verify blocks, table rows, block copies, demotions into each rank's own host tier
  (`cache/block_pool.py` ShadowBlockPool, following the leader's tier decisions),
  promotions, dense seeds and constraint-table rows. Steps run eagerly (no CUDA graphs
  under tp). An exception after a descriptor went out leaves the ranks out of step, so
  it fails the world (`broken`), not a request. Refused under tp, each naming its
  ROADMAP item: dp, the model drafter, KV export and import, recover_wedged.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..cache.device_pool import _REMAPPED, _SEED_BYTES
from ..models.spec import ModelSpec
from ..obs import flight, metrics, reqctx, trace
from ..resilience import faults
from ..resilience.errors import (DeadlineExceeded, EngineClosed, EngineDraining,
                                 EngineSaturated, EngineWedged, InvalidRequest, classify)
from ..resilience.tenancy import (CLASSES, DEFAULT_TENANT, DrainRate, TenantRegistry,
                                  WeightedFairQueue)
from .engine import PREFILL_CHUNKS, Engine, GenerationStats
from .sampler import _random_u32, _xorshift_back
from .speculative import (AdaptiveK, NgramProposer, ProposerMux, drafter_failure,
                          verify_block_bucket)
from .step_graph import copy_to_host, upload

__all__ = ["BatchEngine", "BatchRequest"]

# speculation (the JAX engine's defaults): a verify needs at least SPEC_MIN_DRAFT
# drafted tokens over its rows (below it the super-step serves better); while the
# accept EMA is at or above SPEC_CHAIN_EXPECT, back-to-back verifies beat chained
# super-steps
SPEC_MIN_DRAFT = 1
SPEC_CHAIN_EXPECT = 2.0
# a transient dispatch failure (the JAX engine's defaults): up to MAX_RETRIES retries,
# the backoff starting at RETRY_BACKOFF seconds and doubling, capped at 1 s
MAX_RETRIES = 3
RETRY_BACKOFF = 0.05
# the most dispatch times kept per kind in `dispatch_ms` (the newest; a bounded window,
# so a long-running server does not grow)
DISPATCH_MS_KEEP = 4096

# Scheduler telemetry: the JAX engine's families, names and meanings
_QUEUE_WAIT = metrics.histogram(
    "batch_queue_wait_seconds",
    "submit() to slot assignment (admission latency incl. queueing)")
_QUEUE_DEPTH = metrics.gauge(
    "batch_queue_depth", "Requests waiting for a free slot")
_SLOTS_TOTAL = metrics.gauge(
    "batch_slots_total", "Configured cache slots (--batch)")
_SLOTS_OCCUPIED = metrics.gauge(
    "batch_slots_occupied", "Cache slots holding a live request")
_DISPATCH_SECONDS = metrics.histogram(
    "batch_dispatch_seconds",
    "Wall time of one scheduler device dispatch, by shape",
    labelnames=("kind",))
_DISP_PREFILL = _DISPATCH_SECONDS.labels(kind="prefill")
_DISP_MIXED = _DISPATCH_SECONDS.labels(kind="mixed")
_DISP_SINGLE = _DISPATCH_SECONDS.labels(kind="single_step")
_DISP_SUPER = _DISPATCH_SECONDS.labels(kind="super_step")
_DISP_VERIFY = _DISPATCH_SECONDS.labels(kind="verify")
_SUPERSTEP_TOKENS = metrics.histogram(
    "batch_superstep_tokens",
    "Tokens decoded per super-step dispatch (sum of row budgets)",
    buckets=metrics.DEFAULT_SIZE_BUCKETS)
_ROLLBACK_TOKENS = metrics.counter(
    "batch_rollback_tokens_total",
    "Device-decoded tokens discarded by host-side stop/cancel frontier rewind")
_PARKED_ROW_STEPS = metrics.counter(
    "batch_parked_row_steps_total",
    "Row-steps spent parked (rows riding a dispatch without advancing)")
_PREFILL_TOKENS = metrics.counter(
    "batch_prefill_tokens_total", "Prompt tokens prefilled by the scheduler")
_DECODE_TOKENS = metrics.counter(
    "batch_decode_tokens_total", "Tokens delivered to requests by the scheduler")
_REQUESTS = metrics.counter(
    "batch_requests_total", "Completed requests by finish reason",
    labelnames=("finish",))
_PREFIX_SEEDED = metrics.counter(
    "batch_prefix_seeded_tokens_total",
    "Cache rows copied from the prefix-cache pool at admission "
    "(prompt tokens whose prefill was skipped beyond the same-slot rewind)")
_ENGINE_ERRORS = metrics.counter(
    "engine_errors_total",
    "Dispatch/scheduler errors by blast radius "
    "(transient=retried, request=failed one request, engine=failed all)",
    labelnames=("kind",))
_RETRIES = metrics.counter(
    "engine_retries_total",
    "Transient dispatch failures retried with backoff")
_SHED = metrics.counter(
    "engine_shed_requests_total",
    "Admissions refused because the queue was at --max-queue")
_DEADLINE_EXPIRED = metrics.counter(
    "engine_deadline_expired_total",
    "Requests expired by queue TTL or generation deadline, by where",
    labelnames=("where",))
_SCHED_ALIVE = metrics.gauge(
    "batch_scheduler_alive",
    "1 while the BatchEngine scheduler thread is running (0 = dead/idle)")
_DISPATCH_AGE = metrics.gauge(
    "batch_dispatch_age_seconds",
    "Dispatch watchdog: seconds since the scheduler last completed a device "
    "dispatch, 0 while idle (read at scrape time)")
_DISPATCH_GAP = metrics.histogram(
    "batch_dispatch_gap_seconds",
    "Device-idle gap before a decode super-step: host time between the "
    "previous dispatch's results landing and this dispatch being issued "
    "(0 when chained from device state while the predecessor is in flight)")
_PIPELINE_DEPTH = metrics.gauge(
    "batch_pipeline_depth",
    "Decode super-steps currently in flight on device (2 = overlapped: one "
    "executing while its predecessor's block is delivered host-side)")
_PIPELINE_FLUSHES = metrics.counter(
    "batch_pipeline_flushes_total",
    "Pipeline breaks by reason: an eagerly chained super-step was discarded "
    "before delivery (stop/cancel/error/finish — its rows diverged from the "
    "speculated schedule) or chaining was declined (admission/close, or "
    "'spec': the accept-aware policy preferred a host-drafted verify "
    "dispatch over extending the scan chain)",
    labelnames=("reason",))
_SPEC_VERIFY_STEPS = metrics.counter(
    "batch_spec_verify_steps_total",
    "Batched draft-verify super-step dispatches")
_SPEC_DRAFTED = metrics.counter(
    "batch_spec_drafted_tokens_total",
    "Draft tokens proposed to batched verify dispatches (per row)")
_SPEC_ACCEPTED = metrics.counter(
    "batch_spec_accepted_tokens_total",
    "Draft tokens batched verify dispatches accepted")
_SPEC_ACCEPT_RATE = metrics.gauge(
    "batch_spec_accept_rate",
    "Cumulative batched accepted/drafted ratio (process lifetime)")
_RESUMED = metrics.counter(
    "batch_resumed_requests_total",
    "Requests admitted with a resume prefix (mid-stream failover re-submits)")
_RESUME_TOKENS = metrics.counter(
    "batch_resume_prefix_tokens_total",
    "Delivered-elsewhere tokens carried by resume admissions (the suffix the "
    "new replica must re-prefill or reuse)")
_TENANT_TOKENS = metrics.counter(
    "batch_tenant_tokens_total",
    "Decode tokens delivered, by canonical tenant", labelnames=("tenant",))
_TENANT_REQUESTS = metrics.counter(
    "batch_tenant_requests_total",
    "Completed requests by canonical tenant and class",
    labelnames=("tenant", "class"))
_PREEMPTED = metrics.counter(
    "batch_preempted_total",
    "Batch-class rows preempted at a super-step boundary so a waiting "
    "interactive request could take the slot (the preempted request is "
    "re-queued and later resumes byte-identical)")
_SLO_SHED = metrics.counter(
    "engine_slo_shed_total",
    "Admissions refused (or queued batch work evicted for an interactive "
    "arrival) because the projected queue wait exceeded the class's TTFT "
    "target or measured TPOT exceeded the interactive target, by class",
    labelnames=("class",))
_QUOTA_THROTTLED = metrics.counter(
    "engine_quota_throttled_total",
    "Admissions refused with 429: the tenant's token-bucket quota was "
    "exhausted", labelnames=("tenant",))
_DRAIN_RATE = metrics.gauge(
    "engine_drain_rate",
    "Measured request completions/sec (decayed EMA, resilience/tenancy.py "
    "DrainRate) — the denominator of drain-derived Retry-After hints")
_WEDGE_RECOVERIES = metrics.counter(
    "engine_wedge_recoveries_total",
    "Supervisor escalations: a wedged scheduler was abandoned and the engine "
    "re-initialized, by outcome", labelnames=("outcome",))
_WEDGE_FAILED = metrics.counter(
    "engine_wedge_failed_requests_total",
    "In-flight/queued requests failed with EngineWedged by a supervisor "
    "recovery (retriable: a durable router resumes them elsewhere)")
# grammar-constrained decoding: rows with an attached automaton, masked dispatches
# issued, and rows degraded to unconstrained output (a service condition, never a
# client-visible failure)
_CONSTRAIN_ROWS = metrics.gauge(
    "constrain_rows",
    "Batch rows currently decoding under an attached grammar automaton")
_CONSTRAIN_DISPATCHES = metrics.counter(
    "constrain_masked_dispatches_total",
    "Batched decode/verify dispatches issued through the masked program "
    "variants (>= 1 live constrained row in the batch)")
_CONSTRAIN_DEGRADED = metrics.counter(
    "constrain_degraded_total",
    "Constrained rows degraded to unconstrained decoding, by reason "
    "(capacity = constraint table full, mask = masking fault, "
    "divergence = delivered token left the grammar)",
    labelnames=("reason",))


class _StaleEpoch(BaseException):
    """Raised inside a scheduler thread that recover_wedged abandoned while it was stuck
    in a dispatch: the thread unwinds without touching engine state (the slots and
    requests it knew were replaced). A BaseException, so no `except Exception` keeps the
    abandoned thread serving."""


@dataclass
class BatchRequest:
    prompt: list[int]
    max_tokens: int
    sampler: object
    on_token: Callable[[int], None] | None = None
    stop_check: Callable[[int], bool] | None = None
    # results
    out: list[int] = field(default_factory=list)
    finish: str = "length"
    error: Exception | None = None
    done: threading.Event = field(default_factory=threading.Event)
    stats: GenerationStats = field(default_factory=GenerationStats)
    cancelled: bool = False
    submit_t: float = 0.0  # perf_counter at submit()
    first_token_t: float = 0.0  # perf_counter at the first delivered token
    admit_t: float = 0.0  # perf_counter at the (latest) slot assignment
    # absolute perf_counter deadline of the whole request (queue + decode), 0 = none;
    # enforced once per scheduler pass, so its granularity is one dispatch
    deadline_t: float = 0.0
    # absolute perf_counter bound on the time queued before a slot, 0 = none
    queue_ttl_t: float = 0.0
    # durable resume: the last resume_tokens entries of `prompt` were generated and
    # delivered elsewhere (the caller's sampler arrives fast-forwarded past them)
    resume_tokens: int = 0
    # tenancy: the tenant (quota and fair-share key), the class ("interactive": strict
    # queue priority, may preempt batch rows; "batch": shed and preempted first), the
    # fair queue's virtual cost (prompt plus max_tokens) and the slots lost to
    # interactive arrivals
    tenant: str = DEFAULT_TENANT
    klass: str = "interactive"
    wfq_cost: float = 1.0
    preemptions: int = 0
    # disaggregation: export_kv asks _finish for a host snapshot of the prompt's full KV
    # blocks, kv_export = (tokens, [(k, v) per block], block_tokens), set before done
    export_kv: bool = False
    kv_export: tuple | None = None
    # identity: the request id (the flight-recorder key) and its trace context
    # (obs.reqctx.TraceContext), which the scheduler thread re-enters around the
    # request's work
    rid: str = ""
    ctx: object = None
    # grammar-constrained decoding: the compiled TokenAutomaton the output must satisfy
    # (None = unconstrained) and the grammar hash the api edge logged. Compiled at the
    # edge, so the engine never needs tokenizer bytes
    constraint: object = None
    constraint_hash: str = ""

    def cancel(self) -> None:
        """Ask the scheduler to stop decoding this request (client went away)."""
        self.cancelled = True

    def wait(self, timeout=None) -> list[int]:
        if not self.done.wait(timeout):
            # a timed-out waiter must not leave the request decoding with its slot
            self.cancel()
            raise TimeoutError(
                f"generation not finished within {timeout}s (auto-cancelled)")
        if self.error is not None:
            raise self.error
        return self.out


class _SlotConstraint:
    """Per-slot grammar state (scheduler-thread-only). `state` is the LOCAL automaton
    state, the host mirror of the device carry, advanced in _emit per DELIVERED token, so
    after a full delivery host and device agree exactly (a flushed or partial dispatch
    uploads from here, as the sampler state does). `offset` rebases local states into the
    engine's ConstraintTable; `degraded` parks the row on the universal state 0 after a
    mask fault or a divergence — visible in metrics and the flight record, never to the
    client."""

    __slots__ = ("automaton", "state", "offset", "ghash", "degraded")

    def __init__(self, automaton, offset: int, ghash: str = ""):
        self.automaton = automaton
        self.state = 0
        self.offset = offset
        self.ghash = ghash
        self.degraded = False

    @property
    def gstate(self) -> int:
        """The GLOBAL table state uploaded to the device (0 = the universal row)."""
        return 0 if self.degraded else self.offset + self.state


class _Slot:
    def __init__(self, index: int):
        self.index = index
        self.pos = 0  # next cache position for this row
        self.history: list[int] = []  # tokens whose KV is written (same-slot rewind)
        self.req: BatchRequest | None = None
        self.pending: list[int] = []  # prompt tokens not yet prefilled
        self.last_token = 0  # feeds the next decode step
        self.last_logits: np.ndarray | None = None
        # on the card, the device sampler's pick from last_logits for a stochastic row
        # (its coin already drawn): taken by _advance_row in place of a host sample
        self.picked: int | None = None
        # pool block ids backing positions [0, len(blocks)·bt); retained across requests
        # like `history` — the same-slot rewind's backing store
        self.blocks: list[int] = []
        # last_token is sampled and delivered but its KV not yet written: a dispatch
        # that fails after _advance_row must not re-advance the row on retry
        self.armed = False
        # token sampled on the device (the tail of a super-step block) and delivered,
        # its KV not yet written: consumed by _advance_row instead of a host sample
        self.next_token: int | None = None
        # set when a super-step parks this row clamped at seq_len - 1, whose scratch
        # write destroys that history row: the history is truncated to it
        self.clamp_pos: int | None = None
        # the prefix-cache lease the request was seeded from (released at _finish)
        self.lease = None
        self.admit_t = 0.0  # monotonic time of the admission (the dispatch watchdog)
        # the request's per-tenant delivery counter, resolved once at admission
        self.tok_counter = None
        # the grammar handle: attached at admission when the request carries an
        # automaton, advanced in _emit, released at finish, preemption and recovery
        self.constraint: _SlotConstraint | None = None


class _InflightStep:
    """An issued, not yet delivered K-step super-step or draft-verify block: the host
    copy of its (K, B) token block (`fetch`), the device
    carry (last token, positions, sampler state) a chained dispatch starts from, and the
    host schedule it was issued against — full B-length starts/budget/temps and the
    (slot, request) pairs of its live rows. A chained dispatch's schedule assumes its
    predecessor delivers every budgeted token, and is checked against the actual
    delivery.

    kind "verify": the block is the (T, B) per-position targets, `fetch` also returns
    the (B,) accepted lengths, `ndraft` holds the per-row draft counts (-1 = parked)
    and `budget` the per-row maximum emit (ndraft + 1); delivery emits acc + 1. The
    carry is rewound to each row's frontier on the device."""

    __slots__ = ("rows", "k", "starts", "budget", "temps", "fetch", "tok", "pos", "rng",
                 "t_issue", "kind", "ndraft", "chained", "cstate", "seq")

    def __init__(self, rows, k, starts, budget, temps, fetch, tok, pos, rng, t_issue,
                 kind="scan", ndraft=None, chained=False, cstate=None, seq=0):
        self.rows = rows  # list[(slot, request)] of the rows with budget > 0
        self.k = k
        self.starts = starts  # each row's expected start position
        self.budget = budget
        self.temps = temps
        self.fetch = fetch  # waits for the block's host copy: [toks (K, B)] (+ acc)
        self.tok = tok  # device (B,) block-tail tokens (the next dispatch's input)
        self.pos = pos  # device (B,) positions after the budgeted steps
        self.rng = rng  # device (B, 2) advanced xorshift* states
        self.t_issue = t_issue
        self.kind = kind  # "scan" | "verify"
        self.ndraft = ndraft  # verify: per-row draft counts (-1 = parked)
        self.chained = chained  # issued from a predecessor's device carry
        # masked dispatch only: device (B,) GLOBAL constraint states after the budgeted
        # emissions, which a chained masked super-step starts from
        self.cstate = cstate
        self.seq = seq  # the engine's count of loop dispatches at this one's issue


class BatchEngine:
    """Engine-compatible construction (same spec/params arguments), `slots` sequences.

    submit() for async operation, generate() for the Engine-compatible blocking call.
    The scheduler thread starts lazily on first submit and stops with close()."""

    def __init__(self, spec: ModelSpec, params, tokenizer=None, *, slots: int = 2,
                 superstep: int = 1, pipeline: bool = True, prefix_cache=True,
                 prefix_cache_blocks: int = 0, prefix_block_tokens: int = 16,
                 prefix_cache_q80: bool = False, speculative: int = 0,
                 draft_model=None, draft_k: int = 0, constrain_states: int = 512,
                 tenants=None,
                 slo_ttft_interactive: float = 0.0, slo_ttft_batch: float = 0.0,
                 slo_tpot_interactive: float = 0.0,
                 paged_kv: bool = True, kv_block_tokens: int = 16,
                 kv_pool_blocks: int = 0, max_queue: int = 0, queue_ttl: float = 0.0,
                 dp: int = 1, **engine_kw):
        from ..cache import PrefixCache
        from ..constrain import GrammarProposer

        assert slots >= 1 and superstep >= 1
        if dp != 1:
            raise ValueError(f"dp={dp}: the BatchEngine over data parallelism is not in "
                             "the port yet (ROADMAP Queue A item 1 (a): dp, with the "
                             "dense-cache path the JAX engine takes under dp)")
        mesh = engine_kw.get("mesh")
        if (engine_kw.get("sp") or 1) > 1 or (mesh is not None and mesh.sp > 1):
            # JAX runtime/batch_engine.py:510-513
            raise ValueError("continuous batching needs per-row cache positions, which the "
                             "sequence-sharded (ring) cache does not support")
        tp = mesh.tp if mesh is not None else (engine_kw.get("tp") or 1)
        if tp > 1 and draft_model is not None:
            raise ValueError("the model drafter under tp > 1 is not in the port yet "
                             "(ROADMAP Queue A item 1 (c): the drafter under tp)")
        self.slots_n = slots
        self.superstep = superstep  # K: decode steps per super-step dispatch
        # chain dispatch N+1 from N's device carry while N is delivered; K = 1 has no
        # block to overlap
        self.pipeline = bool(pipeline) and superstep >= 2
        self._inflight: _InflightStep | None = None
        # (k, mode, window) -> batched decode loop; ("verify", t, mode, window) -> verify
        self._loops: dict = {}
        self.spec = spec
        # speculation: up to spec_k drafted tokens per row, verified in one (B, 1 + k)
        # dispatch
        self.spec_k = max(int(speculative), 0)
        if self.spec_k:
            # a verify block must fit the context with room to decode
            self.spec_k = min(self.spec_k, spec.seq_len - 2)
        # optimistic start: speculation engages at once and the EMA adapts down
        self._spec_ema = float(self.spec_k)
        # per-row draft length from each row's accept EMA, in verify-bucket steps
        self.adaptive = AdaptiveK(self.spec_k) if self.spec_k else None
        self.tokenizer = tokenizer
        kv_pool_cfg = None
        # a shared host PrefixCache instance asks for its copy-in/copy-out semantics:
        # the dense layout
        if paged_kv and not isinstance(prefix_cache, PrefixCache):
            bt = max(int(kv_block_tokens), 1)
            while bt > 1 and spec.seq_len % bt:
                bt //= 2  # block tokens divide seq_len
            w = spec.seq_len // bt
            n_blocks = int(kv_pool_blocks) or (slots * w + slots + 1)
            # floor: one full context + the scratch block + one spare
            kv_pool_cfg = (max(n_blocks, w + 2), bt)
        self._eng = Engine(spec, params, tokenizer, batch=slots, kv_pool=kv_pool_cfg,
                           **engine_kw)
        # tp: the control channel to the other ranks (parallel/replay.py), rank 0 leading
        self._ctl = None
        self.leader = True
        if self._eng.tp > 1:
            from ..parallel.replay import ControlChannel

            self._ctl = ControlChannel(self._eng.mesh)
            self.leader = self._ctl.leader
        # the model drafter: a second, small model beside the target that drafts up to
        # draft_k (default spec_k) tokens a row in one scan; n-gram lookup stays the
        # per-row fallback, and the whole proposer when the drafter does not load (its
        # own failure, speculative.drafter_failure; anything else propagates)
        self.drafter = None
        if draft_model is not None and self.spec_k:
            try:
                from ..draft.drafter import ModelDrafter

                eng = self._eng
                dkw = dict(slots=slots, target_spec=spec, tokenizer=tokenizer,
                           device=eng.device, dtype=eng.dtype, use_kernels=eng.use_kernels,
                           k_cap=min(int(draft_k) or self.spec_k, self.spec_k),
                           cuda_graph=eng.cuda_graph)
                if isinstance(draft_model, (tuple, list)):
                    self.drafter = ModelDrafter(draft_model[0], draft_model[1], **dkw)
                else:
                    self.drafter = ModelDrafter.load(str(draft_model), **dkw)
            except Exception as e:
                if not drafter_failure(e):
                    raise
                print(f"⚠️  draft model unavailable ({e!r}) — degrading to n-gram drafting",
                      file=sys.stderr, flush=True)
        # grammar-constrained decoding: the ConstraintTable is created at the first
        # constrained admission (an unconstrained engine never pays its (cap, V) arrays),
        # and the GrammarProposer rides the mux, so constrained rows draft their forced
        # chains while co-batched rows keep model or n-gram drafts
        self.constrain_states = max(int(constrain_states), 2)
        self.constrain_table = None
        self.constrain_degraded = 0
        self.grammar_proposer = GrammarProposer()
        self.proposer = ProposerMux(NgramProposer(), self.drafter,
                                    grammar=self.grammar_proposer)
        # the engine's resolution (kwarg or DLT_PROLOGUE), as the JAX engine checks it
        if self._eng.fused_prologue and slots > 1:
            print("⚠️  --prologue is inert with batched decode (the prologue kernels take "
                  "one activation row; forward gates them off for B > 1)",
                  file=sys.stderr, flush=True)
        self.kv_pool = None  # DeviceKVPool metadata (None = dense layout)
        self._kv_bt = 0
        if kv_pool_cfg is not None:
            from ..cache.device_pool import DeviceKVPool

            n_blocks, self._kv_bt = kv_pool_cfg
            self.kv_pool = DeviceKVPool(n_blocks, self._kv_bt)
            self._tables_np = np.zeros((slots, spec.seq_len // self._kv_bt), np.int32)
            # the static device table: edits copy into it before the next dispatch
            self._tables_dev = torch.zeros(self._tables_np.shape, dtype=torch.int32,
                                           device=self._eng.device)
            self._tables_dirty = False
        # the prefix cache: in pool mode the radix directory over device blocks, whose
        # cold tier is a host KVBlockPool sized like the dense host cache; dense: the
        # host PrefixCache (False disables, a PrefixCache instance is shared)
        self.prefix_cache = None
        eng = self._eng
        if self.kv_pool is not None:
            if prefix_cache:
                from ..cache import default_pool_blocks
                from ..cache.device_pool import PagedPrefixCache

                cold = prefix_cache_blocks or default_pool_blocks(
                    (spec.n_layers, slots, spec.n_kv_heads, spec.seq_len, spec.head_size),
                    eng.k_cache.element_size(), self._kv_bt, slots)
                self.prefix_cache = PagedPrefixCache(self.kv_pool, self._kv_bt,
                                                     cold_blocks=cold, q80=prefix_cache_q80)
        else:
            from ..cache import make_prefix_cache

            self.prefix_cache = make_prefix_cache(
                eng.k_cache.shape, eng.k_cache.element_size(), slots=slots,
                prefix_cache=prefix_cache, blocks=prefix_cache_blocks,
                block_tokens=prefix_block_tokens, q80=prefix_cache_q80)
        # admission seeding: host->device KV bytes moved and wall ms spent seeding slots
        # (0 bytes for a directory remap; a cold promotion or a dense seed moves rows),
        # and the directory blocks remapped into slot tables
        self.seed_bytes = 0
        self.seed_ms = 0.0
        self.remapped_blocks = 0
        # disaggregation: blocks exported at finish and the wall ms their host copies took
        self.exported_blocks = 0
        self.export_ms = 0.0
        self.prefilled_tokens = 0  # tokens run through prefill dispatches
        self._slots = [_Slot(i) for i in range(slots)]
        # tenancy: the registry of quotas and weights (None: one default tenant, no
        # quota, uniform weights), the SLO targets of the admission shed (0 = off) and
        # the measured decode pace the TPOT gate reads
        self.tenants: TenantRegistry | None = tenants
        self.slo_ttft = {"interactive": max(slo_ttft_interactive, 0.0),
                         "batch": max(slo_ttft_batch, 0.0)}
        self.slo_tpot_interactive = max(slo_tpot_interactive, 0.0)
        self._tpot_ema_ms = 0.0  # ms per delivered token, decayed (scheduler-written)
        self.preempted = 0  # batch rows preempted for an interactive admission
        # the wait queue: two-class weighted-fair over tenants
        self._queue = WeightedFairQueue(tenants)
        self._plock = threading.Lock()  # guards: _queue
        # held by the scheduler for each pass and by release_idle
        self._slock = threading.Lock()  # guards: _slots, kv_pool, _tables_np
        self.decode_steps = 0  # batched T=1 dispatches (a super-step counts once)
        self.super_steps = 0  # K-step dispatches delivered (a subset of decode_steps)
        self.verify_steps = 0  # draft-verify dispatches delivered (a subset too)
        self.spec_drafted = 0  # draft tokens verified
        self.spec_accepted = 0  # draft tokens accepted
        self.loop_steps = 0  # decode steps run by super-steps, flushed ones included
        self.mixed_steps = 0  # prefill dispatches carrying decode rows
        self.dispatches = 0  # every device dispatch (a super-step counts once)
        self.chained = 0  # super-steps issued from a predecessor's device carry
        self.flushes: collections.Counter = collections.Counter()  # chained, by reason
        self.rollback_tokens = 0  # device-decoded tokens discarded (stop, cancel, flush)
        # wall ms of each dispatch by kind: "decode" (one step), "super" (K steps, from
        # the later of its issue and the previous delivery to its block on the host),
        # "verify" (timed as "super"), "prefill", "mixed"; as in the JAX engine, a
        # decode step's time starts after the host sampling of its rows. The newest
        # DISPATCH_MS_KEEP of each kind (batch_dispatch_seconds counts them all)
        self.dispatch_ms: dict[str, collections.deque] = {
            key: collections.deque(maxlen=DISPATCH_MS_KEEP)
            for key in ("decode", "super", "verify", "prefill", "mixed")}
        self._last_ready_t: float | None = None
        # perf_counter at which the last dispatch's results reached the host: the
        # reference of batch_dispatch_gap_seconds
        self._gap_t: float | None = None
        # scheduler wakeup: submit() and close() notify
        self._cond = threading.Condition()
        self._shutdown = False
        self._draining = False  # close(drain=True): serve in-flight and queued, refuse new
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # guards: _thread, _epoch
        # the scheduler epoch: recover_wedged bumps it to abandon a thread stuck in a
        # dispatch. Each scheduler thread keeps the epoch it was born into in _tls, so
        # its checks compare against that, not against a value read after the bump
        self._epoch = 0
        self._tls = threading.local()
        self.wedge_recoveries = 0  # recover_wedged calls
        # admission control: max_queue bounds the requests waiting for a slot (0 =
        # unbounded), queue_ttl how long one may wait (0 = no bound); plain attributes,
        # so a server can tune them live
        self.max_queue = max_queue
        self.queue_ttl = queue_ttl
        self.retries = 0  # transient dispatch failures retried
        self._last_dispatch_t: float | None = None  # monotonic: the watchdog's mark
        self._drain = DrainRate()  # completions/s: the Retry-After estimate
        _DISPATCH_AGE.set_function(self.dispatch_age)
        _SLOTS_TOTAL.set(slots)
        # tp: each dispatch kind's counted collectives, of its last dispatch on rank 0
        # (collective_stats); the world's failure, once an operation failed after its
        # descriptor went out; loop dispatches issued (a chained one names its
        # predecessor's); the host tier the followers mirror; a follower's device carry
        # and its own host tier
        self.collectives: dict[str, dict] = {}
        self.broken: BaseException | None = None
        self._issue_seq = 0
        self._sent_table = None
        self._carry = None
        self._shadow = None
        # the device-sampled token blocks and picks in issue order when a list (tests
        # and chip_smoke compare every rank's with rank 0's): (kind, fetch or picks)
        self.token_log: list | None = None
        if self._ctl is not None:
            if self.leader:
                tier = self._host_tier()
                if tier is not None:
                    tier.listener = (lambda ev, h, tag:
                                     self._mirror("tier", ev=ev, handle=h, tag=tag))
                self._sent_table = np.zeros_like(self._tables_np) if self.kv_pool else None
                self._ensure_thread()
                self._ctl.start_heartbeat(lambda: self._slock)
            else:
                from ..cache.block_pool import ShadowBlockPool

                bt = self._kv_bt or getattr(self.prefix_cache, "block_tokens", 0)
                self._shadow = ShadowBlockPool(bt) if bt else None

    @classmethod
    def load(cls, model_path: str, tokenizer_path: str | None = None, *,
             max_seq_len: int = 0, weights_ftype=None, slots: int = 2,
             **kw) -> "BatchEngine":
        """Engine.load-compatible constructor (same files, same vocab check)."""
        from ..formats.mfile import load_model
        from ..tokenizer.bpe import Tokenizer

        spec, params = load_model(model_path, max_seq_len, weights_ftype)
        tokenizer = Tokenizer.load(tokenizer_path) if tokenizer_path else None
        if tokenizer is not None and tokenizer.vocab_size != spec.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} != model vocab {spec.vocab_size}")
        return cls(spec, params, tokenizer, slots=slots, **kw)

    @property
    def engine(self) -> Engine:
        return self._eng

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, prompt: list[int], max_tokens: int, sampler, on_token=None,
               stop_check=None, *, deadline: float | None = None,
               ttl: float | None = None, rid: str | None = None, ctx=None,
               resume_tokens: int = 0, tenant: str = "", klass: str = "interactive",
               export_kv: bool = False, constraint=None,
               constraint_hash: str = "") -> BatchRequest:
        """Enqueue a request. `deadline` (seconds) bounds the whole request (queue and
        generation; finish "deadline" with the partial output, DeadlineExceeded before
        the first token); `ttl` bounds the queue wait only (in place of the engine's
        queue_ttl). `rid` and `ctx` set the request id (the flight-recorder key) and the
        trace context; both default from the caller's bound reqctx (api_server's handler
        thread) or are originated here. `resume_tokens` marks the last N entries of `prompt` as tokens a
        failed replica already generated and delivered (a durable resume): the caller
        passes the sampler fast-forwarded past their coins, admission prefills prompt
        plus those tokens (mostly a prefix-cache remap) and generation continues as the
        uninterrupted run would. `tenant` (default: the context's tenant, else the
        default tenant) keys the quota and the fair share; `klass` is "interactive" (strict priority, may preempt batch
        rows) or "batch" (shed and preempted first). `export_kv` snapshots the prompt's
        full KV blocks into `req.kv_export` before the request completes. `constraint` (a
        constrain.TokenAutomaton) constrains the output to its grammar, `constraint_hash`
        names the grammar in the flight record. Raises InvalidRequest for an unknown
        class or a grammar larger than the constraint table, EngineDraining while
        draining, EngineClosed
        after close(), QuotaExceeded when the tenant's bucket is empty, EngineSaturated
        when max_queue requests already wait or an SLO target sheds the class. Under tp
        only rank 0 takes requests; export_kv is refused there (ValueError)."""
        if not self.leader:
            raise RuntimeError("a tp follower takes no requests: rank 0 submits, this "
                               "rank runs follow()")
        if self.broken is not None:
            raise EngineClosed(f"the tp world failed: {self.broken!r}")
        if export_kv and self._ctl is not None:
            raise ValueError("KV export under tp > 1 is not in the port yet (ROADMAP "
                             "Queue A item 1 (c): /v1/kv under tp)")
        if self._draining and not self._shutdown:
            raise EngineDraining("BatchEngine is draining (serving in-flight requests "
                                 "only)")
        if self._shutdown:
            raise EngineClosed("BatchEngine is closed")
        faults.fire("batch.submit")
        if klass not in CLASSES:
            raise InvalidRequest(
                f"unknown scheduling class {klass!r} (want one of {CLASSES})")
        c = ctx if ctx is not None else reqctx.current()
        tenant = tenant or (c.tenant if c is not None else "") or DEFAULT_TENANT
        cost = float(len(prompt) + max(max_tokens, 1))
        if self.tenants is not None:
            # the quota first: a throttled tenant gets its 429 even on an empty queue
            try:
                self.tenants.acquire(tenant, cost)
            except Exception:
                _QUOTA_THROTTLED.labels(tenant=self.tenants.canonical(tenant)).inc()
                raise
        try:
            self._admission_control(tenant, klass, cost)
        except Exception:
            # a shed request received no service: its debit goes back
            if self.tenants is not None:
                self.tenants.refund(tenant, cost)
            raise
        req = BatchRequest(list(prompt), max_tokens, sampler, on_token, stop_check)
        req.tenant = tenant
        req.klass = klass
        req.wfq_cost = cost
        req.export_kv = export_kv
        if constraint is not None:
            # an automaton that can never fit the table is the client's error (a 400),
            # not the runtime capacity condition alloc degrades on
            if getattr(constraint, "n_states", 0) > self.constrain_states - 1:
                if self.tenants is not None:
                    self.tenants.refund(tenant, cost)
                raise InvalidRequest(
                    f"grammar too large: {constraint.n_states} automaton states exceed "
                    f"the engine's constraint table ({self.constrain_states - 1} usable "
                    "states)")
            req.constraint = constraint
            req.constraint_hash = constraint_hash
        if not req.prompt:
            req.prompt = [self.tokenizer.bos_id if self.tokenizer else 1]
        req.resume_tokens = min(max(int(resume_tokens), 0), len(req.prompt))
        if req.resume_tokens:
            _RESUMED.inc()
            _RESUME_TOKENS.inc(req.resume_tokens)
        # the request's identity: the caller's trace context or a new one, carrying the
        # request id, so a fault fired in the request's scheduler scope lands on its
        # flight timeline
        rid = rid or (c.request_id if c is not None and c.request_id else "")
        req.rid = rid or f"req-{uuid.uuid4().hex[:16]}"
        if c is None:
            req.ctx = reqctx.new_context(req.rid, tenant)
        elif c.request_id != req.rid or c.tenant != tenant:
            req.ctx = dataclasses.replace(c, request_id=req.rid, tenant=tenant)
        else:
            req.ctx = c
        flight.start(req.rid, req.ctx.trace_id, prompt_tokens=len(req.prompt),
                     max_tokens=max_tokens, **{"tenant": tenant, "class": klass})
        req.submit_t = time.perf_counter()
        if deadline is not None and deadline > 0:
            req.deadline_t = req.submit_t + deadline
        eff_ttl = self.queue_ttl if ttl is None else ttl
        if eff_ttl and eff_ttl > 0:
            req.queue_ttl_t = req.submit_t + eff_ttl
        # the queue first, then the thread: racing a recover_wedged, a request queued
        # before its epoch bump is failed (retriable) by the recovery, and one queued
        # after it finds _thread None and starts the fresh scheduler, which waits for
        # the recovery to finish
        with self._plock:
            self._queue.append(req)
        self._ensure_thread()
        with self._cond:
            self._cond.notify()
        return req

    def _admission_control(self, tenant: str, klass: str, cost: float) -> None:
        """Load shedding at submit. A refusal reason is the queue bound, the projected
        wait of the last place in line past the class's TTFT target (only with a
        backlog: an idle engine serves within a dispatch whatever a decayed drain rate
        says), or, for a batch arrival, the measured decode pace past the interactive
        TPOT target. Two displacements order the shed by policy, not by arrival: an
        interactive arrival that would be refused evicts the least entitled queued batch
        request instead, and a batch arrival at max_queue displaces the queue's least
        entitled batch resident when its own virtual finish tag is smaller. Every
        refusal carries a Retry-After from the measured drain rate."""
        with self._plock:
            queued = len(self._queue)
        reason = None
        if self.max_queue and queued >= self.max_queue:
            reason = "queue"
        tgt = self.slo_ttft.get(klass, 0.0)
        if reason is None and tgt and queued > 0:
            if self._drain.queue_wait(queued + 1) > tgt:
                reason = "slo_ttft"
        if (reason is None and klass == "batch" and self.slo_tpot_interactive
                and self._tpot_ema_ms > self.slo_tpot_interactive * 1e3):
            # decode is already past the interactive TPOT target: one more batch row
            # widens every shared dispatch further
            reason = "slo_tpot"
        if reason is None:
            return
        victim = None
        if klass == "interactive":
            with self._plock:
                victim = self._queue.evict_last("batch")
        elif reason == "queue":
            with self._plock:
                worst = self._queue.last_tag("batch")
                if (worst is not None
                        and self._queue.entry_tag(tenant, "batch", cost) < worst):
                    victim = self._queue.evict_last("batch")
        if victim is not None:
            self._shed_queued(victim, reason, queued)
            if klass == "interactive":
                _SLO_SHED.labels(**{"class": "batch"}).inc()
            return
        _SHED.inc()
        if reason != "queue":
            _SLO_SHED.labels(**{"class": klass}).inc()
        raise EngineSaturated(
            f"admission refused ({reason}): class={klass}, queue depth {queued}"
            + (f" at max_queue={self.max_queue}" if reason == "queue" else ""),
            retry_after=self._drain.retry_after(queued + 1))

    def _shed_queued(self, req: BatchRequest, reason: str, queued: int) -> None:
        """Fail a queued request displaced by a more entitled arrival with the error
        and Retry-After an admission-time shed would have given it."""
        _SHED.inc()
        req.error = EngineSaturated(
            f"shed from the wait queue ({reason}): a more entitled admission displaced "
            "this batch request", retry_after=self._drain.retry_after(queued))
        req.finish = "error"
        _REQUESTS.labels(finish="error").inc()
        flight.finish(req.rid, "error", error=repr(req.error))
        req.done.set()

    def generate(self, prompt: list[int], max_tokens: int, sampler, on_token=None,
                 stop_check=None) -> tuple[list[int], GenerationStats]:
        """Blocking Engine.generate-compatible call (rides the batched scheduler)."""
        req = self.submit(prompt, max_tokens, sampler, on_token, stop_check)
        out = req.wait()
        return out, req.stats

    @property
    def draining(self) -> bool:
        return self._draining and not self._shutdown

    def scheduler_alive(self) -> bool:
        """True while the scheduler can serve (running, or not yet started)."""
        t = self._thread
        return t is None or t.is_alive()

    def load_stats(self) -> dict:
        """The load reading a fleet router's poller takes from /healthz: slots, slots
        with no request, requests waiting for one, and whether the engine drains."""
        with self._plock:
            occupied = sum(1 for s in self._slots if s.req is not None)
            queued = len(self._queue)
        return {"slots": self.slots_n, "free_slots": self.slots_n - occupied,
                "queue_depth": queued, "draining": self.draining}

    def dispatch_age(self) -> float:
        """The watchdog reading (resilience/supervisor.py): 0 while no request holds a
        slot (an idle scheduler is not a hung one), else seconds since the scheduler
        last made progress — the later of the last completed dispatch and the oldest
        live admission, so a hang in the first dispatch after an idle spell counts from
        the moment work arrived."""
        busy = [s.admit_t for s in self._slots if s.req is not None]
        if not busy:
            return 0.0
        ref = min(busy)
        if self._last_dispatch_t is not None and self._last_dispatch_t > ref:
            ref = self._last_dispatch_t
        return max(time.monotonic() - ref, 0.0)

    def spec_stats(self) -> dict | None:
        """Speculation counters (the JAX engine's /v1/stats block, from the engine's
        own counters): verify dispatches, drafted and accepted tokens, the proposer mux
        (which drafter is live, its errors, whether it is disabled) and the adaptive
        controller's per-row k. None when speculation is off."""
        if not self.spec_k:
            return None
        out = {"k": self.spec_k, "verify_steps": self.verify_steps,
               "drafted_tokens": self.spec_drafted,
               "accepted_tokens": self.spec_accepted,
               "accept_rate": (self.spec_accepted / self.spec_drafted
                               if self.spec_drafted else None),
               "proposer": self.proposer.describe()}
        if self.adaptive is not None:
            out["adaptive"] = {"k_cap": self.adaptive.k_cap,
                               "buckets": list(self.adaptive.buckets),
                               "rows": {str(r): v
                                        for r, v in self.adaptive.stats().items()}}
        return out

    def constrain_stats(self) -> dict:
        """The constrained-decoding block of /v1/stats: rows decoding under a grammar,
        the table's capacity and use, and degradations (the api layer adds the edge's
        compile-cache stats)."""
        tbl = self.constrain_table
        return {"active_rows": tbl.active_rows if tbl is not None else 0,
                "table_states": self.constrain_states,
                "table_used": (sum(n for _off, n in tbl._regions.values())
                               if tbl is not None else 0),
                "degraded": self.constrain_degraded}

    def release_idle(self) -> int:
        """Drop the rewind stock (block tables and histories) of every idle slot and move
        every unreferenced directory block off the card (demoted to the host tier, or
        evicted without one), so the pool holds only the blocks of live requests. Safe
        from any thread: it runs between two scheduler passes. Returns the pool's free
        blocks."""
        if self.kv_pool is None:
            return 0
        with self._slock:
            for sl in self._slots:
                if sl.req is None and sl.blocks:
                    self._paged_release_slot(sl)
            if self.prefix_cache is not None:
                self.prefix_cache.reclaim(self.kv_pool.n_blocks, self._read_block)
            return self.kv_pool.free_blocks()

    def recover_wedged(self, error: Exception | None = None) -> bool:
        """The supervisor's escalation (resilience/supervisor.py): the scheduler made no
        progress — a dispatch or its result transfer hangs — so act on it:

        1. abandon the stuck scheduler thread: bump the epoch. The thread cannot be
           interrupted, but every path it can wake on checks its epoch before the next
           launch or state change and unwinds through _StaleEpoch; its locals hold the
           old slot objects, which are replaced below;
        2. fail every in-flight request, and every request queued before the bump, with
           EngineWedged (retriable: a durable fleet router resumes each elsewhere);
        3. re-initialize: drop the device loops and every captured step (each is
           captured again at its next use), zero the KV pool in place — its tensors
           keep their storage, which a second pool might not find room for beside the
           first — and empty the pool metadata, the prefix directory and the block
           tables. Nothing here waits for the device. Returns False when the
           re-initialization raised (the replica should stay unhealthy).

        A request submitted after the bump waits for the scheduler that its submit()
        starts, which runs once the engine is whole again. Safe from any thread. Refused
        under tp (ValueError): the followers would have to abandon and re-initialize in
        step with rank 0."""
        if self._ctl is not None:
            raise ValueError("recover_wedged under tp > 1 is not in the port yet "
                             "(ROADMAP Queue A item 1 (c): the hung-engine supervisor "
                             "under tp)")
        err = error if error is not None else EngineWedged(
            f"engine made no dispatch progress for {self.dispatch_age():.1f}s; in-flight "
            "requests failed (retriable) and the engine was re-initialized")
        # a fresh scheduler lock, installed with the bump and held through the swap and
        # the re-init: the abandoned thread may hold the old one for as long as it stays
        # stuck, and a scheduler started after the bump (a racing submit finds _thread
        # None) waits on this one until the engine is whole again
        slock = threading.Lock()
        slock.acquire()
        try:
            with self._lock:
                with self._plock:  # _admit checks the epoch under it: no stale admission
                    self._epoch += 1
                    stale = self._thread
                    self._thread = None  # the next submit starts a fresh scheduler
                    self._slock = slock
                    doomed = list(self._queue)
                    self._queue.clear()
            if (stale is not None and stale.is_alive()
                    and stale is not threading.current_thread()):
                # a live but slow scheduler sees the bump at its next check and exits; a
                # stuck one times this out and unwinds when it wakes
                stale.join(timeout=1.0)
            self.wedge_recoveries += 1
            old_slots = self._slots
            with self._plock:
                # fresh slot objects: nothing the abandoned thread holds reaches them
                self._slots = [_Slot(i) for i in range(self.slots_n)]
                # the constraint table's regions were keyed by the old slots: the whole
                # table goes (created again at the next constrained admission), and with
                # it, below, every loop and captured masked step that read it
                self.constrain_table = None
                _CONSTRAIN_ROWS.set(0)
            for s in old_slots:
                if self.prefix_cache is not None and s.lease is not None:
                    self.prefix_cache.release(s.lease)
                    s.lease = None
                if self.kv_pool is not None and s.blocks:
                    self.kv_pool.decref(s.blocks)
                    s.blocks = []
                req, s.req, s.pending = s.req, None, []
                self.proposer.detach(s.index)
                if self.adaptive is not None:
                    self.adaptive.detach(s.index)
                if req is not None:
                    doomed.append(req)
            for req in doomed:
                if not req.done.is_set():
                    req.error = err
                    req.finish = "error"
                    _WEDGE_FAILED.inc()
                    flight.finish(req.rid, "error", error=repr(err))
                    req.done.set()
            _QUEUE_DEPTH.set(0)
            _SLOTS_OCCUPIED.set(0)
            self._inflight = None
            _PIPELINE_DEPTH.set(0)
            self._last_ready_t = None
            self._last_dispatch_t = None  # the age restarts at the next admission
            try:
                faults.fire("engine.reinit")
                self._loops.clear()
                self._eng.reset_backend()
                if self.drafter is not None:
                    # an abandoned thread may still hold the drafter's steps: its graphs
                    # and scans go, its caches are zeroed in place, its rows re-prefill
                    self.drafter.reset_backend()
                if self.kv_pool is not None:
                    self.kv_pool.reset()
                    if self.prefix_cache is not None:
                        self.prefix_cache.reset()
                    self._tables_np[:] = 0
                    self._tables_dev.zero_()  # queued; the same storage
                    self._tables_dirty = False
            except Exception as e:
                print(f"🔴 engine re-initialization failed: {e!r}", file=sys.stderr,
                      flush=True)
                _WEDGE_RECOVERIES.labels(outcome="reinit_failed").inc()
                return False
            _WEDGE_RECOVERIES.labels(outcome="ok").inc()
            return True
        finally:
            slock.release()

    def close(self, drain: bool = False, timeout: float | None = None) -> None:
        """Stop the engine. drain=True (the SIGTERM path): refuse new submits
        (EngineDraining) and let every in-flight and queued request finish, for at most
        `timeout` seconds (None = 30), then close. drain=False: the waiters of in-flight
        and queued requests get EngineClosed at once."""
        if drain and not self._shutdown:
            self._draining = True
            end = time.monotonic() + (30.0 if timeout is None else timeout)
            while time.monotonic() < end:
                with self._plock:
                    busy = (any(s.req is not None for s in self._slots)
                            or bool(self._queue))
                if not busy:
                    break
                time.sleep(0.01)
        self._shutdown = True
        with self._cond:
            self._cond.notify_all()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=30)
        if self._ctl is not None and self.leader and not self._ctl.closed:
            # after the scheduler's last operation: the followers' loops end
            self._ctl.stop_heartbeat()
            with self._slock:
                try:
                    self._ctl.send("close")
                except Exception as e:
                    print(f"🔴 tp followers not told to close: {e!r}", file=sys.stderr,
                          flush=True)
        # detach the watchdog callback if it is still this engine's (a later engine may
        # have claimed the gauge): a bound method left on the module-global gauge would
        # keep this engine's weights and caches alive
        if _DISPATCH_AGE._fn == self.dispatch_age:
            _DISPATCH_AGE.set_function(None)
        err = EngineClosed("BatchEngine closed")
        with self._plock:
            for s in self._slots:
                if self.prefix_cache is not None and s.lease is not None:
                    self.prefix_cache.release(s.lease)
                    s.lease = None
                req = s.req
                if req is not None and not req.done.is_set():
                    req.error = err
                    s.req = None
                    s.pending = []
                    flight.finish(req.rid, "error", error=repr(err))
                    req.done.set()
            for req in self._queue:
                req.error = err
                flight.finish(req.rid, "error", error=repr(err))
                req.done.set()
            self._queue.clear()

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                # the epoch is fixed here, under the lock: a thread that starts running
                # after a recover_wedged bump exits at once
                self._thread = threading.Thread(target=self._loop, args=(self._epoch,),
                                                daemon=True, name="batch-engine")
                self._thread.start()

    def _assign(self, req: BatchRequest) -> _Slot | None:
        """Place a request on the free slot with the longest common token prefix and
        rewind it there (the multi-slot generalization of the reference NaiveCache),
        then extend the reuse from the prefix cache where it covers more of the prompt:
        a directory remap (paged) or a seed of the slot's rows (dense)."""
        free = [s for s in self._slots if s.req is None]
        if not free:
            return None
        # a preempted request re-admits as its prompt plus the tokens it delivered, the
        # construction of a durable resume: its sampler sits after exactly their coins
        full = req.prompt + req.out if req.out else req.prompt

        def common(s: _Slot) -> int:
            n = 0
            for a, b in zip(s.history, full):
                if a != b:
                    break
                n += 1
            return min(n, len(full) - 1)
        best = max(free, key=common)
        rewind = reuse = common(best)
        # the seed runs on the scheduler thread but belongs to this request: its
        # batch.prefix_seed span carries the request's trace id
        if self.kv_pool is not None:
            with reqctx.use(req.ctx):
                reuse = self._paged_adopt(best, reuse, full)
        elif self.prefix_cache is not None:
            # [0, reuse) is the slot's own rows; a seed on top counts as hit_tokens
            self.prefix_cache.note_resident(reuse)
            with reqctx.use(req.ctx):
                reuse = self._seed_from_cache(best, reuse, full)
        best.admit_t = time.monotonic()  # before .req: the watchdog keys on req
        req.admit_t = time.perf_counter()
        best.req = req
        best.pos = reuse
        best.history = list(full[:reuse])
        best.pending = full[reuse:]
        best.last_logits = None
        best.next_token = None
        best.clamp_pos = None
        best.armed = False
        # the drafting corpus: the whole prompt, the reused prefix included
        if self.spec_k:
            self.proposer.attach(best.index, full)
            if self.adaptive is not None:
                self.adaptive.attach(best.index)
        else:
            self.proposer.detach(best.index)
        self._attach_constraint(best, req)
        # the per-tenant delivery counter, resolved once so _emit pays no label lookup
        best.tok_counter = _TENANT_TOKENS.labels(
            tenant=self.tenants.canonical(req.tenant) if self.tenants is not None
            else req.tenant)
        req.stats.prompt_tokens = len(full)
        # the queue TTL bounds the wait before the first service only
        req.queue_ttl_t = 0.0
        # the prefill this admission skipped (rewind and remap or seed): for a resume,
        # the measure of what the new replica did not run again
        req.stats.reused_tokens = reuse
        qw_ms = (time.perf_counter() - req.submit_t) * 1e3 if req.submit_t else 0.0
        if req.submit_t:
            _QUEUE_WAIT.observe(qw_ms / 1e3)
        flight.event(req.rid, "admitted", slot=best.index, queue_wait_ms=round(qw_ms, 3),
                     rewind_tokens=rewind, seeded_tokens=reuse - rewind,
                     **({"resume_tokens": req.resume_tokens} if req.resume_tokens else {}))
        return best

    # ------------------------------------------------------------------
    # grammar constraints
    # ------------------------------------------------------------------

    def _attach_constraint(self, slot: _Slot, req: BatchRequest) -> None:
        """Bind the request's automaton to the slot: a region of the constraint table
        (created here at the first constrained admission, on the engine's device), the
        tokens the grammar already consumed replayed (a resume prefix, then a preempted
        request's delivered output), and the handle registered with the GrammarProposer.
        A full table degrades the row to unconstrained decoding."""
        slot.constraint = None
        self.grammar_proposer.detach(slot.index)
        aut = req.constraint
        if aut is None:
            if self.constrain_table is not None:
                _CONSTRAIN_ROWS.set(self.constrain_table.active_rows)
            return
        if self.constrain_table is None:
            from ..constrain import ConstraintTable

            self.constrain_table = ConstraintTable(self.spec.vocab_size,
                                                   self.constrain_states,
                                                   device=self._eng.device)
        off = self.constrain_table.alloc(slot.index, aut)
        if off is None:
            self.constrain_degraded += 1
            _CONSTRAIN_DEGRADED.labels(reason="capacity").inc()
            flight.event(req.rid, "constrain_degraded", reason="capacity",
                         grammar=req.constraint_hash)
            _CONSTRAIN_ROWS.set(self.constrain_table.active_rows)
            return
        sc = _SlotConstraint(aut, off, req.constraint_hash)
        # a replayed token outside the grammar means the constraint cannot be honored
        # from here: degrade rather than mask from the wrong state
        replay = req.prompt[len(req.prompt) - req.resume_tokens:] if req.resume_tokens else []
        for t in list(replay) + list(req.out):
            nxt = aut.advance(sc.state, t)
            if nxt < 0:
                sc.degraded = True
                self.constrain_degraded += 1
                _CONSTRAIN_DEGRADED.labels(reason="divergence").inc()
                flight.event(req.rid, "constrain_degraded", reason="divergence",
                             grammar=sc.ghash)
                break
            sc.state = nxt
        slot.constraint = sc
        self.grammar_proposer.attach_constraint(slot.index, sc)
        flight.event(req.rid, "constrain_attached", grammar=sc.ghash,
                     states=aut.n_states, offset=off)
        _CONSTRAIN_ROWS.set(self.constrain_table.active_rows)

    def _release_constraint(self, slot: _Slot) -> None:
        """Free the slot's table region (finish, preemption); the proposer side is
        cleared by ProposerMux.detach at the same call sites."""
        slot.constraint = None
        if self.constrain_table is not None:
            self.constrain_table.free(slot.index)
            _CONSTRAIN_ROWS.set(self.constrain_table.active_rows)

    def _degrade_constraint(self, slot: _Slot, reason: str) -> None:
        """Park the row on the universal (unconstrained) state after a masking fault or
        a grammar divergence: decoding continues without the constraint, and the
        degradation shows in constrain_degraded_total and the flight record."""
        sc = slot.constraint
        if sc is None or sc.degraded:
            return
        sc.degraded = True
        self.constrain_degraded += 1
        _CONSTRAIN_DEGRADED.labels(reason=reason).inc()
        if slot.req is not None:
            flight.event(slot.req.rid, "constrain_degraded", reason=reason,
                         grammar=sc.ghash)

    def _live_constraint(self, slot: _Slot) -> _SlotConstraint | None:
        sc = slot.constraint
        return sc if sc is not None and not sc.degraded else None

    def _mask_row(self, slot: _Slot) -> np.ndarray | None:
        """The packed allowed bitmask (W,) int32 of a constrained row's current state, or
        None when the row is unconstrained. The fault point `constrain.mask` fires here;
        an error degrades the row (None)."""
        sc = self._live_constraint(slot)
        if sc is None:
            return None
        try:
            faults.fire("constrain.mask", slot=slot.index)
        except Exception:
            self._degrade_constraint(slot, "mask")
            return None
        return sc.automaton.mask[sc.state].view(np.int32)

    def _constrained(self, rows) -> bool:
        """True when a live row of this dispatch decodes under a non-degraded grammar:
        only then do the masked builds engage, so unconstrained batches never pay the
        mask gather."""
        return any(self._live_constraint(s) is not None for s, _req in rows)

    def _cstate_vec(self) -> np.ndarray:
        """(B,) GLOBAL constraint states from the host mirrors, uploaded when a masked
        dispatch is not chained (a chained one starts from its predecessor's device
        carry). Unconstrained rows ride the universal state 0. `constrain.mask` fires
        here per constrained row: an error degrades that row."""
        cs = np.zeros(self.slots_n, np.int64)
        for s in self._slots:
            sc = s.constraint
            if sc is None:
                continue
            if not sc.degraded:
                try:
                    faults.fire("constrain.mask", slot=s.index)
                except Exception:
                    self._degrade_constraint(s, "mask")
            cs[s.index] = sc.gstate
        return cs

    # ------------------------------------------------------------------
    # device-resident paged KV
    # ------------------------------------------------------------------

    def _tables(self) -> torch.Tensor:
        """The static (B, W) device block table, brought up to date after a table edit
        (a few hundred bytes of metadata, never KV rows) by a copy queued behind the
        dispatches already issued, which read the table they were issued with."""
        if self._tables_dirty:
            upload(self._tables_dev, self._tables_np)
            self._tables_dirty = False
        return self._tables_dev

    def _changed_rows(self) -> dict[int, np.ndarray]:
        """tp leader: the table rows that changed since the last descriptor carried
        them (the followers' tables follow rank 0's)."""
        if self._sent_table is None:
            return {}
        changed = np.nonzero((self._tables_np != self._sent_table).any(axis=1))[0]
        self._sent_table[changed] = self._tables_np[changed]
        return {int(i): self._tables_np[i].copy() for i in changed}

    def _table_row(self, slot: _Slot) -> None:
        """Rewrite one slot's table row from slot.blocks (filler entries point at the
        scratch block, whose contents are never read)."""
        row = self._tables_np[slot.index]
        row[:] = 0
        row[:len(slot.blocks)] = slot.blocks
        self._tables_dirty = True

    def _paged_release_slot(self, slot: _Slot) -> None:
        """Drop a slot's whole table (and the rewind stock it backs)."""
        if slot.blocks:
            self.kv_pool.decref(slot.blocks)
        slot.blocks = []
        slot.history = []
        slot.pos = 0
        self._table_row(slot)

    def _paged_alloc(self, n: int, exclude: _Slot | None = None) -> list[int]:
        """Allocate n pool blocks, reclaiming idle slots' stock under pressure; raises
        KVPoolExhausted (request scope) when the pool cannot serve. `exclude` shields
        the slot being grown from the idle-slot reclaim."""
        from ..cache.device_pool import KVPoolExhausted

        ids = self.kv_pool.alloc(n)
        if ids is None:
            self._paged_reclaim(n, exclude=exclude)
            ids = self.kv_pool.alloc(n)
        if ids is None:
            raise KVPoolExhausted(
                f"device KV pool exhausted: {n} block(s) needed, "
                f"{self.kv_pool.free_blocks()} free after reclaim "
                "(raise --kv-pool-blocks or admit fewer long contexts)")
        return ids

    def _paged_reclaim(self, need: int, exclude: _Slot | None = None) -> None:
        """Free device blocks until `need` are free: demote (or evict) LRU unreferenced
        directory nodes first — the cold tier keeps the prefix servable — then drop idle
        slots' retained rewind tables (their committed blocks live on through the
        directory where it references them). Only the deficit is reclaimed."""
        deficit = need - self.kv_pool.free_blocks()
        if deficit <= 0:
            return
        if self.prefix_cache is not None:
            self.prefix_cache.reclaim(deficit, self._read_block)
        if self.kv_pool.free_blocks() >= need:
            return
        for sl in self._slots:
            if sl.req is None and sl.blocks and sl is not exclude:
                self._paged_release_slot(sl)
                if self.kv_pool.free_blocks() >= need:
                    return

    def _read_block(self, bid: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One pool block's rows (L, hk, bt, hs) on the host in the cache dtype — the
        directory's demotion payload, read behind every dispatch already issued."""
        from ..cache.wire import host_rows

        eng = self._eng
        self._mirror("read_block", bid=bid)  # each rank's own heads of the block
        return host_rows(eng.k_cache[:, bid]), host_rows(eng.v_cache[:, bid])

    def _block_copy(self, src: int, dst: int) -> None:
        """Device copy of pool block src into block dst, in place in both pools (queued
        on the stream the dispatches run on)."""
        eng = self._eng
        self._mirror("copy", src=src, dst=dst)
        eng.k_cache[:, dst].copy_(eng.k_cache[:, src])
        eng.v_cache[:, dst].copy_(eng.v_cache[:, src])

    def _paged_ensure(self, slot: _Slot, upto: int) -> None:
        """Grow the slot's table so every position < upto has a real block (writes
        beyond coverage land in the scratch block — fine for parked garbage, fatal for
        committed rows)."""
        need = -(-min(upto, self.spec.seq_len) // self._kv_bt) - len(slot.blocks)
        if need <= 0:
            return
        ids = self._paged_alloc(need, exclude=slot)
        start = len(slot.blocks)
        slot.blocks.extend(ids)
        self._tables_np[slot.index, start:start + need] = ids
        self._tables_dirty = True

    def _paged_cow(self, slot: _Slot, lo: int, hi: int) -> None:
        """Copy-on-write: make the blocks backing positions [lo, hi) exclusively owned
        before the slot writes there. A shared block (a directory reference or a sibling
        slot's remap) gets a private device copy, so the shared copy's committed rows
        are never written."""
        bt = self._kv_bt
        for idx in range(lo // bt, min(-(-hi // bt), len(slot.blocks))):
            bid = slot.blocks[idx]
            if not self.kv_pool.shared(bid):
                continue
            nb = self._paged_alloc(1, exclude=slot)[0]
            self._block_copy(bid, nb)
            self.kv_pool.decref([bid])
            self.kv_pool.note_cow()
            slot.blocks[idx] = nb
            self._tables_np[slot.index, idx] = nb
            self._tables_dirty = True

    def _paged_adopt(self, slot: _Slot, rewind: int, full: list[int]) -> int:
        """Paged admission: extend the same-slot rewind with a DIRECTORY REMAP — shared
        full blocks are increfed into the slot's table (zero bytes moved), a partly used
        boundary block gets a private device copy the slot can append into, and a cold
        (demoted) block pays one host→device upload into a fresh block, which the
        directory adopts. Returns the reuse length (the prefill start). Any failure
        falls back to what the rewind covers (warn_degraded).

        A chained super-step may still be in flight here (the scheduler admits before
        it delivers): the table edit reaches the device buffer at the next dispatch,
        and the copies and uploads below queue behind the in-flight step on the same
        stream, which writes only past its rows' frontiers."""
        bt = self._kv_bt
        pc = self.prefix_cache
        t0 = time.perf_counter()
        lease = None
        if pc is not None:
            pc.note_resident(rewind)
            try:
                # a seed fault costs only the cache hit: the request prefills instead
                self._fire("batch.cache_seed", slot=slot.index)
                lease = pc.lookup(full, cap=self.spec.seq_len - 1)
                if lease is not None and lease.tokens <= rewind:
                    pc.mark_unused(lease)
                    lease = None
            except Exception as e:
                from ..cache import warn_degraded

                warn_degraded("lookup", e)
                lease = None
        if lease is None:
            reuse = self._paged_adopt_rewind_only(slot, rewind)
            self.seed_ms += (time.perf_counter() - t0) * 1e3
            return reuse
        n = lease.tokens
        m = n // bt
        blocks: list[int] = []
        moved = 0
        try:
            with trace.span("batch.prefix_seed", {"slot": slot.index, "tokens": n,
                                                  "rewind": rewind, "remap": True}):
                for i, node in enumerate(lease.nodes):
                    tier, h = node.handle
                    if tier == "cold":
                        # promote: one upload into a fresh block, then the directory
                        # holds the device copy again. promote() takes the directory's
                        # own ref — the allocation ref is dropped right after
                        k, v = pc.fetch_cold(h)
                        nb = self._paged_alloc(1, exclude=slot)[0]
                        eng = self._eng
                        self._mirror("promote", handle=h, dst=nb)
                        eng.k_cache[:, nb].copy_(k)
                        eng.v_cache[:, nb].copy_(v)
                        # every rank uploads its own heads of the block: the job's bytes
                        moved += (k.nbytes + v.nbytes) * eng.tp
                        pc.promote(node, nb)
                        self.kv_pool.decref([nb])
                        tier, h = node.handle
                    if i < m:
                        self.kv_pool.incref([h])
                        blocks.append(h)
                    else:
                        # the partial boundary block: a private copy to append into
                        nb = self._paged_alloc(1, exclude=slot)[0]
                        self._block_copy(h, nb)
                        self.kv_pool.note_cow()
                        blocks.append(nb)
        except Exception as e:
            if blocks:
                self.kv_pool.decref(blocks)
            pc.mark_unused(lease)
            from ..cache import warn_degraded

            warn_degraded("seed", e)  # fall back to the rewind stock
            self.seed_ms += (time.perf_counter() - t0) * 1e3
            return self._paged_adopt_rewind_only(slot, rewind)
        old = slot.blocks
        slot.blocks = blocks
        if old:
            self.kv_pool.decref(old)
        self._table_row(slot)
        slot.lease = lease
        pc.mark_seeded(lease, n - rewind)
        _PREFIX_SEEDED.inc(n - rewind)
        _REMAPPED.inc(m)
        if moved:
            _SEED_BYTES.inc(moved)
        self.remapped_blocks += m
        self.seed_bytes += moved
        self.seed_ms += (time.perf_counter() - t0) * 1e3
        return n

    def _paged_adopt_rewind_only(self, slot: _Slot, rewind: int) -> int:
        """Admission without a directory hit: keep only the rewound prefix's blocks and
        make the boundary block writable (the first append lands at `rewind`, possibly
        inside a block the directory shares)."""
        bt = self._kv_bt
        keep = min(-(-rewind // bt), len(slot.blocks))
        if keep < len(slot.blocks):
            self.kv_pool.decref(slot.blocks[keep:])
            del slot.blocks[keep:]
            self._table_row(slot)
        if rewind % bt:
            self._paged_cow(slot, rewind, rewind + 1)
        return rewind

    def _seed_from_cache(self, slot: _Slot, reuse: int, full: list[int]) -> int:
        """Dense admission: when the host prefix cache covers more of the prompt than the
        slot's rewind, write the cached rows [reuse, n) into the slot's cache rows in
        place and return n (the prefill start). The lease stays on the slot until
        _finish; a failure falls back to plain prefill."""
        pc = self.prefix_cache
        try:
            self._fire("batch.cache_seed", slot=slot.index)
            lease = pc.lookup(full, cap=self.spec.seq_len - 1)
            if lease is None:
                return reuse
            if lease.tokens <= reuse:
                pc.mark_unused(lease)
                return reuse
        except Exception as e:
            from ..cache import warn_degraded

            warn_degraded("lookup", e)
            return reuse
        eng = self._eng
        n = lease.tokens
        t0 = time.perf_counter()
        try:
            with trace.span("batch.prefix_seed", {"slot": slot.index, "tokens": n,
                                                  "rewind": reuse}):
                # the span the rewind does not hold, as one (2, L, hk, n - reuse, hs)
                # buffer: one host->device transfer, one copy per cache tensor
                self._mirror("seed", slot=slot.index, skip=reuse, tokens=n,
                             handles=[node.handle for node in lease.nodes])
                rows = pc.fetch_packed(lease, skip=reuse).to(eng.device, eng.dtype)
                eng.k_cache[:, slot.index, :, reuse:n].copy_(rows[0])
                eng.v_cache[:, slot.index, :, reuse:n].copy_(rows[1])
        except Exception as e:
            pc.mark_unused(lease)
            from ..cache import warn_degraded

            warn_degraded("seed", e)
            return reuse
        self.seed_bytes += rows.numel() * rows.element_size() * eng.tp  # every rank's
        self.seed_ms += (time.perf_counter() - t0) * 1e3
        slot.lease = lease
        pc.mark_seeded(lease, n - reuse)
        _PREFIX_SEEDED.inc(n - reuse)
        return n

    def _fire(self, point: str, **ctx) -> None:
        """A fault point on the scheduler thread. A latency fault may park the thread
        past a recover_wedged; waking, it must go no further into the new epoch's
        state."""
        faults.fire(point, **ctx)
        self._check_epoch()

    def _check_epoch(self) -> None:
        if self._epoch != getattr(self._tls, "epoch", self._epoch):
            raise _StaleEpoch()

    def _before_launch(self) -> None:
        """Run by every dispatch just before its first launch: the epoch check (an
        abandoned thread never reaches the stream, where the captured steps would write
        the live pool and carries in place), the mark after which a failure is not
        retried, and the block table's upload."""
        self._check_epoch()
        self._tls.launched = True
        if self.kv_pool is not None:
            self._tables()

    # ------------------------------------------------------------------
    # tensor parallelism: rank 0's descriptors, the followers' replay
    # ------------------------------------------------------------------

    def _host_tier(self):
        """The host block pool the prefix cache demotes into (paged: the directory's
        cold tier; dense: the PrefixCache's pool), or None."""
        pc = self.prefix_cache
        if pc is None:
            return None
        return pc.cold if self.kv_pool is not None else pc.pool

    def _constrain_spans(self):
        """tp leader: the constraint-table rows the next device() uploads, for the
        masked dispatch's descriptor (None elsewhere)."""
        if self._ctl is None:
            return None
        return self.constrain_table.dirty_payload()

    def _mirror(self, kind: str, **payload) -> None:
        """tp leader: send one device-side operation to the followers before running it
        here (a no-op on one card and on the followers). Every call runs on the
        scheduler thread or under its lock (release_idle), so one descriptor goes out
        at a time and in the order the operations run. A dispatch's descriptor carries
        the table rows that changed since the last one."""
        if self._ctl is None or not self.leader:
            return
        if kind in ("step", "super", "verify"):
            payload["rows"] = self._changed_rows()
        try:
            self._ctl.send(kind, payload)
        except Exception as e:
            self._world_failed(e)
            raise

    def _world_failed(self, e: BaseException) -> None:
        """An operation failed after its descriptor went out (or the descriptor could
        not go out): the ranks may no longer pair their collectives, so no request is
        served again. The scheduler stops after failing the in-flight requests, and
        `broken` tells the server (which exits nonzero)."""
        if self.broken is not None:
            return
        self.broken = e
        self._shutdown = True
        self._ctl.stop_heartbeat()
        print(f"🔴 tp world failed ({e!r}): the engine stops serving", file=sys.stderr,
              flush=True)

    def _note_collectives(self, kind: str, traffic, shape: tuple[int, int]) -> None:
        """A dispatch's counted collectives (parallel/traffic.py), kept per kind with
        its shape (slots rows x T tokens x steps) and published as the gauges of program
        "batch_<kind>"."""
        from ..parallel.traffic import publish_traffic

        t, steps = shape
        self.collectives[kind] = {
            "sent_bytes_per_device": traffic.sent_bytes_per_device,
            "payload_bytes": traffic.total_payload_bytes, "counts": dict(traffic.counts),
            "rows": self.slots_n, "t": t, "steps": steps}
        publish_traffic(traffic, program=f"batch_{kind}")

    def collective_stats(self) -> dict | None:
        """Under tp: the wire, the rank's running total of counted wire bytes and the
        last dispatch of each kind's counted collectives (None on one card). The bytes a
        dispatch sends are collective_bytes_per_step(spec, tp, wire, rows, t) per step."""
        if self._ctl is None:
            return None
        eng = self._eng
        return {"tp": eng.tp, "wire": "q80" if eng.compress else "f32",
                "sent_bytes_total": eng.mesh.counter.total.sent_bytes_per_device,
                "descriptors": self._ctl.sent, "last": dict(self.collectives)}

    def token_blocks(self) -> list:
        """The logged device samples (token_log), resolved: per loop dispatch its token
        block (and a verify's accepted lengths) as lists, per step its device picks."""
        out = []
        for kind, x in self.token_log or []:
            out.append((kind, x if kind == "step" else [a.tolist() for a in x()]))
        return out

    def follow(self) -> int:
        """A tp follower (rank > 0): replay rank 0's operations on this rank's shard, in
        rank 0's order, until rank 0 closes its engine. Returns the operations replayed.
        An exception ends the rank (and the job with it)."""
        if self._ctl is None or self.leader:
            raise RuntimeError("follow() runs on a tp follower (rank > 0)")
        from ..parallel.replay import follow

        return follow(self._ctl, self._replay)

    def _replay(self, kind: str, p: dict) -> None:
        """A follower: run one of rank 0's operations (its _mirror descriptor) here."""
        eng = self._eng
        for i, row in p.get("rows", {}).items():
            self._tables_np[i] = row
            self._tables_dirty = True
        if kind == "step":
            tables = self._tables() if self.kv_pool is not None else None
            coins = p["coins"]
            out = eng.step_rows(p["tokens"], p["starts"], tables, p["reads"], coins)
            if self.token_log is not None:
                picks = [None] * len(p["reads"])
                if coins is not None:
                    for j, tok in zip(coins[0], out[1]):
                        picks[j] = tok
                self.token_log.append(("step", picks))
        elif kind in ("super", "verify"):
            self._replay_loop(kind, p)
        elif kind == "copy":
            self._block_copy(p["src"], p["dst"])
        elif kind == "read_block":
            self._shadow.read(eng.k_cache[:, p["bid"]], eng.v_cache[:, p["bid"]])
        elif kind == "read_rows":
            sl, t0, t1 = p["slot"], p["t0"], p["t1"]
            self._shadow.read(eng.k_cache[:, sl, :, t0:t1], eng.v_cache[:, sl, :, t0:t1])
        elif kind == "tier":
            ev, h = p["ev"], p["handle"]
            if ev == "put":
                self._shadow.put(h, p["tag"])
            else:
                getattr(self._shadow, ev)(h)
        elif kind == "promote":
            k, v = self._shadow.get(p["handle"])
            eng.k_cache[:, p["dst"]].copy_(k)
            eng.v_cache[:, p["dst"]].copy_(v)
        elif kind == "seed":
            from ..cache.prefix_cache import pack_rows

            lo, hi = p["skip"], p["tokens"]
            rows = pack_rows(self._shadow.get, p["handles"], self._shadow.block_tokens,
                             lo, hi).to(eng.device, eng.dtype)
            eng.k_cache[:, p["slot"], :, lo:hi].copy_(rows[0])
            eng.v_cache[:, p["slot"], :, lo:hi].copy_(rows[1])
        else:
            raise ValueError(f"a BatchEngine follower cannot replay {kind!r}")

    def _replay_loop(self, kind: str, p: dict) -> None:
        """A follower's super-step or verify block: the same loop on the same host
        inputs, or, chained, on its own carry of the dispatch rank 0 chained from."""
        eng = self._eng
        masked = p["masked"]
        if p["cspans"]:
            if self.constrain_table is None:
                from ..constrain import ConstraintTable

                self.constrain_table = ConstraintTable(self.spec.vocab_size,
                                                       self.constrain_states,
                                                       device=eng.device)
            self.constrain_table.apply_payload(p["cspans"])
        tables = self._tables() if self.kv_pool is not None else None
        if kind == "super":
            loop = self._batched_loop(p["k"], p["mode"], p["window"], masked)
            cin = p["cstate"]
            if p["chain"] is None:
                tok_in, pos_in, rng_in = p["tokens"], p["starts"], p["rng"]
            else:
                seq, tok_in, pos_in, rng_in, cst = self._carry
                if seq != p["chain"]:
                    raise RuntimeError(f"rank 0 chained from dispatch {p['chain']}, this "
                                       f"rank's carry is dispatch {seq}'s")
                cin = cst if cin is None else cin
            constrain = (cin, *self.constrain_table.device()) if masked else None
            out = loop(eng.rope, tok_in, eng.k_cache, eng.v_cache, pos_in, rng_in,
                       p["temps"], p["topps"], p["budget"], tables, constrain=constrain)
            block, carry = out[:1], out[1:4]
            cst = out[6] if masked else None
        else:
            loop = self._verify_loop(p["t"], p["mode"], p["window"], masked)
            constrain = ((p["cstate"], *self.constrain_table.device()) if masked
                         else None)
            out = loop(eng.rope, p["props"], eng.k_cache, eng.v_cache, p["starts"],
                       p["rng"], p["temps"], p["topps"], p["ndraft"], tables,
                       constrain=constrain)
            block, carry = out[:2], out[2:5]
            cst = out[7] if masked else None
        self._carry = (p["seq"], *carry, cst)
        if self.token_log is not None:
            self.token_log.append((kind, copy_to_host(*block)))

    def _dispatched(self, kind: str, call, shape: tuple[int, int] = (1, 1)):
        """Run one device dispatch with transient-fault retry. `call` runs
        _before_launch before its first launch. A failure classify()-ed 'transient' and
        raised before that point (an injected TransientDispatchError at a fault point)
        is retried up to MAX_RETRIES times with capped exponential backoff: nothing has
        reached the stream, so no carry or cache has moved. Anything else, and anything
        raised after the first launch, propagates (engine scope: a replay advances its
        buffers in place). The fault point `batch.dispatch` fires (kind, attempt)
        before each attempt. The epoch is checked before the first launch and after the
        call; a mismatch raises _StaleEpoch. Under tp `shape` = (T, steps) of the
        dispatch names what its counted collectives (`collectives[kind]`) cover, and a
        failure after the descriptor went out (the launch mark) fails the world."""
        delay = RETRY_BACKOFF
        attempt = 0
        # the thread's epoch, not a fresh read: a bump landing before this call must
        # still be seen after it
        epoch = getattr(self._tls, "epoch", self._epoch)
        while True:
            self._tls.launched = False
            try:
                faults.fire("batch.dispatch", kind=kind, attempt=attempt)
                if self._ctl is None:
                    out = call()
                else:
                    with self._eng.mesh.counter.window() as traffic:
                        out = call()
                    self._note_collectives(kind, traffic, shape)
                if self._epoch != epoch:
                    raise _StaleEpoch()
                self._last_dispatch_t = time.monotonic()
                return out
            except Exception as e:
                if self._epoch != epoch:
                    raise _StaleEpoch() from None
                if self._ctl is not None and self._tls.launched:
                    self._world_failed(e)
                if (classify(e) != "transient" or self._tls.launched
                        or attempt >= MAX_RETRIES):
                    raise
                self.retries += 1
                _ENGINE_ERRORS.labels(kind="transient").inc()
                _RETRIES.inc()
                attempt += 1
                # the retry stalls every in-flight request alike: each timeline says so
                for s in self._slots:
                    if s.req is not None:
                        flight.event(s.req.rid, "dispatch_retry", kind=kind,
                                     attempt=attempt)
                time.sleep(min(delay, 1.0))
                delay *= 2

    def _step(self, tokens_rows: list[list[int]], starts: list[int], t: int,
              reads: list[tuple[int, int]], kind: str, samplers: list = ()
              ) -> tuple[np.ndarray, list]:
        """Run one batched (B, t) step; returns the logits of the (row, position) pairs
        in `reads`, (len(reads), vocab), and per read the token the device sampler
        picked from them, or None. On the card each read whose Sampler (`samplers[j]`)
        is stochastic is picked there, all in one call: one coin from each Sampler, as a
        host sample would draw, and the same sampler the super-steps run; a constrained
        row's pick is masked by its grammar state, as its host sample would be."""
        picks: list = [None] * len(reads)

        def call():
            self._before_launch()
            tables = self._tables_dev if self.kv_pool is not None else None
            # the coins after the launch mark: an attempt is retried only before it,
            # so no coin is drawn twice
            coins = self._coins(samplers, [self._slots[r] for r, _ in reads])
            self._mirror("step", tokens=tokens_rows, starts=starts, reads=reads,
                         coins=coins)
            out = self._eng.step_rows(tokens_rows, starts, tables, reads, coins)
            if coins is None:
                return out
            logits, toks = out
            for j, tok in zip(coins[0], toks):
                picks[j] = tok
            return logits
        logits = self._dispatched(kind, call, (t, 1))
        if self.token_log is not None:
            self.token_log.append(("step", list(picks)))
        # the step's logits are on the host: the reference the next decode issue's
        # device-idle gap is measured from
        self._gap_t = time.perf_counter()
        self.dispatches += 1
        return logits, picks

    def _coins(self, samplers, slots: list) -> tuple | None:
        """The device sampler's inputs for the stochastic reads of a step on the card:
        (read indices, coins, temperatures, top-ps, masks), each coin drawn from its
        read's Sampler; masks is None, or (n, W) int32 packed bitmasks (all ones for an
        unconstrained read) when a read's row decodes under a grammar. None on the CPU,
        where the host Sampler samples, or with no stochastic read."""
        if self._eng.device.type != "cuda":
            return None
        idx, coins, temps, topps, masks = [], [], [], [], []
        for j, smp in enumerate(samplers):
            temp = float(getattr(smp, "temperature", 0.0))
            if temp == 0.0 or not hasattr(smp, "next_coin"):
                continue
            idx.append(j)
            coins.append(smp.next_coin())
            temps.append(temp)
            topps.append(float(smp.topp))
            masks.append(self._mask_row(slots[j]))
        if not idx:
            return None
        if all(m is None for m in masks):
            return idx, coins, temps, topps, None
        words = (self.spec.vocab_size + 31) // 32
        full = np.full(words, -1, np.int32)
        return idx, coins, temps, topps, np.stack([full if m is None else m for m in masks])

    def _finish(self, slot: _Slot, finish: str) -> None:
        req = slot.req
        req.finish = finish
        # the engine's side of the flight record; the api layer adds TTFT and E2E after.
        # `error` only when real: it marks the record for the slow log
        flight.finish(req.rid, finish, generated_tokens=req.stats.generated_tokens,
                      **({"error": repr(req.error)} if req.error is not None else {}))
        slot.req = None
        slot.pending = []
        slot.next_token = None
        slot.tok_counter = None
        self.proposer.detach(slot.index)
        if self.adaptive is not None:
            self.adaptive.detach(slot.index)
        self._release_constraint(slot)
        self._drain.note()  # one completion: the Retry-After estimate's rate
        _DRAIN_RATE.set(self._drain.rate())
        _TENANT_REQUESTS.labels(
            tenant=(self.tenants.canonical(req.tenant) if self.tenants is not None
                    else req.tenant), **{"class": req.klass}).inc()
        if self.prefix_cache is not None and slot.lease is not None:
            # the lease pins blocks for the in-flight period only: released before
            # done.set(), so a caller seeing completion sees no residual reservation
            self.prefix_cache.release(slot.lease)
            slot.lease = None
        if slot.clamp_pos is not None:
            # a super-step parked this row clamped: its history ends before that row
            self._truncate_history(slot, slot.clamp_pos)
            slot.clamp_pos = None
        if req.export_kv:
            # before done.set(): the /v1/kv handler wakes on done and reads kv_export
            try:
                req.kv_export = self._export_slot_blocks(slot, len(req.prompt))
            except Exception as e:
                from ..cache import warn_degraded

                warn_degraded("export", e)
        _REQUESTS.labels(finish=finish).inc()
        req.done.set()
        # the harvest runs after done.set(): the slot's history and rows stay valid (they
        # also back the same-slot rewind), and it must not extend the client's wait
        if self.prefix_cache is not None:
            self._harvest_into_cache(slot)

    def _harvest_into_cache(self, slot: _Slot) -> None:
        """Commit the finished slot's history to the prefix cache: its full blocks join
        the directory by reference (paged: no copy at all), or its rows are copied into
        the host pool (dense). history's rows [0, len(history)) are committed by
        construction — every truncation site shrinks history before the rows are
        overwritten, and a chained super-step still in flight writes only past it."""
        pc = self.prefix_cache
        try:
            if self.kv_pool is not None:
                n = len(slot.history) // self._kv_bt
                if n:
                    with trace.span("batch.prefix_insert",
                                    {"slot": slot.index, "tokens": n * self._kv_bt,
                                     "remap": True}):
                        pc.insert_blocks(slot.history, slot.blocks[:n])
            elif len(slot.history) >= pc.block_tokens:
                eng = self._eng
                from ..cache.wire import host_rows

                def harvest(t0: int, t1: int):
                    self._mirror("read_rows", slot=slot.index, t0=t0, t1=t1)
                    return (host_rows(eng.k_cache[:, slot.index, :, t0:t1]),
                            host_rows(eng.v_cache[:, slot.index, :, t0:t1]))

                with trace.span("batch.prefix_insert",
                                {"slot": slot.index, "tokens": len(slot.history)}):
                    pc.insert(slot.history, harvest)
        except Exception as e:  # a failed insert must not kill the scheduler
            from ..cache import warn_degraded

            warn_degraded("insert", e)

    def _export_slot_blocks(self, slot: _Slot, prompt_len: int):
        """Host snapshot of the slot's committed prompt KV as full blocks — the
        disaggregation export: (tokens, [(k, v) per block], block_tokens), each side an
        (L, hk, bt, hs) CPU tensor in the cache dtype, or None when the prompt holds no
        full block. Only full blocks go (a partial tail has no directory home on the
        importing side); the history is already truncated at a clamped park."""
        from ..cache.wire import host_rows

        bt = self._kv_bt or (self.prefix_cache.block_tokens
                             if self.prefix_cache is not None else 0)
        if bt <= 0:
            return None
        n = min(prompt_len, len(slot.history)) // bt
        if n == 0:
            return None
        t0 = time.perf_counter()
        eng = self._eng
        if self.kv_pool is not None:
            blocks = [self._read_block(bid) for bid in slot.blocks[:n]]
        else:
            k = host_rows(eng.k_cache[:, slot.index, :, :n * bt])
            v = host_rows(eng.v_cache[:, slot.index, :, :n * bt])
            blocks = [(k[:, :, i * bt:(i + 1) * bt], v[:, :, i * bt:(i + 1) * bt])
                      for i in range(n)]
        self.export_ms += (time.perf_counter() - t0) * 1e3
        self.exported_blocks += n
        return list(slot.history[:n * bt]), blocks, bt

    def import_kv_blocks(self, tokens: list[int], blocks: list) -> int:
        """Adopt KV blocks shipped from another replica (the decode half of a
        disaggregated admission) into the prefix cache: `blocks[i]` is the (k, v) host
        pair, (L, hk, bt, hs) each, of token block i of `tokens`. Host bookkeeping only,
        safe from any thread: the paged directory takes them as cold nodes (admission
        promotes them with one upload on the scheduler thread), the dense host cache
        inserts them (admission seeds the slot's rows from it). Blocks of another
        geometry are refused. Returns the token span the cache now covers (0: nothing
        imported, the request prefills locally)."""
        if self._ctl is not None:
            raise ValueError("KV import under tp > 1 is not in the port yet (ROADMAP "
                             "Queue A item 1 (c): /v1/kv under tp)")
        pc = self.prefix_cache
        if pc is None:
            return 0
        bt = pc.block_tokens
        n = min(len(tokens) // bt, len(blocks))
        if n <= 0:
            return 0
        sp = self.spec
        want = (sp.n_layers, sp.n_kv_heads, bt, sp.head_size)
        if any(tuple(x.shape) != want for b in blocks[:n] for x in b):
            return 0
        span = list(tokens[:n * bt])
        if self.kv_pool is not None:
            return pc.insert_cold(span, blocks[:n]) * bt
        k = torch.cat([torch.as_tensor(b[0]) for b in blocks[:n]], dim=2)
        v = torch.cat([torch.as_tensor(b[1]) for b in blocks[:n]], dim=2)
        pc.insert(span, lambda t0, t1: (k[:, :, t0:t1], v[:, :, t0:t1]))
        # what the cache holds, not what it was handed: a pool pinned full by leases
        # may refuse blocks, and the admission would then prefill them
        return pc.covered_blocks(span) * bt

    def _truncate_history(self, sl: _Slot, p: int) -> None:
        """Truncate a slot's reusable history to p tokens — its rows >= p are (about to
        be) overwritten by clamped scratch writes — and shrink any prefix-cache lease
        past p, so the reservation does not pin blocks the slot no longer holds."""
        if p < len(sl.history):
            sl.history = sl.history[:p]
        if sl.lease is not None and p < sl.lease.tokens:
            self.prefix_cache.shrink(sl.lease, p)

    def _park_positions(self, t: int) -> list[int]:
        """Per-row start positions for rows not participating in this step: park at
        the row's current pos so garbage lands on masked future positions, clamped so
        the write stays inside the cache. A clamped park (a row within t of the end)
        overwrites that row's tail history, so its reusable prefix is truncated and, in
        pool mode, the blocks the scratch writes land in are made private first; an idle
        paged slot is released instead. A pool that cannot serve that copy fails only
        the row's request (callers re-filter their rows afterwards)."""
        s = self.spec.seq_len
        starts = []
        for sl in self._slots:
            p = min(sl.pos, max(s - t, 0))
            if p < sl.pos:
                if self.kv_pool is not None and sl.req is None:
                    self._paged_release_slot(sl)
                    starts.append(0)
                    continue
                self._truncate_history(sl, p)
                if self.kv_pool is not None:
                    try:
                        self._paged_cow(sl, p, min(p + t, s))
                    except Exception as e:
                        if classify(e) != "request":
                            raise
                        self._fail_request(sl, e)
                        self._paged_release_slot(sl)
                        p = 0
            starts.append(p)
        return starts

    def _admit(self) -> None:
        """Expire queued requests past their queue TTL or deadline (finish "deadline";
        DeadlineExceeded unless a preemption left delivered output), then assign queued
        requests in weighted-fair order onto free slots — interactive first, tenants by
        weight; cancelled queued requests finish without a slot. With no free slot an
        interactive head preempts a batch row (_try_preempt), so its wait is one
        dispatch, not a batch request's whole generation."""
        now = time.perf_counter()
        with self._plock:
            # under the lock recover_wedged bumps the epoch with: an abandoned thread
            # admits nothing queued after the bump
            self._check_epoch()
            # every queued request, not just the head: under sustained occupancy the
            # head may never admit, and the requests behind it must still time out
            expired = [(req, "queue_ttl" if req.queue_ttl_t and now >= req.queue_ttl_t
                        else "deadline") for req in self._queue
                       if (req.queue_ttl_t and now >= req.queue_ttl_t)
                       or (req.deadline_t and now >= req.deadline_t)]
            for req, by in expired:
                self._queue.remove(req)
                req.finish = "deadline"
                if not req.out:  # a preempted request keeps its delivered output
                    req.error = DeadlineExceeded(f"request expired in queue ({by})")
                _DEADLINE_EXPIRED.labels(where="queue").inc()
                _REQUESTS.labels(finish="deadline").inc()
                flight.finish(req.rid, "deadline", expired_by=by)
                req.done.set()
            while True:
                req = self._queue.peek_next()
                if req is None:
                    break
                # heads leave through pop_next(), never remove(): pop advances the
                # class's virtual time to the served tag, which anchors a tenant
                # returning from idle at "now" instead of zero (else it would be
                # charged its whole past service against the others, and starve)
                if req.cancelled:
                    self._queue.pop_next()
                    req.finish = "cancelled"
                    _REQUESTS.labels(finish="cancelled").inc()
                    flight.finish(req.rid, "cancelled")
                    req.done.set()
                    continue
                try:
                    assigned = self._assign(req)
                except Exception as e:
                    # an admission failure belongs to the request being admitted
                    self._queue.pop_next()
                    _ENGINE_ERRORS.labels(kind="request").inc()
                    req.error = e
                    req.finish = "error"
                    _REQUESTS.labels(finish="error").inc()
                    req.done.set()
                    continue
                if assigned is None:
                    # no free slot: an interactive head may preempt a batch row (the
                    # scheduler is between dispatches: a super-step boundary)
                    if req.klass == "interactive" and self._try_preempt():
                        continue  # a slot is free now
                    break
                self._queue.pop_next()
            _QUEUE_DEPTH.set(len(self._queue))

    def _try_preempt(self) -> bool:  # holds: self._plock
        """Free one slot for a waiting interactive request by preempting the batch row
        with the least delivered output (the cheapest resume). Interactive rows are
        never preempted. Returns True when a slot was freed."""
        victims = [s for s in self._slots
                   if s.req is not None and s.req.klass == "batch"
                   and not s.req.done.is_set() and not s.req.cancelled]
        if not victims:
            return False
        self._preempt_slot(min(victims, key=lambda s: len(s.req.out)))
        return True

    def _preempt_slot(self, slot: _Slot) -> None:  # holds: self._plock
        """Release a batch row at a super-step boundary and re-queue its request. The
        release mirrors _finish without completing the request: the lease is released
        and the committed history joins the prefix cache — by reference when paged, as
        a host copy of the rows when dense, taken here on the scheduler thread before
        the slot is handed on (the caches are written in place: a deferred copy could
        read the next request's rows). The later re-admission (prompt plus delivered
        tokens, _assign) is then mostly a cache hit. A chained super-step in flight over
        this row is discarded at its delivery (slot.req changed), like a cancel; the
        sampler already sits at the delivered coins."""
        req = slot.req
        req.preemptions += 1
        self.preempted += 1
        _PREEMPTED.inc()
        flight.event(req.rid, "preempted", slot=slot.index, delivered=len(req.out))
        if slot.picked is not None:
            # the device sampler drew this pick's coin, but its token was never
            # delivered: the coin goes back, for the re-admission's first pick to draw
            req.sampler.state = _xorshift_back(req.sampler.state)
        slot.req = None
        slot.pending = []
        slot.next_token = None
        slot.last_logits = None
        slot.picked = None
        slot.armed = False
        slot.tok_counter = None
        self.proposer.detach(slot.index)
        if self.adaptive is not None:
            self.adaptive.detach(slot.index)
        # the grammar state is not kept: the re-admission replays prompt and delivered
        # tokens through the automaton (_attach_constraint)
        self._release_constraint(slot)
        if self.prefix_cache is not None and slot.lease is not None:
            self.prefix_cache.release(slot.lease)
            slot.lease = None
        if slot.clamp_pos is not None:
            # an in-flight super-step parks this row clamped: its tail is not committed
            self._truncate_history(slot, slot.clamp_pos)
            slot.clamp_pos = None
        if self.prefix_cache is not None:
            self._harvest_into_cache(slot)
        # a nominal cost: the first admission charged the whole request to the tenant's
        # virtual time, and charging the rest again would bill every preemption twice
        self._queue.push(req, req.tenant, req.klass, 1.0)

    def _reap_slots(self) -> None:
        """Free slots whose request was cancelled or whose deadline passed (finish
        "deadline": the partial output is kept; DeadlineExceeded only when nothing was
        generated)."""
        now = time.perf_counter()
        for sl in self._slots:
            req = sl.req
            if req is None:
                continue
            if req.cancelled:
                self._finish(sl, "cancelled")
            elif req.deadline_t and now >= req.deadline_t:
                if not req.out:
                    req.error = DeadlineExceeded(
                        "generation deadline expired before the first token")
                _DEADLINE_EXPIRED.labels(where="decode").inc()
                self._finish(sl, "deadline")

    def _fail_request(self, slot: _Slot, e: Exception) -> None:
        """Blast radius 'request': fail only this slot's request; the other co-batched
        slots keep decoding."""
        _ENGINE_ERRORS.labels(kind="request").inc()
        slot.req.error = e
        self._finish(slot, "error")

    def _fail_all(self, e: Exception) -> None:
        """Blast radius 'engine': the shared dispatch failed unattributably — fail every
        in-flight request. The scheduler thread survives; a chained super-step issued
        against the failed schedule is dropped (the next dispatch uploads host state)."""
        _ENGINE_ERRORS.labels(kind="engine").inc()
        if self._inflight is not None:
            self._note_flush("error")
            self._inflight = None
            _PIPELINE_DEPTH.set(0)
        for s in self._slots:
            if s.req is not None:
                s.req.error = e
                self._finish(s, "error")

    def _loop(self, epoch: int) -> None:
        self._tls.epoch = epoch  # the epoch this thread was born into
        _SCHED_ALIVE.set(1)
        try:
            while not self._shutdown and self._epoch == epoch:
                try:
                    self._loop_once()
                except _StaleEpoch:
                    return  # abandoned by recover_wedged: unwind without a trace
                except Exception as e:
                    # no exception may kill the scheduler thread
                    if self._epoch != epoch:
                        return  # the state is the new epoch's, not ours to fail
                    try:
                        self._fail_all(e)
                    except Exception:
                        pass
                    with self._cond:
                        if not self._shutdown:
                            self._cond.wait(timeout=0.05)
        finally:
            # close() with a chained super-step issued; an abandoned thread's exit
            # leaves the new epoch's pipeline and liveness gauge alone
            if self._epoch == epoch:
                if self._inflight is not None:
                    self._note_flush("close")
                    self._inflight = None
                _PIPELINE_DEPTH.set(0)
                _SCHED_ALIVE.set(0)

    def _loop_once(self) -> None:
        failed = False
        with self._slock:  # the waits below run outside it
            self._admit()
            self._reap_slots()
            prefill = [s for s in self._slots if s.req and s.pending]
            active = [s for s in self._slots if s.req and not s.pending]
            _SLOTS_OCCUPIED.set(sum(1 for s in self._slots if s.req is not None))
            try:
                if self._inflight is not None:
                    # a chained super-step runs on the card: deliver it (and maybe chain
                    # its successor) before any other dispatch
                    fl, self._inflight = self._inflight, None
                    self._pipeline_advance(fl)
                elif prefill:
                    # an interactive row's prefill first (then the lowest slot index):
                    # slot order could keep an interactive admission waiting behind
                    # batch rows' long prompts
                    victim = min(prefill, key=lambda s: (s.req.klass != "interactive",
                                                         s.index))
                    try:
                        # mixed step: active decode rows ride the prefill dispatch at T=1
                        self._prefill_step(victim, riders=active)
                    except Exception as e:
                        # a request-scope fault during a prefill dispatch fails only the
                        # prefilling request; the riders' armed tokens re-dispatch next
                        # pass
                        if classify(e) == "request" and victim.req is not None:
                            self._fail_request(victim, e)
                        else:
                            raise
                elif active:
                    self._decode_step(active)
            except Exception as e:  # unattributable: fail all, survive, back off
                self._fail_all(e)
                failed = True
        if failed or not (prefill or active or self._inflight is not None):
            with self._cond:
                with self._plock:
                    idle = not self._queue
                if (failed or idle) and not self._shutdown:
                    self._cond.wait(timeout=0.05 if failed else 0.1)

    def _emit(self, slot: _Slot, token: int) -> bool:
        """Deliver one sampled token (output list, stats, on_token stream) and run the
        host-side finish checks. Returns False when the request finished. slot.pos must
        already count the ingestion of this token's input."""
        req = slot.req
        # under the request's trace context: a fault injected here (or a broken
        # callback) lands on this request's flight timeline
        with reqctx.use(req.ctx):
            # a request-scope fault point inside the callers' try blocks that guard a
            # broken sampler or callback: an injected error fails exactly this request
            self._fire("batch.emit", slot=slot.index, n_out=len(req.out))
            req.out.append(token)
            # the proposer's corpus follows every delivered token, in order
            self.proposer.push(slot.index, token)
            sc = self._live_constraint(slot)
            if sc is not None:
                # the host mirror of the device constraint carry, exact per delivered
                # token; a token the grammar disallows can only come off a degraded or
                # unmasked path: the row goes on unconstrained rather than mask from a
                # wrong state
                nxt = sc.automaton.advance(sc.state, token)
                if nxt < 0:
                    self._degrade_constraint(slot, "divergence")
                else:
                    sc.state = nxt
            if req.stats.generated_tokens == 0:
                req.first_token_t = time.perf_counter()
            req.stats.generated_tokens += 1
            _DECODE_TOKENS.inc()
            if slot.tok_counter is not None:  # the tenant's delivery share
                slot.tok_counter.inc()
            if req.on_token is not None:
                req.on_token(token)
            if req.stop_check is not None and req.stop_check(token):
                self._finish(slot, "stop")
                return False
            if len(req.out) >= req.max_tokens or slot.pos >= self.spec.seq_len:
                self._finish(slot, "length")
                return False
            return True

    def _advance_row(self, slot: _Slot) -> bool:
        """Ensure slot.last_token holds the row's next un-ingested token: a fresh host
        sample from last_logits, with delivery and finish checks. Returns False when the
        request finished instead."""
        req = slot.req
        if req.cancelled:
            self._finish(slot, "cancelled")
            return False
        if slot.armed:  # last_token already holds the next un-ingested token
            return True
        if slot.next_token is not None:  # sampled on the device, already delivered
            slot.last_token = slot.next_token
            slot.next_token = None
            slot.armed = True
            return True
        if slot.last_logits is None:  # context end hit during prefill
            self._finish(slot, "length")
            return False
        if req.max_tokens <= 0:  # parity with Engine.generate: zero-token request
            self._finish(slot, "length")
            return False
        logits = slot.last_logits
        if slot.picked is None and self._mask_row(slot) is not None:
            # a constrained row's host sample: the same f32 MASK_NEG as the masked device
            # steps, so host and device masked picks agree (a device pick was masked on
            # the card already); a masking fault (in _mask_row) degrades the row
            from .device_loop import MASK_NEG

            sc = slot.constraint
            allowed = sc.automaton.mask_bool(sc.state)
            arr = np.array(logits, dtype=np.float32).reshape(-1)
            n = min(arr.shape[0], allowed.shape[0])
            arr[:n][~allowed[:n]] = np.float32(MASK_NEG)
            arr[n:] = np.float32(MASK_NEG)  # vocab padding: never legal
            logits = arr
        try:
            token = (slot.picked if slot.picked is not None
                     else req.sampler.sample(logits))
            alive = self._emit(slot, token)
        except Exception as e:
            # a broken callback (e.g. client gone mid-stream) fails only this request
            _ENGINE_ERRORS.labels(kind="request").inc()
            req.error = e
            self._finish(slot, "error")
            return False
        if not alive:
            return False
        slot.last_token = token
        slot.last_logits = None
        slot.picked = None
        slot.armed = True
        return True

    def _prefill_step(self, slot: _Slot, riders: list[_Slot] = ()) -> None:
        # a request-scope fault point before the riders advance and before the dispatch:
        # an injected error is attributable to the prefilling request alone
        with reqctx.use(slot.req.ctx):
            self._fire("batch.prefill", slot=slot.index, pending=len(slot.pending))
        t0 = time.perf_counter()
        s = self.spec.seq_len
        room = s - slot.pos
        if room <= 0:
            slot.last_logits = None
            slot.pending = []
            return
        riders = [r for r in riders if self._advance_row(r)]
        chunk = next((c for c in PREFILL_CHUNKS if len(slot.pending) >= c), 1)
        chunk = min(chunk, room)
        # a parked row writes [pos, pos+chunk), which must fit under seq_len: shrink the
        # chunk when any other live row sits too close to the end
        for other in self._slots:
            if other is not slot and other.req is not None:
                chunk = min(chunk, max(s - other.pos, 1))
        piece = slot.pending[:chunk]
        t = len(piece)
        starts = self._park_positions(t)
        if slot.req is None:  # reaped by a clamped park's copy-on-write exhaustion
            return
        riders = [r for r in riders if r.req is not None]
        starts[slot.index] = slot.pos
        rows = [[0] * t for _ in self._slots]
        rows[slot.index] = piece
        for r in riders:
            # real token at index 0, scratch beyond (masked future slots of the rider)
            starts[r.index] = r.pos
            rows[r.index] = [r.last_token] + [0] * (t - 1)
        if self.kv_pool is not None:
            # block coverage for every committed write of this dispatch; a rider's
            # exhaustion fails the rider, the prefilling row's propagates to its request
            self._paged_ensure(slot, slot.pos + t)
            for r in riders[:]:
                try:
                    self._paged_ensure(r, r.pos + 1)
                except Exception as e:
                    if classify(e) != "request":
                        raise
                    self._fail_request(r, e)
                    riders.remove(r)
        done = t == len(slot.pending)
        reads = ([(slot.index, t - 1)] if done else []) + [(r.index, 0) for r in riders]
        samplers = ([slot.req.sampler] if done else []) + [r.req.sampler for r in riders]
        # the dispatch belongs to the prefilling request: its span (and any dispatch
        # fault) carries that request's trace id
        with reqctx.use(slot.req.ctx), \
                trace.span("batch.mixed_step" if riders else "batch.prefill",
                           {"chunk": t, "riders": len(riders)}):
            logits, picks = self._step(rows, starts, t, reads,
                                       "mixed" if riders else "prefill", samplers)
        if riders:
            self.mixed_steps += 1
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.dispatch_ms["mixed" if riders else "prefill"].append(dt_ms)
        flight.event(slot.req.rid, "prefill_chunk", chunk=t, riders=len(riders),
                     ms=round(dt_ms, 3))
        (_DISP_MIXED if riders else _DISP_PREFILL).observe(dt_ms / 1000.0)
        _PREFILL_TOKENS.inc(t)
        # rows neither prefilling nor riding spent this dispatch parked
        _PARKED_ROW_STEPS.inc(self.slots_n - 1 - len(riders))
        self.prefilled_tokens += t
        slot.pos += t
        slot.history.extend(piece)
        slot.pending = slot.pending[t:]
        if done:
            slot.last_logits, slot.picked = logits[0], picks[0]
            slot.last_token = slot.history[-1]
        slot.req.stats.prefill_ms += dt_ms
        for i, r in enumerate(riders):  # each rider decoded one token in this dispatch
            r.last_logits, r.picked = logits[i + int(done)], picks[i + int(done)]
            r.history.append(r.last_token)
            r.pos += 1
            r.armed = False  # the dispatch ingested last_token's KV
            r.req.stats.token_ms.append(dt_ms)
            r.req.stats.infer_ms.append(dt_ms)

    def _decode_step(self, active: list[_Slot]) -> None:
        """One batched T=1 step over every active row (host-sampled next tokens)."""
        for slot in active[:]:
            if not self._advance_row(slot):
                active.remove(slot)
        if self.kv_pool is not None:
            # every row's next write needs a real block; a pool that cannot serve even
            # after reclaim fails only that request
            for slot in active[:]:
                try:
                    self._paged_ensure(slot, slot.pos + 1)
                except Exception as e:
                    if classify(e) != "request":
                        raise
                    self._fail_request(slot, e)
                    active.remove(slot)
        if not active:
            return
        if self.spec_k:
            # where a row has a draft worth verifying, this dispatch is a (B, T) verify
            # block instead of a super-step: one weight stream for up to T tokens a row
            plan = self._plan_verify(active)
            if plan is not None:
                self._verify_step(*plan)
                return
        k = self.superstep
        if k > 1:
            with self._plock:
                waiting = bool(self._queue)
            if not waiting:
                # per-row step budget: stop at max_tokens or the context end (the row
                # parks for the rest of the block)
                budgets = {slot.index: min(k, slot.req.max_tokens - len(slot.req.out),
                                           self.spec.seq_len - slot.pos)
                           for slot in active}
                if max(budgets.values()) >= 2:
                    self._super_step(active, k, budgets)
                    return
        # one batched T=1 step: the admission-latency (and tail) path
        t0 = time.perf_counter()
        starts = self._park_positions(1)
        # a clamped park's copy-on-write under pool exhaustion may have reaped a row
        active = [s for s in active if s.req is not None]
        if not active:
            return
        rows = [[0]] * self.slots_n
        for slot in active:
            starts[slot.index] = slot.pos
            rows[slot.index] = [slot.last_token]
        with trace.span("batch.single_step", {"rows": len(active)}):
            logits, picks = self._step(rows, starts, 1,
                                       [(slot.index, 0) for slot in active],
                                       "single_step", [slot.req.sampler for slot in active])
        self.decode_steps += 1
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.dispatch_ms["decode"].append(dt_ms)
        _DISP_SINGLE.observe(dt_ms / 1000.0)
        _PARKED_ROW_STEPS.inc(self.slots_n - len(active))
        for i, slot in enumerate(active):
            slot.last_logits, slot.picked = logits[i], picks[i]
            slot.history.append(slot.last_token)
            slot.pos += 1
            slot.armed = False  # the dispatch ingested last_token's KV
            slot.req.stats.token_ms.append(dt_ms)
            slot.req.stats.infer_ms.append(dt_ms)

    # ------------------------------------------------------------------
    # K-step super-steps, pipelined
    # ------------------------------------------------------------------

    def _batched_loop(self, k: int, mode: str, window: int | None, masked: bool = False):
        """The K-step batched device loop for this engine, one per (k, mode, window
        bucket), each step a CUDA graph on the card. `masked` selects the grammar-
        constrained build, a loop (and graph) of its own, so unconstrained service keeps
        the unmasked graphs."""
        key = (k, mode, window) + (("mask",) if masked else ())
        if key not in self._loops:
            from .device_loop import make_batched_decode_loop

            eng = self._eng
            self._loops[key] = make_batched_decode_loop(
                self.spec, eng.params, k, mode=mode, dtype=eng.dtype,
                use_kernels=eng.use_kernels, attn_window=window,
                fused_prologue=eng.fused_prologue, kv_block_tokens=self._kv_bt,
                paged_kernel=eng.paged_kernel, graphs=eng.graphs, masked=masked,
                mesh=eng._merge, compress_collectives=eng.compress)
        return self._loops[key]

    def _verify_loop(self, t: int, mode: str, window: int | None, masked: bool = False):
        """The (B, T=t) draft-verify step for this engine, one per (t, mode, window
        bucket), a CUDA graph on the card; `masked` selects the grammar-constrained
        build (its own graph), where a draft the grammar forbids is never accepted."""
        key = ("verify", t, mode, window) + (("mask",) if masked else ())
        if key not in self._loops:
            from .device_loop import make_batched_verify_loop

            eng = self._eng
            self._loops[key] = make_batched_verify_loop(
                self.spec, eng.params, t, mode=mode, dtype=eng.dtype,
                use_kernels=eng.use_kernels, attn_window=window,
                fused_prologue=eng.fused_prologue, kv_block_tokens=self._kv_bt,
                paged_kernel=eng.paged_kernel, graphs=eng.graphs, masked=masked,
                mesh=eng._merge, compress_collectives=eng.compress)
        return self._loops[key]

    def _verify_block_for(self, t: int) -> int:
        """Block-length bucket (2, 3, 5, 9, 17, ... capped at 1 + spec_k): one verify
        step per bucket, so per-dispatch lengths make O(log k) graphs, not O(k). Padding
        positions are scratch writes past the frontier, masked like every over-decode."""
        return verify_block_bucket(t, 1 + self.spec_k)

    def _plan_verify(self, active: list[_Slot]):
        """Draft per-row proposals for one verify dispatch. Returns (active, T, drafts),
        or None when the rows drafted fewer than SPEC_MIN_DRAFT tokens (a draftless
        verify emits one token a row for a full-width dispatch: the super-step serves
        that better). A row drafts at most min(k, its max_tokens room - 1, its context
        room - 2) and its adaptive k, so the accepted block never overruns max_tokens or
        the cache, as in the sequential loop; T shrinks to a bucket so every live row's
        T writes stay inside seq_len."""
        s = self.spec.seq_len
        want: dict[int, int] = {}
        for slot in active:
            req = slot.req
            cap = min(self.spec_k, req.max_tokens - len(req.out) - 1, s - slot.pos - 2)
            if self.adaptive is not None:
                cap = min(cap, self.adaptive.k_for(slot.index))
            want[slot.index] = cap
        drafts = self.proposer.propose_batch({i: c for i, c in want.items() if c > 0})
        total = 0
        max_pos = 0
        for slot in active:
            d = drafts.setdefault(slot.index, [])
            del d[max(want[slot.index], 0):]  # never draft past the caps
            total += len(d)
            max_pos = max(max_pos, slot.pos)
        if total < SPEC_MIN_DRAFT:
            return None
        t = self._verify_block_for(1 + max(len(d) for d in drafts.values()))
        room = s - max_pos
        if t > room:
            # near the context end the block rounds DOWN to a bucket (a step per tail
            # length would add a graph for each)
            b = 2
            while b < t and 2 * (b - 1) + 1 <= room:
                b = 2 * (b - 1) + 1
            t = b if b <= room else 0
        if t < 2:
            return None
        for d in drafts.values():
            del d[t - 1:]  # the context-end shrink may cut long drafts
        return active, t, drafts

    def _verify_step(self, active: list[_Slot], t: int,
                     drafts: dict[int, list[int]]) -> None:
        """One draft-verify dispatch: every active row rides a (B, T) block (its pending
        token and its draft, padded), the device verifies all rows in one forward, and
        delivery emits each row's accepted drafts and the correction or bonus token.
        Rejected tails sit past the frontier on masked slots; the device carry is
        rewound to the frontier, so a chained super-step composes with any outcome."""
        self._fire("batch.verify", rows=len(active), block=t)
        if self.kv_pool is not None:
            for slot in active[:]:
                try:
                    self._paged_ensure(slot, slot.pos + t)
                except Exception as e:
                    if classify(e) != "request":
                        raise
                    self._fail_request(slot, e)
                    active.remove(slot)
                    drafts.pop(slot.index, None)
            if not active:
                return
        starts = self._park_positions(t)
        # a clamped park's copy-on-write under pool exhaustion may have reaped a row
        active = [s for s in active if s.req is not None]
        if not active:
            return
        ndraft = [-1] * self.slots_n  # -1 parks the row inside the block
        props = [[0] * t for _ in range(self.slots_n)]
        budget = [0] * self.slots_n  # per-row maximum emit (accepted + correction)
        rows: list[tuple[_Slot, BatchRequest]] = []
        for slot in active:
            i = slot.index
            d = drafts.get(i, [])
            starts[i] = slot.pos
            props[i] = [slot.last_token] + d + [0] * (t - 1 - len(d))
            ndraft[i] = len(d)
            budget[i] = len(d) + 1
            rows.append((slot, slot.req))
        fl = self._issue_verify_step(rows, t, ndraft, props, budget, starts)
        self._pipeline_advance(fl)

    def _issue_verify_step(self, rows: list, t: int, ndraft: list[int],
                           props: list[list[int]], budget: list[int],
                           starts: list[int]) -> _InflightStep:
        """Queue one (B, T) verify block without waiting for it. It always uploads host
        state (its proposals are drafted from delivered tokens, so a verify is never
        chained from a predecessor), but its carry is rewound to the frontier on the
        device, so a super-step may chain from it."""
        eng = self._eng
        n = self.slots_n
        temps, topps = [0.0] * n, [0.9] * n
        rng = np.zeros((n, 2), np.int64)
        for slot, req in rows:
            i = slot.index
            smp = req.sampler
            temps[i] = float(getattr(smp, "temperature", 0.0))
            topps[i] = float(getattr(smp, "topp", 0.9))
            state = int(getattr(smp, "state", 0)) & ((1 << 64) - 1)
            rng[i] = state >> 32, state & 0xFFFFFFFF
        mode = "greedy" if all(x == 0.0 for x in temps) else "sample"
        window = eng._window_for(min(max(starts) + t, self.spec.seq_len))
        masked = self._constrained(rows)
        loop = self._verify_loop(t, mode, window, masked)
        if self._gap_t is not None:
            _DISPATCH_GAP.observe(max(time.perf_counter() - self._gap_t, 0.0))
        t_issue = time.perf_counter()
        tables = self._tables_dev if self.kv_pool is not None else None
        constrain = cstate = cspans = None
        if masked:
            # a verify is never chained from a predecessor, so its constraint states come
            # from the delivered host mirrors, as its sampler states do; a mask fault in
            # _cstate_vec parks that row on the universal state, where the masked step
            # leaves its logits as they are
            cstate = self._cstate_vec()
            cspans = self._constrain_spans()
            constrain = (cstate, *self.constrain_table.device())
            _CONSTRAIN_DISPATCHES.inc()
        self._issue_seq += 1
        seq = self._issue_seq

        def guard():
            self._before_launch()
            self._mirror("verify", seq=seq, t=t, mode=mode, window=window, masked=masked,
                         props=props, starts=starts, rng=rng, temps=temps, topps=topps,
                         ndraft=ndraft, cstate=cstate, cspans=cspans)

        def call():
            out = loop(eng.rope, props, eng.k_cache, eng.v_cache, starts, rng, temps,
                       topps, ndraft, tables, guard=guard, constrain=constrain)
            toks, acc, tok, pos, rng_out = out[:5]
            return copy_to_host(toks, acc), tok, pos, rng_out, out[7] if masked else None
        with trace.span("batch.verify_issue",
                        {"block": t, "rows": len(rows),
                         "drafted": sum(max(n, 0) for n in ndraft)}):
            fetch, tok, pos, rng_out, cst = self._dispatched("verify", call, (t, 1))
        if self.token_log is not None:
            self.token_log.append(("verify", fetch))
        _PIPELINE_DEPTH.set(1)
        self.dispatches += 1
        return _InflightStep(rows, t, starts, budget, temps, fetch, tok, pos, rng_out,
                             t_issue, kind="verify", ndraft=ndraft, cstate=cst, seq=seq)

    def _drafts_ready(self, rows: list) -> bool:
        """Would a verify dispatch have drafts to work with? The accept-aware chain
        policy asks before the in-flight block is delivered, so it sees the corpus
        before that block: advisory only."""
        for slot, _req in rows:
            k = (self.adaptive.k_for(slot.index) if self.adaptive is not None
                 else self.spec_k)
            if k > 0 and self.proposer.ready(slot.index, k, SPEC_MIN_DRAFT):
                return True
        return False

    def _super_step(self, active: list[_Slot], k: int, budgets: dict[int, int]) -> None:
        """One K-step dispatch from host state: every active row decodes up to its
        budget on the device, sampling included, then the (K, B) block is delivered.
        With pipelining the next super-step is issued from this one's device carry
        before delivery starts (_pipeline_advance)."""
        if self.kv_pool is not None:
            for slot in active[:]:
                try:
                    self._paged_ensure(slot, slot.pos + budgets[slot.index])
                except Exception as e:
                    if classify(e) != "request":
                        raise
                    self._fail_request(slot, e)
                    active.remove(slot)
            if not active:
                return
        starts = self._park_positions(1)
        active = [s for s in active if s.req is not None]
        if not active:
            return
        budget = [0] * self.slots_n
        rows: list[tuple[_Slot, BatchRequest]] = []
        for slot in active:
            starts[slot.index] = slot.pos
            budget[slot.index] = budgets[slot.index]
            rows.append((slot, slot.req))
        fl = self._issue_super_step(rows, k, budget, starts)
        self._pipeline_advance(fl)

    def _pipeline_advance(self, fl: _InflightStep) -> None:
        """One pipeline turn: maybe issue the super-step after `fl` from its device
        carry (so the card does not idle through the delivery below), then deliver
        `fl`; the chained dispatch is kept only if every row it decodes delivered its
        full budget and stayed live."""
        nxt = None
        plan = (self._plan_chain(fl)
                if self.pipeline and not self._shutdown and not self._draining else None)
        if plan is not None:
            with self._plock:
                waiting = bool(self._queue)
            if waiting or any(s.req and s.pending for s in self._slots):
                # a request needs the next dispatch for its admission or prefill
                self._note_flush("admission")
                plan = None
        if plan is not None and self.kv_pool is not None:
            # block coverage for the chained dispatch's writes, and private blocks under
            # its clamped parks, before it is issued; a pool that cannot serve declines
            # the chain instead of failing rows
            rows, starts, budget, clamp = plan
            try:
                for slot, _req in rows:
                    self._paged_ensure(slot, starts[slot.index] + budget[slot.index])
                for slot in clamp:
                    self._paged_cow(slot, self.spec.seq_len - 1, self.spec.seq_len)
            except Exception:
                self._note_flush("pool")
                plan = None
        if plan is not None:
            rows, starts, budget, clamp = plan
            for slot in clamp:
                # the chained dispatch parks this row clamped at seq_len - 1
                slot.clamp_pos = self.spec.seq_len - 1
            nxt = self._issue_super_step(rows, self.superstep, budget, starts, chain=fl)
        try:
            # the wait for the block and its delivery (one scheduler thread delivers, so
            # these spans never overlap)
            with trace.span("batch.super_step", {"k": fl.k, "rows": len(fl.rows),
                                                 "tokens": sum(fl.budget),
                                                 "kind": fl.kind, "chained": fl.chained}):
                status = self._deliver_super_step(fl)
        except BaseException:
            if nxt is not None:
                # the chained dispatch is still a local here: _fail_all sees only
                # self._inflight
                self._note_flush("error")
            _PIPELINE_DEPTH.set(0)
            raise
        if nxt is not None:
            reason = self._chain_divergence(nxt, status)
            if reason is not None:
                self._flush_inflight(nxt, reason)
            else:
                self._inflight = nxt
        _PIPELINE_DEPTH.set(1 if self._inflight is not None else 0)

    def _note_flush(self, reason: str) -> None:
        """One pipeline break: a chained super-step discarded, or chaining declined."""
        self.flushes[reason] += 1
        _PIPELINE_FLUSHES.labels(reason=reason).inc()

    def _flush_inflight(self, fl: _InflightStep, reason: str) -> None:
        """Discard a chained super-step whose schedule diverged from what its
        predecessor delivered: its writes lie at or past every row's frontier, and the
        next dispatch uploads host state."""
        self._note_flush(reason)
        self.rollback_tokens += sum(fl.budget)
        _ROLLBACK_TOKENS.inc(sum(fl.budget))
        for slot, req in fl.rows:
            flight.event(req.rid, "pipeline_flush", reason=reason,
                         tokens=fl.budget[slot.index])

    def _plan_chain(self, fl: _InflightStep):
        """The schedule of the super-step after `fl`, assuming `fl` delivers every
        budgeted token: the same rows with budgets re-derived from the expected
        positions and output lengths. Returns (rows, starts, budget, clamp slots), or
        None when no row would decode 2 or more steps (the single-step path takes over),
        a row was cancelled (its reap comes next pass), or the accept-aware policy
        declines: while the accept EMA is at or above SPEC_CHAIN_EXPECT the next
        dispatch should be a host-drafted verify (which cannot chain: its proposals need
        the delivered tokens), not a super-step that dilutes it.

        A verify predecessor is planned against full acceptance, the largest positions
        and output lengths, so the budgets are safe for any actual accept: the chained
        super-step starts from the carry the verify rewound to the true frontier, and a
        row that accepted less decodes with a smaller budget than it could. Only a row
        that finished in the verify flushes the chain, as after a super-step."""
        k, s = self.superstep, self.spec.seq_len
        now = time.perf_counter()
        if fl.kind == "verify":
            if self._spec_ema >= SPEC_CHAIN_EXPECT:
                self._note_flush("spec")
                return None
            gain = [nd + 1 if nd >= 0 else 0 for nd in fl.ndraft]
        elif (self.spec_k and self._spec_ema >= SPEC_CHAIN_EXPECT
              and self._drafts_ready(fl.rows)):
            # chaining would outrun the verify those drafts are ready for
            self._note_flush("spec")
            return None
        else:
            gain = fl.budget
        starts = [st + g for st, g in zip(fl.starts, gain)]
        budget = [0] * self.slots_n
        rows: list[tuple[_Slot, BatchRequest]] = []
        clamp: list[_Slot] = []
        for slot, req in fl.rows:
            i = slot.index
            if req.cancelled or (req.deadline_t and now >= req.deadline_t):
                return None  # the reap comes next pass: do not outrun it
            b = min(k, req.max_tokens - (len(req.out) + gain[i]), s - starts[i])
            if b > 0:
                budget[i] = b
                rows.append((slot, req))
            elif starts[i] >= s:
                clamp.append(slot)
        if not rows or max(budget) < 2:
            return None
        return rows, starts, budget, clamp

    def _issue_super_step(self, rows: list, k: int, budget: list[int], starts: list[int],
                          chain: _InflightStep | None = None) -> _InflightStep:
        """Queue one K-step batched decode without waiting for it. chain=None uploads
        host state (each row's last token and position, each sampler's xorshift*
        state); chain=<predecessor> starts from that dispatch's device carry, with
        `starts`/`budget` the caller's speculative schedule. The block's copy to the
        host starts right after the dispatch."""
        eng = self._eng
        n = self.slots_n
        temps, topps, tokens = [0.0] * n, [0.9] * n, [0] * n
        rng = np.zeros((n, 2), np.int64)
        for slot, req in rows:
            i = slot.index
            smp = req.sampler
            temps[i] = float(getattr(smp, "temperature", 0.0))
            topps[i] = float(getattr(smp, "topp", 0.9))
            if chain is None:
                tokens[i] = slot.last_token
                state = int(getattr(smp, "state", 0)) & ((1 << 64) - 1)
                rng[i] = state >> 32, state & 0xFFFFFFFF
        mode = "greedy" if all(t == 0.0 for t in temps) else "sample"
        window = eng._window_for(min(max(st + max(b, 1) for st, b in zip(starts, budget)),
                                     self.spec.seq_len))
        masked = self._constrained(rows)
        loop = self._batched_loop(k, mode, window, masked)
        if chain is None:
            tok_in, pos_in, rng_in = tokens, starts, rng
            if self._gap_t is not None:
                # the previous dispatch's results landed at _gap_t and the device had
                # nothing queued since
                _DISPATCH_GAP.observe(max(time.perf_counter() - self._gap_t, 0.0))
        else:
            tok_in, pos_in, rng_in = chain.tok, chain.pos, chain.rng
            self.chained += 1
            _DISPATCH_GAP.observe(0.0)  # chained: the device never went idle
        t_issue = time.perf_counter()
        tables = self._tables_dev if self.kv_pool is not None else None
        constrain = cspans = None
        cin = None
        if masked:
            # the constraint carry: a chained dispatch starts from its predecessor's
            # device states (as from its tokens and samplers), an unchained one from the
            # host mirrors. A predecessor over the same rows was masked too: the row set
            # decides, so a chain does not cross from an unmasked build to a masked one
            cin = (chain.cstate if chain is not None and chain.cstate is not None
                   else self._cstate_vec())
            cspans = self._constrain_spans()
            constrain = (cin, *self.constrain_table.device())
            _CONSTRAIN_DISPATCHES.inc()
        self._issue_seq += 1
        seq = self._issue_seq

        def guard():
            self._before_launch()
            # a chained dispatch's carry is each follower's own: only host values travel
            host = chain is None
            self._mirror("super", seq=seq, chain=None if host else chain.seq, k=k,
                         mode=mode, window=window, masked=masked,
                         tokens=tok_in if host else None, starts=pos_in if host else None,
                         rng=rng_in if host else None, temps=temps, topps=topps,
                         budget=budget, cspans=cspans,
                         cstate=cin if masked and not isinstance(cin, torch.Tensor)
                         else None)

        def call():
            out = loop(eng.rope, tok_in, eng.k_cache, eng.v_cache, pos_in, rng_in, temps,
                       topps, budget, tables, guard=guard, constrain=constrain)
            toks, tok, pos, rng_out = out[:4]
            return copy_to_host(toks), tok, pos, rng_out, out[6] if masked else None
        # the issue returns once the graph replays are queued; the wait for the block
        # and its delivery are the batch.super_step span
        with trace.span("batch.super_step_issue",
                        {"k": k, "rows": len(rows), "chained": chain is not None}):
            fetch, tok, pos, rng_out, cst = self._dispatched("super_step", call, (1, k))
        if self.token_log is not None:
            self.token_log.append(("super", fetch))
        _PIPELINE_DEPTH.set(2 if chain is not None else 1)
        self.dispatches += 1
        self.loop_steps += k
        return _InflightStep(rows, k, starts, budget, temps, fetch, tok, pos, rng_out,
                             t_issue, chained=chain is not None, cstate=cst, seq=seq)

    def _deliver_super_step(self, fl: _InflightStep) -> dict[int, str]:
        """Wait for an issued super-step's (K, B) block (or a verify's (T, B) targets
        and accepted lengths), then per row emit its tokens with the stop/EOS/max
        checks. A stochastic row's sampler advances one coin before each token is
        emitted, so the state is final for the delivered tokens before a finish wakes
        the request's waiters (the device drew coins for the whole block; a stop
        mid-block must not advance the caller's sampler past the delivered ones).
        Returns per slot index "alive" (full budget delivered, still decoding) or the
        finish reason: the check of a dispatch chained from this one."""
        k, s = fl.k, self.spec.seq_len
        verify = fl.kind == "verify"
        got = fl.fetch()  # the dispatch's one fence
        # a hung transfer is the other place a wedged thread blocks: woken after a
        # recovery, it must not deliver into slots that now hold other requests
        self._check_epoch()
        self._last_dispatch_t = time.monotonic()
        toks = got[0]
        acc = got[1] if verify else None
        t_ready = time.perf_counter()
        # the dispatch could not start before its issue nor before the previous
        # block was ready
        base = fl.t_issue
        if self._last_ready_t is not None and self._last_ready_t > base:
            base = self._last_ready_t
        dev_ms = max((t_ready - base) * 1000.0, 1e-6)
        self._last_ready_t = t_ready
        self._gap_t = t_ready
        self.decode_steps += 1
        if verify:
            self.verify_steps += 1
            self.dispatch_ms["verify"].append(dev_ms)
            _SPEC_VERIFY_STEPS.inc()
            _DISP_VERIFY.observe(dev_ms / 1000.0)
        else:
            self.super_steps += 1
            self.dispatch_ms["super"].append(dev_ms)
            _DISP_SUPER.observe(dev_ms / 1000.0)
        _SUPERSTEP_TOKENS.observe(sum(fl.budget))
        # rows riding without a live request park for all k steps; rows with a short
        # budget park for the steps past it
        _PARKED_ROW_STEPS.inc(self.slots_n * k - sum(fl.budget))
        status: dict[int, str] = {}
        accs: list[int] = []  # per-row accepted lengths (the verify EMA's input)
        for slot, req in fl.rows:
            i = slot.index
            # a verify emits the accepted drafts and the correction or bonus token
            b = int(acc[i]) + 1 if verify else fl.budget[i]
            if slot.req is not req or req.done.is_set():
                # reaped (cancel, close) between issue and delivery
                self.rollback_tokens += b
                _ROLLBACK_TOKENS.inc(b)
                flight.event(req.rid, "rollback", tokens=b, where="reaped")
                status[i] = "cancelled"
                continue
            if not self._advance_row(slot):
                # a chained dispatch consumes the previous block's tail token here; a
                # cancel seen now finishes the row and discards its block
                self.rollback_tokens += b
                _ROLLBACK_TOKENS.inc(b)
                status[i] = req.finish
                continue
            if not verify and b < k and fl.starts[i] + b >= s:
                # the block parked this row clamped at s - 1 after its budget (a verify
                # never clamps a live row: _plan_verify shrinks T to fit)
                slot.clamp_pos = s - 1
                flight.event(req.rid, "park_clamped", pos=s - 1)
            if verify:
                # per-request accounting before the emit loop: spec_turns keys on the
                # output length before the block
                nd = fl.ndraft[i]
                a = b - 1
                accs.append(a)
                if self.adaptive is not None:
                    self.adaptive.observe(i, nd, a)
                self.proposer.observe(i, a)
                req.stats.spec_steps += 1
                req.stats.spec_drafted += nd
                req.stats.spec_accepted += a
                req.stats.spec_turns.append((len(req.out), nd, a))
                req.stats.spec_step_ms.append(dev_ms)
                self.spec_drafted += nd
                self.spec_accepted += a
                _SPEC_DRAFTED.inc(nd)
                _SPEC_ACCEPTED.inc(a)
                flight.event(req.rid, "verify_step", block=k, drafted=nd, accepted=a)
            block = toks[:b, i].tolist()
            smp = req.sampler
            # the device drew one coin per live stochastic step: replayed one by one
            coins = fl.temps[i] != 0.0 and hasattr(smp, "state")
            per_tok = dev_ms / b
            # the measured decode pace the slo_tpot_interactive admission gate reads
            self._tpot_ema_ms += 0.2 * (per_tok - self._tpot_ema_ms)
            x = slot.last_token  # the input the block's first step ingested
            slot.armed = False
            alive = True
            delivered = 0
            try:
                for tok in block:
                    if req.cancelled:
                        self._finish(slot, "cancelled")
                        alive = False
                        break
                    slot.history.append(x)
                    slot.pos += 1  # pos counts ingestions through this token's input
                    req.stats.token_ms.append(per_tok)
                    req.stats.infer_ms.append(per_tok)
                    delivered += 1
                    if coins:
                        smp.state, _ = _random_u32(smp.state)
                    if not self._emit(slot, tok):
                        alive = False
                        break
                    x = tok
            except Exception as e:
                # a broken callback fails only this request
                _ENGINE_ERRORS.labels(kind="request").inc()
                req.error = e
                self._finish(slot, "error")
                alive = False
            self.rollback_tokens += b - delivered  # the tail past a stop, on masked slots
            if delivered < b:
                _ROLLBACK_TOKENS.inc(b - delivered)
                flight.event(req.rid, "rollback", tokens=b - delivered,
                             where="mid_block")
            if alive:
                # the block's tail is sampled and delivered, its KV not yet written
                slot.next_token = block[-1]
                slot.last_logits = None
            if slot.clamp_pos is not None:
                # the row did not finish in the loop (_finish consumes clamp_pos): the
                # clamp's truncation, with the lease shrink
                self._truncate_history(slot, slot.clamp_pos)
                slot.clamp_pos = None
            # one timeline entry per request the block advanced and, with tracing on, a
            # per-row instant under the request's context, so the shared dispatch is
            # attributable per request
            flight.event(req.rid, "super_step", k=k, budget=b, delivered=delivered,
                         chained=fl.chained)
            if trace.current() is not None:
                with reqctx.use(req.ctx):
                    trace.instant("batch.row_delivered",
                                  {"slot": i, "delivered": delivered, "k": k})
            status[i] = "alive" if alive else req.finish
        if verify:
            if _SPEC_DRAFTED.value > 0:
                _SPEC_ACCEPT_RATE.set(_SPEC_ACCEPTED.value / _SPEC_DRAFTED.value)
            if accs:
                # the accept EMA drives the chain policy: a high expected accept wants
                # back-to-back verifies, a low one chained super-steps
                self._spec_ema = 0.7 * self._spec_ema + 0.3 * (sum(accs) / len(accs))
        elif self.spec_k:
            # a slow regression toward optimism while super-steps run, so a decayed EMA
            # cannot disengage speculation for good: after about a dozen super-steps
            # the policy re-probes with one verify
            self._spec_ema += 0.05 * (self.spec_k - self._spec_ema)
            if self.adaptive is not None:
                # the same slow re-probe per row: a turn passed without these rows
                # drafting
                for slot, _req in fl.rows:
                    self.adaptive.tick(slot.index)
        return status

    @staticmethod
    def _chain_divergence(nxt: _InflightStep, status: dict[int, str]) -> str | None:
        """None when every row the chained dispatch decodes delivered its predecessor's
        full budget and is still live; else the flush reason."""
        for slot, _req in nxt.rows:
            st = status.get(slot.index, "cancelled")
            if st != "alive":
                return {"stop": "stop", "cancelled": "cancel",
                        "error": "error"}.get(st, "finish")
        return None
