"""ModelDrafter: a small draft model beside the target on the same card (the port's
counterpart of the JAX package's draft/drafter.py).

Prompt lookup (n-gram drafting) goes dry off repetitive traffic. The drafter is a second,
much smaller model — loaded through the same `.m` loader as the target (Q40, Q80, F32),
its weights repacked for the kernels by prepare_for_cuda as the target's are — that
drafts k tokens per row for every served row in one scan dispatch (draft/loop.py). Its
matmuls are small and bandwidth-bound, and it keeps its own dense KV caches on the card.

Frontier bookkeeping (host side, scheduler thread only): per row the drafter tracks
`toks` (the row's full delivered stream: prompt ⊕ output, re-attached whole on a
preemption's re-admission and a durable resume, so those paths need nothing special),
`frontier` (tokens whose KV the drafter has ingested and CONFIRMED) and `spec_tail` (its
own drafted tokens whose KV it wrote speculatively during the last scan). When the
target delivers a token (push) that matches the head of spec_tail — exactly the accepted
drafts, by the verify identity — the frontier advances for free: the KV written while
drafting IS that token's KV. The first mismatch (the correction token) drops the rest of
the tail; its KV sits past the frontier on masked slots and the next catch-up overwrites
it. A proposal turn then force-ingests the few pending tokens (usually just the
correction or bonus token) and free-runs k greedy argmax steps, all in one bucketed scan
for every served row.

Failure semantics: load and propose failures of the drafter's own (a
speculative.DrafterError: a file that does not load, a vocab mismatch, inconsistent
bookkeeping; or an injected fault at `draft.load` / `draft.propose` / `draft.dispatch`)
degrade — the caller (runtime/speculative.py ProposerMux, BatchEngine's load) falls back
to n-gram drafting; every other exception (a kernel build error, a kernel wrapper
refusing its inputs, a CUDA launch error, a device fault) propagates as on every other
path (speculative.drafter_failure).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.forward import init_kv_cache
from ..models.params import params_to, prepare_for_cuda
from ..models.spec import ModelSpec
from ..obs import metrics, trace
from ..ops.rope import RopeTables
from ..quants import FloatType
from ..resilience import faults
from ..runtime.engine import Engine, window_bucket
from ..runtime.speculative import DrafterError
from ..runtime.step_graph import StepGraphs
from .loop import make_draft_loop, make_draft_step

_DISPATCHES = metrics.counter(
    "batch_draft_dispatches_total",
    "Drafter scan dispatches (one per served proposal turn)")
_DRAFTED = metrics.counter(
    "batch_draft_drafted_tokens_total",
    "Tokens drafted by the model drafter")
_CATCHUP = metrics.counter(
    "batch_draft_catchup_tokens_total",
    "Target-delivered tokens the drafter re-ingested in-scan to sync")
_PREFILL = metrics.counter(
    "batch_draft_prefill_tokens_total",
    "Tokens chunk-prefilled into the drafter KV (attach / long catch-up)")
_SPEC_HITS = metrics.counter(
    "batch_draft_frontier_hits_total",
    "Delivered tokens whose drafter KV was already written while drafting "
    "(frontier advanced with zero re-ingest work)")
_DISPATCH_SECONDS = metrics.histogram(
    "batch_draft_dispatch_seconds",
    "Wall time of one drafter scan dispatch")

# drafter prefill chunk: one shape covers attach-time catch-up; the sub-chunk tail is
# not prefilled token by token, it rides the proposal scan's catch-up phase (which runs
# anyway and carries up to catchup_cap tokens)
PREFILL_CHUNK = 16


class _Row:
    __slots__ = ("toks", "frontier", "spec_tail")

    def __init__(self, tokens: list[int]):
        self.toks = list(tokens)  # full stream: prompt ⊕ delivered output
        self.frontier = 0  # toks[:frontier] have confirmed drafter KV
        self.spec_tail: list[int] = []  # drafted tokens with speculative KV


class ModelDrafter:
    """Proposer-protocol drafter (runtime/speculative.py) backed by a small model on the
    target's card. Scheduler-thread-only except stats(), which reads plain counters (a
    torn read only skews a stats scrape).

    `use_kernels` is the target engine's kernel policy (the drafter's weights take the
    same kernels where they are quantized); `cuda_graph` captures each scan step on the
    card with the kernels on."""

    name = "model"

    def __init__(self, spec: ModelSpec, params, *, slots: int, target_spec: ModelSpec,
                 tokenizer=None, device="cpu", dtype=torch.float32,
                 use_kernels: bool | str = False, k_cap: int = 8,
                 cuda_graph: bool = True):
        faults.fire("draft.load")
        # drafts are token ids fed straight into the target's verify block: the two
        # models (and the serving tokenizer) must share one vocabulary
        if spec.vocab_size != target_spec.vocab_size:
            raise DrafterError(
                f"draft model vocab {spec.vocab_size} != target vocab "
                f"{target_spec.vocab_size} (the models must share a tokenizer)")
        if tokenizer is not None and tokenizer.vocab_size != spec.vocab_size:
            raise DrafterError(
                f"draft model vocab {spec.vocab_size} != tokenizer vocab "
                f"{tokenizer.vocab_size}")
        self.spec = spec
        self.slots = slots
        self.device = torch.device(device)
        self.dtype = dtype
        self.k_cap = max(int(k_cap), 1)
        # in-scan catch-up bound: past this the row chunk-prefills first. 2k+1 covers
        # the steady states (a full-accept turn: 2 pending; a K-step super-step burst
        # between verifies: K+1 pending)
        self.catchup_cap = 2 * self.k_cap + 1
        has_quant = any(getattr(t, "ftype", None) in (FloatType.Q40, FloatType.Q80)
                        for t in params["blocks"].values())
        self.use_kernels = use_kernels if has_quant else False
        params = params_to(params, self.device)
        if self.use_kernels:
            # weights already in a kernel layout (a self-draft on the target's own
            # prepared params) are kept as they are: no copy
            params = prepare_for_cuda(params, keep_gate_pair=self.use_kernels == "fused")
        self.params = params
        self.rope = RopeTables.create(spec, self.device)
        self.k_cache, self.v_cache = init_kv_cache(spec, slots, dtype=dtype,
                                                   device=self.device)
        self.graphs = StepGraphs(self.device, bool(cuda_graph) and bool(self.use_kernels)
                                 and self.device.type == "cuda")
        self._rows: dict[int, _Row] = {}
        self._loops: dict[tuple, object] = {}  # (scan length, window) -> scan
        self._step = None  # chunked prefill forward
        self.dispatches = 0
        self.prefill_tokens = 0

    @classmethod
    def load(cls, path: str, **kw) -> "ModelDrafter":
        """Load a drafter from a `.m` model file with the target's loader
        (formats/mfile.py: Q40/Q80/F32, header schema)."""
        from ..formats.mfile import load_model

        try:
            spec, params = load_model(str(path))
        except (OSError, ValueError) as e:  # the file is the drafter's own
            raise DrafterError(f"draft model {path} does not load: {e}") from e
        return cls(spec, params, **kw)

    # -- Proposer protocol ------------------------------------------------

    def attach(self, row: int, tokens: list[int]) -> None:
        self._rows[row] = _Row(tokens)

    def detach(self, row: int) -> None:
        self._rows.pop(row, None)

    def push(self, row: int, tok: int) -> None:
        st = self._rows.get(row)
        if st is None:
            return
        st.toks.append(tok)
        if st.spec_tail and st.spec_tail[0] == tok:
            # the target accepted this draft: the KV the drafter wrote while drafting IS
            # this token's KV — the frontier advances free
            st.spec_tail.pop(0)
            st.frontier += 1
            _SPEC_HITS.inc()
        elif st.spec_tail:
            # correction or divergence: the rest of the tail's KV sits past the frontier
            # on masked slots (overwritten by the next scan)
            st.spec_tail.clear()

    def observe(self, row: int, accepted: int) -> None:
        pass  # frontier sync rides push(); accept EMAs live in AdaptiveK

    def can_serve(self, row: int, k: int) -> bool:
        """Room check: drafting k tokens needs the catch-up + k-1 fed-back drafts to fit
        the drafter's OWN context (which may be shorter than the target's — such rows
        fall back to n-gram drafting), and the stream to sit within one scan of the
        frontier cap."""
        st = self._rows.get(row)
        if st is None or k <= 0:
            return False
        pending = len(st.toks) - st.frontier
        return (pending >= 1 and len(st.toks) + k <= self.spec.seq_len
                and len(st.toks) <= self._frontier_cap() + self.catchup_cap)

    def stats(self) -> dict:
        return {"model": (f"dim{self.spec.dim}_L{self.spec.n_layers}"
                          f"_voc{self.spec.vocab_size}_s{self.spec.seq_len}"),
                "rows": len(self._rows), "k_cap": self.k_cap,
                "dispatches": self.dispatches,
                "prefill_tokens": self.prefill_tokens}

    # -- steps ------------------------------------------------------------

    def _window_for(self, pos_end: int) -> int | None:
        """The Engine's window bucket over the drafter's own context."""
        return window_bucket(pos_end, self.spec.seq_len, Engine._WINDOW_MIN)

    def _loop(self, steps: int, window: int | None = None):
        key = (steps, window)
        if key not in self._loops:
            self._loops[key] = make_draft_loop(
                self.spec, self.params, steps, dtype=self.dtype,
                use_kernels=self.use_kernels, window=window, graphs=self.graphs)
        return self._loops[key]

    def _prefill_step(self):
        if self._step is None:
            self._step = make_draft_step(self.spec, self.params, dtype=self.dtype,
                                         use_kernels=self.use_kernels)
        return self._step

    def reset_backend(self) -> None:
        """Wedge-recovery hook (BatchEngine.recover_wedged): drop the scans and their
        captured graphs, zero the KV caches in place (their storage stays; nothing here
        waits for the device) and force every row back to a clean re-prefill."""
        self.graphs.reset()
        self._loops.clear()
        self._step = None
        self.k_cache.zero_()
        self.v_cache.zero_()
        self._rows.clear()

    # -- drafting ---------------------------------------------------------

    def _scan_bucket(self, need: int) -> int:
        from ..runtime.speculative import verify_block_bucket

        return verify_block_bucket(max(need, 2), self.catchup_cap + self.k_cap - 1)

    def _frontier_cap(self) -> int:
        """Global frontier ceiling G: every confirmed frontier is kept at or below G by
        the retreat pass at the top of propose_batch, sized so no later dispatch's park
        clamp (scan width <= the bucket cap, prefill chunk <= PREFILL_CHUNK) can ever
        need to move a frontier again — a mid-turn retreat would invalidate another
        row's already-captured catch-up state. Rows whose stream outgrows G +
        catchup_cap become unservable and fall back to n-gram drafting."""
        steps_cap = self.catchup_cap + self.k_cap - 1
        return max(self.spec.seq_len - max(steps_cap, PREFILL_CHUNK), 0)

    def _prefill_row(self, row: int, st: _Row) -> None:
        """Chunk-ingest pending tokens until the remainder fits one proposal scan (<=
        catchup_cap) — never token by token: the scan's catch-up phase carries the
        remainder for free, and a short final chunk runs padded through the same (B,
        16) forward (the pad's KV lands past the advanced frontier on masked slots).
        Other rows ride parked at their own frontiers — all <= the cap by the
        propose_batch retreat pass, so no write touches committed rows and no frontier
        moves here."""
        step = self._prefill_step()
        target = min(max(len(st.toks) - self.catchup_cap, st.frontier),
                     self._frontier_cap())
        t0 = time.perf_counter()
        n0 = st.frontier
        with trace.span("draft.prefill", {"row": row, "tokens": target - n0}):
            while st.frontier < target:
                real = min(PREFILL_CHUNK, target - st.frontier)
                toks = np.zeros((self.slots, PREFILL_CHUNK), np.int64)
                starts = np.zeros((self.slots,), np.int64)
                for i, other in self._rows.items():
                    starts[i] = other.frontier
                toks[row, :real] = st.toks[st.frontier:st.frontier + real]
                starts[row] = st.frontier
                step(self.rope, toks, self.k_cache, self.v_cache, starts,
                     self._window_for(int(starts.max()) + PREFILL_CHUNK))
                st.frontier += real
                st.spec_tail.clear()
        n = st.frontier - n0
        self.prefill_tokens += n
        _PREFILL.inc(n)
        _DISPATCH_SECONDS.observe(time.perf_counter() - t0)

    def propose_batch(self, want: dict[int, int]) -> dict[int, list[int]]:
        """Draft up to want[row] tokens for every servable row in ONE scan dispatch.
        Rows the drafter cannot serve (no pending token, context exhausted) are absent
        from the result — the mux falls back to n-gram for them."""
        faults.fire("draft.propose", rows=len(want))
        s = self.spec.seq_len
        # retreat pass first: pin every frontier at or below the global cap before any
        # row's catch-up state is captured, so neither the prefill parks nor the scan
        # parks below can move a frontier mid-turn
        cap = self._frontier_cap()
        for other in self._rows.values():
            if other.frontier > cap:
                other.frontier = cap
                other.spec_tail.clear()
        serve: dict[int, tuple[_Row, int, int]] = {}  # row -> (st, ncatch, k)
        for row, k in want.items():
            st = self._rows.get(row)
            k = min(k, self.k_cap)
            if st is None or k <= 0:
                continue
            ncatch = len(st.toks) - st.frontier
            if ncatch <= 0:
                continue  # nothing pending (a retried plan): skip
            # context room: ncatch + k - 1 ingestions from `frontier` must stay inside
            # the drafter's seq_len
            k = min(k, s - st.frontier - ncatch)
            if k <= 0:
                continue
            if ncatch > self.catchup_cap:
                self._prefill_row(row, st)
                ncatch = len(st.toks) - st.frontier
                if ncatch <= 0 or ncatch > self.catchup_cap:
                    # a stream past cap + catchup_cap cannot be carried by one scan: the
                    # row falls back to n-gram drafting
                    continue
            st.spec_tail.clear()  # the scan overwrites the old tail's slots
            serve[row] = (st, ncatch, k)
        if not serve:
            return {}
        steps = self._scan_bucket(max(nc + k - 1 for _st, nc, k in serve.values()))
        catchup = np.zeros((self.slots, steps), np.int64)
        starts = np.zeros((self.slots,), np.int64)
        ncatch = np.zeros((self.slots,), np.int64)
        budget = np.zeros((self.slots,), np.int64)
        for i, other in self._rows.items():
            # parked rows ride with scratch writes at their own frontiers — all at or
            # below the cap, so every write is masked and in bounds
            starts[i] = other.frontier
        for row, (st, nc, k) in serve.items():
            span = st.toks[st.frontier:st.frontier + min(nc, steps)]
            catchup[row, :len(span)] = span
            starts[row] = st.frontier
            ncatch[row] = nc
            budget[row] = nc + k - 1
        t0 = time.perf_counter()
        with trace.span("draft.propose", {"rows": len(serve), "steps": steps,
                                          "catchup": int(ncatch.sum())}):
            loop = self._loop(steps, self._window_for(int(starts.max()) + steps))
            toks, _pos = loop(self.rope, catchup, self.k_cache, self.v_cache, starts,
                              ncatch, budget)
            # the drafter's one fence: the host slices the proposals from the block
            toks = toks.cpu().numpy()
        self.dispatches += 1
        _DISPATCHES.inc()
        _DISPATCH_SECONDS.observe(time.perf_counter() - t0)
        out: dict[int, list[int]] = {}
        for row, (st, nc, k) in serve.items():
            drafts = toks[nc - 1:nc - 1 + k, row].tolist()
            st.frontier += nc
            # all but the last draft were fed back: their KV is written speculatively at
            # the positions the tokens would occupy
            st.spec_tail = drafts[:-1]
            out[row] = drafts
            _CATCHUP.inc(nc)
            _DRAFTED.inc(len(drafts))
        return out
