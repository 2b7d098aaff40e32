"""Continuous-batching engine: concurrent sequences share one batched step.

The counterpart of the JAX package's runtime/batch_engine.py in its single-step
configuration (superstep=1, no pipelining, no prefix cache, no speculation): the same
scheduling decisions and the same host sampling, so a request served here gets the
tokens the JAX engine gives it in that configuration.

- B cache "slots", each holding one sequence's KV (a block table into the device pool,
  or a row of dense caches) and host-side state. One scheduler thread owns the device.
- Prefill never stalls decode: a prefill chunk (64, 8 or 1 tokens) dispatches TOGETHER
  with the active decode rows in one mixed (B, chunk) step — the prefill row carries its
  chunk, each decode row its next token at index 0 (its other positions are scratch
  writes on masked future slots), and each decode row's logits are read at index 0.
- With no prefill pending, every active row advances one token in a single batched T=1
  step. Sampling runs on the host with each request's Sampler.
- Idle rows ride along with their start parked at their current position: their writes
  land at future positions that are masked now and overwritten when those positions
  really decode.
- A new request lands on the free slot sharing the longest token prefix with its
  history and rewinds instead of re-prefilling (the reference's NaiveCache,
  dllama-api.cpp:187-232, per slot).
- Paged KV (default): KV lives in a (L, N, hk, bt, hs) device block pool and each slot
  holds a block table (cache/device_pool.py); blocks are allocated as a slot grows and
  reclaimed from idle slots under pressure. A pool that cannot serve fails only the
  request whose growth needed the blocks.

What the JAX engine has that this one refuses with NotImplementedError: the K-step
device loop (superstep > 1), speculation and the drafter, the radix prefix cache,
tenants and SLO shedding. `pipeline` is accepted: the JAX engine turns it off at
superstep < 2.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..models.spec import ModelSpec
from .engine import PREFILL_CHUNKS, Engine, GenerationStats
from .errors import EngineClosed, classify

__all__ = ["BatchEngine", "BatchRequest"]


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


class _Slot:
    def __init__(self, index: int):
        self.index = index
        self.pos = 0  # next cache position for this row
        self.history: list[int] = []  # tokens whose KV is written (same-slot rewind)
        self.req: BatchRequest | None = None
        self.pending: list[int] = []  # prompt tokens not yet prefilled
        self.last_token = 0  # feeds the next decode step
        self.last_logits: np.ndarray | None = None
        # pool block ids backing positions [0, len(blocks)·bt); retained across requests
        # like `history` — the same-slot rewind's backing store
        self.blocks: list[int] = []
        # last_token is sampled and delivered but its KV not yet written: a dispatch
        # that fails after _advance_row must not re-advance the row on retry
        self.armed = False


class BatchEngine:
    """Engine-compatible construction (same spec/params arguments), `slots` sequences.

    submit() for async operation, generate() for the Engine-compatible blocking call.
    The scheduler thread starts lazily on first submit and stops with close()."""

    def __init__(self, spec: ModelSpec, params, tokenizer=None, *, slots: int = 2,
                 superstep: int = 1, pipeline: bool = True, prefix_cache=False,
                 speculative: int = 0, draft_model=None, tenants=None,
                 slo_ttft_interactive: float = 0.0, slo_ttft_batch: float = 0.0,
                 slo_tpot_interactive: float = 0.0, paged_kv: bool = True,
                 kv_block_tokens: int = 16, kv_pool_blocks: int = 0, **engine_kw):
        refused = {"superstep > 1 (the K-step device loop)": superstep > 1,
                   "speculative > 0": speculative > 0,
                   "draft_model": draft_model is not None,
                   "prefix_cache": bool(prefix_cache),
                   "tenants": tenants is not None,
                   "SLO targets": bool(slo_ttft_interactive or slo_ttft_batch
                                       or slo_tpot_interactive)}
        for what, asked in refused.items():
            if asked:
                raise NotImplementedError(f"{what} is not part of the port yet")
        assert slots >= 1
        self.slots_n = slots
        self.spec = spec
        self.tokenizer = tokenizer
        kv_pool_cfg = None
        if paged_kv:
            bt = max(int(kv_block_tokens), 1)
            while bt > 1 and spec.seq_len % bt:
                bt //= 2  # block tokens divide seq_len
            w = spec.seq_len // bt
            n_blocks = int(kv_pool_blocks) or (slots * w + slots + 1)
            # floor: one full context + the scratch block + one spare
            kv_pool_cfg = (max(n_blocks, w + 2), bt)
        self._eng = Engine(spec, params, tokenizer, batch=slots, kv_pool=kv_pool_cfg,
                           **engine_kw)
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
            self._tables_dev: torch.Tensor | None = None  # re-uploaded after edits
        self._slots = [_Slot(i) for i in range(slots)]
        self._queue: collections.deque[BatchRequest] = collections.deque()
        self._plock = threading.Lock()  # guards: _queue
        # held by the scheduler for each pass and by release_idle
        self._slock = threading.Lock()  # guards: _slots, kv_pool, _tables_np
        self.decode_steps = 0  # batched T=1 dispatches
        self.mixed_steps = 0  # prefill dispatches carrying decode rows
        self.dispatches = 0  # every device dispatch
        # wall ms of each dispatch by kind: "decode", "prefill", "mixed"; as in the JAX
        # engine, a decode step's time starts after the host sampling of its rows
        self.dispatch_ms: dict[str, list[float]] = {"decode": [], "prefill": [],
                                                    "mixed": []}
        # scheduler wakeup: submit() and close() notify
        self._cond = threading.Condition()
        self._shutdown = False
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # guards: _thread

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
               stop_check=None) -> BatchRequest:
        """Enqueue a request; raises EngineClosed after close()."""
        if self._shutdown:
            raise EngineClosed("BatchEngine is closed")
        req = BatchRequest(list(prompt), max_tokens, sampler, on_token, stop_check)
        if not req.prompt:
            req.prompt = [self.tokenizer.bos_id if self.tokenizer else 1]
        req.submit_t = time.perf_counter()
        with self._plock:
            self._queue.append(req)
        self._ensure_thread()
        with self._cond:
            self._cond.notify()
        return req

    def generate(self, prompt: list[int], max_tokens: int, sampler, on_token=None,
                 stop_check=None) -> tuple[list[int], GenerationStats]:
        """Blocking Engine.generate-compatible call (rides the batched scheduler)."""
        req = self.submit(prompt, max_tokens, sampler, on_token, stop_check)
        out = req.wait()
        return out, req.stats

    def scheduler_alive(self) -> bool:
        """True while the scheduler can serve (running, or not yet started)."""
        t = self._thread
        return t is None or t.is_alive()

    def release_idle(self) -> int:
        """Drop the rewind stock (block tables and histories) of every idle slot, so
        the pool holds only the blocks of live requests. Safe from any thread: it runs
        between two scheduler passes. Returns the pool's free blocks."""
        if self.kv_pool is None:
            return 0
        with self._slock:
            for sl in self._slots:
                if sl.req is None and sl.blocks:
                    self._paged_release_slot(sl)
            return self.kv_pool.free_blocks()

    def close(self) -> None:
        """Stop the engine: waiters of in-flight and queued requests get EngineClosed."""
        self._shutdown = True
        with self._cond:
            self._cond.notify_all()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=30)
        err = EngineClosed("BatchEngine closed")
        with self._plock:
            for s in self._slots:
                req = s.req
                if req is not None and not req.done.is_set():
                    req.error = err
                    s.req = None
                    s.pending = []
                    req.done.set()
            while self._queue:
                req = self._queue.popleft()
                req.error = err
                req.done.set()

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="batch-engine")
                self._thread.start()

    def _assign(self, req: BatchRequest) -> _Slot | None:
        """Place a request on the free slot with the longest common token prefix and
        rewind it there (the multi-slot generalization of the reference NaiveCache)."""
        free = [s for s in self._slots if s.req is None]
        if not free:
            return None
        full = req.prompt

        def common(s: _Slot) -> int:
            n = 0
            for a, b in zip(s.history, full):
                if a != b:
                    break
                n += 1
            return min(n, len(full) - 1)
        best = max(free, key=common)
        reuse = common(best)
        if self.kv_pool is not None:
            self._paged_adopt_rewind_only(best, reuse)
        best.req = req
        best.pos = reuse
        best.history = list(full[:reuse])
        best.pending = full[reuse:]
        best.last_logits = None
        best.armed = False
        req.stats.prompt_tokens = len(full)
        return best

    # ------------------------------------------------------------------
    # device-resident paged KV
    # ------------------------------------------------------------------

    def _tables(self) -> torch.Tensor:
        """Current (B, W) device block table; re-uploaded only after a table edit (a
        few hundred bytes of metadata, never KV rows)."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables_np.copy()).to(
                self._eng.device)
        return self._tables_dev

    def _table_row(self, slot: _Slot) -> None:
        """Rewrite one slot's table row from slot.blocks (filler entries point at the
        scratch block, whose contents are never read)."""
        row = self._tables_np[slot.index]
        row[:] = 0
        row[:len(slot.blocks)] = slot.blocks
        self._tables_dev = None

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
        """Free device blocks by dropping idle slots' retained rewind tables, until
        `need` are free."""
        if self.kv_pool.free_blocks() >= need:
            return
        for sl in self._slots:
            if sl.req is None and sl.blocks and sl is not exclude:
                self._paged_release_slot(sl)
                if self.kv_pool.free_blocks() >= need:
                    return

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
        self._tables_dev = None

    def _paged_adopt_rewind_only(self, slot: _Slot, rewind: int) -> None:
        """Admission: keep only the rewound prefix's blocks. Without a prefix cache no
        block is shared, so the boundary block is the slot's own and needs no
        copy-on-write."""
        keep = min(-(-rewind // self._kv_bt), len(slot.blocks))
        if keep < len(slot.blocks):
            self.kv_pool.decref(slot.blocks[keep:])
            del slot.blocks[keep:]
            self._table_row(slot)

    def _step(self, tokens_rows: list[list[int]], starts: list[int], t: int,
              reads: list[tuple[int, int]]) -> np.ndarray:
        """Run one batched (B, t) step; returns the logits of the (row, position) pairs
        in `reads`, (len(reads), vocab)."""
        tables = self._tables() if self.kv_pool is not None else None
        out = self._eng.step_rows(tokens_rows, starts, tables, reads)
        self.dispatches += 1
        return out

    def _finish(self, slot: _Slot, finish: str) -> None:
        req = slot.req
        req.finish = finish
        slot.req = None
        slot.pending = []
        req.done.set()

    def _park_positions(self, t: int) -> list[int]:
        """Per-row start positions for rows not participating in this step: park at
        the row's current pos so garbage lands on masked future positions, clamped so
        the write stays inside the cache. A clamped park (a row within t of the end)
        overwrites that row's tail history, so its reusable prefix is truncated; an idle
        paged slot is released instead."""
        s = self.spec.seq_len
        starts = []
        for sl in self._slots:
            p = min(sl.pos, max(s - t, 0))
            if p < sl.pos:
                if self.kv_pool is not None and sl.req is None:
                    self._paged_release_slot(sl)
                    p = 0
                elif p < len(sl.history):
                    sl.history = sl.history[:p]
            starts.append(p)
        return starts

    def _admit(self) -> None:
        """Assign queued requests in arrival order onto free slots; cancelled queued
        requests finish without a slot."""
        with self._plock:
            while self._queue:
                req = self._queue[0]
                if req.cancelled:
                    self._queue.popleft()
                    req.finish = "cancelled"
                    req.done.set()
                    continue
                try:
                    assigned = self._assign(req)
                except Exception as e:
                    # an admission failure belongs to the request being admitted
                    self._queue.popleft()
                    req.error = e
                    req.finish = "error"
                    req.done.set()
                    continue
                if assigned is None:
                    break
                self._queue.popleft()

    def _reap_slots(self) -> None:
        """Free slots whose request was cancelled."""
        for sl in self._slots:
            if sl.req is not None and sl.req.cancelled:
                self._finish(sl, "cancelled")

    def _fail_request(self, slot: _Slot, e: Exception) -> None:
        """Blast radius 'request': fail only this slot's request; the other co-batched
        slots keep decoding."""
        slot.req.error = e
        self._finish(slot, "error")

    def _fail_all(self, e: Exception) -> None:
        """Blast radius 'engine': the shared dispatch failed unattributably — fail every
        in-flight request. The scheduler thread survives."""
        for s in self._slots:
            if s.req is not None:
                s.req.error = e
                self._finish(s, "error")

    def _loop(self) -> None:
        while not self._shutdown:
            try:
                self._loop_once()
            except Exception as e:
                # no exception may kill the scheduler thread
                try:
                    self._fail_all(e)
                except Exception:
                    pass
                with self._cond:
                    if not self._shutdown:
                        self._cond.wait(timeout=0.05)

    def _loop_once(self) -> None:
        failed = False
        with self._slock:  # the waits below run outside it
            self._admit()
            self._reap_slots()
            prefill = [s for s in self._slots if s.req and s.pending]
            active = [s for s in self._slots if s.req and not s.pending]
            try:
                if prefill:
                    victim = prefill[0]  # lowest slot index first
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
        if failed or not (prefill or active):
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
        req.out.append(token)
        if req.stats.generated_tokens == 0:
            req.first_token_t = time.perf_counter()
        req.stats.generated_tokens += 1
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
        if slot.last_logits is None:  # context end hit during prefill
            self._finish(slot, "length")
            return False
        if req.max_tokens <= 0:  # parity with Engine.generate: zero-token request
            self._finish(slot, "length")
            return False
        try:
            token = req.sampler.sample(slot.last_logits)
            alive = self._emit(slot, token)
        except Exception as e:
            # a broken callback (e.g. client gone mid-stream) fails only this request
            req.error = e
            self._finish(slot, "error")
            return False
        if not alive:
            return False
        slot.last_token = token
        slot.last_logits = None
        slot.armed = True
        return True

    def _prefill_step(self, slot: _Slot, riders: list[_Slot] = ()) -> None:
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
        logits = self._step(rows, starts, t, reads)
        if riders:
            self.mixed_steps += 1
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.dispatch_ms["mixed" if riders else "prefill"].append(dt_ms)
        slot.pos += t
        slot.history.extend(piece)
        slot.pending = slot.pending[t:]
        if done:
            slot.last_logits = logits[0]
            slot.last_token = slot.history[-1]
        slot.req.stats.prefill_ms += dt_ms
        for i, r in enumerate(riders):  # each rider decoded one token in this dispatch
            r.last_logits = logits[i + int(done)]
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
        t0 = time.perf_counter()
        starts = self._park_positions(1)
        rows = [[0]] * self.slots_n
        for slot in active:
            starts[slot.index] = slot.pos
            rows[slot.index] = [slot.last_token]
        logits = self._step(rows, starts, 1, [(slot.index, 0) for slot in active])
        self.decode_steps += 1
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.dispatch_ms["decode"].append(dt_ms)
        for i, slot in enumerate(active):
            slot.last_logits = logits[i]
            slot.history.append(slot.last_token)
            slot.pos += 1
            slot.armed = False  # the dispatch ingested last_token's KV
            slot.req.stats.token_ms.append(dt_ms)
            slot.req.stats.infer_ms.append(dt_ms)
