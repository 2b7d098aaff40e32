"""Prompt-lookup speculative decoding (greedy single sequence; the batched verify).

The port's copy of the JAX package's runtime/speculative.py with its metric families,
the `spec.verify` span and the proposer mux (ProposerMux: the grammar proposer, the
model drafter and n-gram lookup per row): the per-request counts live on
GenerationStats (spec_steps, spec_drafted, spec_accepted, spec_turns, spec_step_ms),
the batched ones on the BatchEngine (verify_steps, spec_stats()).

A verify step over T = 1 + k tokens streams the weights once for up to k + 1 tokens,
so on a bandwidth-bound card it costs little more than one decode step. Drafts come
from the context itself (n-gram suffix lookup, "prompt lookup decoding"): find the
most recent earlier occurrence of the current tail n-gram and propose the tokens that
followed it.

Exactness: greedy acceptance emits exactly the tokens the sequential host loop would
(each accepted token equals the argmax the step itself produced; the first mismatch is
replaced by the step's own argmax). generate_speculative is greedy-only; the batched
verify (runtime/device_loop.py make_batched_verify_loop) also serves seeded sampling.

Rollback is free: rows committed for rejected positions sit beyond the rewound
position, and every read masks slots at or past it, so the next step overwrites them.
"""

from __future__ import annotations

import time

from ..obs import metrics, trace
from ..resilience.errors import FaultInjected, TransientDispatchError

_DRAFTED = metrics.counter(
    "spec_drafted_tokens_total", "Draft tokens proposed by prompt lookup")
_ACCEPTED = metrics.counter(
    "spec_accepted_tokens_total", "Draft tokens the verify step accepted")
_VERIFY_STEPS = metrics.counter(
    "spec_verify_steps_total", "Speculative verify dispatches")
_ACCEPT_RATE = metrics.gauge(
    "spec_accept_rate", "Cumulative accepted/drafted ratio (process lifetime)")
# the shared decode-token counter (get-or-create returns engine.py's instance)
_ENGINE_DECODE_TOKENS = metrics.counter(
    "engine_decode_tokens_total", "Tokens decoded by the sequential engine")


def propose_ngram(tokens: list[int], k: int, *, max_ngram: int = 4,
                  min_ngram: int = 1) -> list[int]:
    """Draft up to k tokens by matching the longest tail n-gram earlier in
    `tokens` (most recent occurrence wins) and copying its continuation.

    Brute-force reference: O(len * ngram) list-slice comparisons per call —
    at 16k context with no match that approaches the cost of the decode step
    it is meant to amortize. The generation loop uses NgramIndex (same
    answers, O(max_ngram) dict lookups per proposal); this form remains the
    oracle the index is tested against."""
    n = len(tokens)
    if n < min_ngram + 1 or k <= 0:
        return []
    for size in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        tail = tokens[n - size:]
        # most recent earlier occurrence of the tail n-gram; start <= n-size-1
        # guarantees the continuation slice holds at least one token
        for start in range(n - size - 1, -1, -1):
            if tokens[start:start + size] == tail:
                return list(tokens[start + size:start + size + k])
    return []


class NgramIndex:
    """Incremental tail-n-gram -> most-recent-occurrence index over a growing
    token list: propose() is O(max_ngram) dict lookups instead of
    propose_ngram's full-history rescan, with identical answers.

    Registration lags the tail by one append: the brute force only accepts
    occurrences whose continuation holds at least one token (start <=
    n-size-1, i.e. the n-gram ends at most at n-1), so on each append to
    length m we register the grams ENDING at m-1 — exactly the newly-eligible
    occurrences. The dict keeps the largest start per gram, which is the
    brute force's most-recent-wins scan order.

    Memory bound: the dicts gain one entry per UNIQUE n-gram for the life of
    the index, which on a long-lived batched serving slot (one NgramIndex per
    conversation, runtime/batch_engine.py) grows without bound. `max_entries`
    caps the total: when registration crosses it the dicts are rebuilt from a
    bounded tail window (sized so the rebuilt index holds at most
    ~max_entries/2 entries), after which proposals only match occurrences
    inside that window — recency is exactly what prompt-lookup prefers
    anyway, so distant-history matches are the cheapest thing to shed. The
    token list itself stays whole (ints, and propose() stores absolute start
    indices into it)."""

    def __init__(self, tokens: list[int], *, max_ngram: int = 4,
                 min_ngram: int = 1, max_entries: int = 65536):
        self.tokens: list[int] = []
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.sizes = range(min_ngram, max_ngram + 1)
        self.max_entries = max_entries
        self.window = max(max_entries // (2 * len(self.sizes)), 4 * max_ngram)
        self._entries = 0
        self._last: dict[int, dict[tuple, int]] = {s: {} for s in self.sizes}
        self.extend(tokens)

    def _register(self, end: int) -> None:
        """Register the grams ENDING at token index `end` (their continuation
        starts at `end`, so they just became legal occurrences)."""
        for size in self.sizes:
            if end >= size:
                d = self._last[size]
                gram = tuple(self.tokens[end - size:end])
                if gram not in d:
                    self._entries += 1
                d[gram] = end - size

    def append(self, tok: int) -> None:
        self.tokens.append(tok)
        self._register(len(self.tokens) - 1)
        if self._entries > self.max_entries:
            self._rebuild()

    def _rebuild(self) -> None:
        """Re-register only the grams ending inside the tail window; amortized
        O(1) per append (each rebuild is O(window), triggered at most every
        ~max_entries/2 appends)."""
        n = len(self.tokens)
        self._last = {s: {} for s in self.sizes}
        self._entries = 0
        for end in range(max(n - self.window, self.min_ngram), n):
            self._register(end)

    @property
    def entries(self) -> int:
        """Total registered n-gram entries across sizes (memory gauge)."""
        return self._entries

    def extend(self, tokens: list[int]) -> None:
        for t in tokens:
            self.append(t)

    def propose(self, k: int) -> list[int]:
        """propose_ngram(self.tokens, k) via the index."""
        tokens = self.tokens
        n = len(tokens)
        if n < self.min_ngram + 1 or k <= 0:
            return []
        for size in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            start = self._last[size].get(tuple(tokens[n - size:]))
            if start is not None:
                return list(tokens[start + size:start + size + k])
        return []

    def propose_extended(self, k: int) -> list[int]:
        """propose(), re-proposed from the virtually extended sequence until
        k tokens are drafted or the lookup goes dry.

        Most-recent-wins truncates exactly where prompt-lookup shines: on a
        cyclic tail (code/JSON repetition, greedy attractor loops) the most
        recent occurrence of the tail n-gram overlaps the tail itself, so
        its continuation is clipped to 1-2 tokens by the end of the list.
        Treating the draft as accepted and looking up again (the tail n-gram
        of tokens+draft, continuations still read from the real token list)
        unrolls the cycle to the full k — the draft a verify block can
        actually amortize. Each round adds >= 1 token, so at most k
        lookups."""
        out = self.propose(k)
        while 0 < len(out) < k:
            merged = self.tokens[-self.max_ngram:] + out
            more: list[int] = []
            for size in range(min(self.max_ngram, len(merged)),
                              self.min_ngram - 1, -1):
                start = self._last[size].get(tuple(merged[-size:]))
                if start is not None:
                    more = list(self.tokens[start + size:
                                            start + size + k - len(out)])
                    break
            if not more:
                break
            out += more
        return out[:k]


# ----------------------------------------------------------------------
# Proposer protocol (docs/SERVING.md "Model-based drafting")
# ----------------------------------------------------------------------
# A proposer supplies per-row draft tokens to the BatchEngine's verify path:
# NgramProposer (prompt lookup, below), constrain.GrammarProposer (forced chains of
# a row's grammar) and draft.ModelDrafter (a second, small model), routed per row by
# ProposerMux (below). All methods run on the scheduler thread; `row` is the engine
# slot index.
#
#   name: str                      # "ngram" | "grammar" | "model" | "mux"
#   attach(row, tokens)            # bind a row; tokens = prompt ⊕ delivered
#   detach(row)                    # release the row (finish/preempt/wedge)
#   push(row, tok)                 # one delivered token (corpus/frontier sync)
#   propose(row, k) -> list[int]   # up to k draft tokens for the row
#   observe(row, accepted)         # verify outcome for the row's last drafts
#
# propose_batch(want: {row: k}) -> {row: drafts} is the batched form the
# engine actually calls (a model drafter serves every row in ONE scan
# dispatch); the default below routes it through per-row propose().


def verify_block_bucket(t: int, cap: int) -> int:
    """Block-length bucket (2, 3, 5, 9, 17, ... capped at `cap`): verify and
    draft-scan programs compile per length, so raw per-dispatch lengths would
    compile O(k) programs; buckets bound it to O(log k). Padding positions
    are scratch writes beyond the frontier — the same masked-slot discipline
    every over-decode already relies on."""
    b = 2
    while b < t:
        b = 2 * (b - 1) + 1
    return min(b, cap)


def draft_buckets(k_cap: int) -> list[int]:
    """Per-row draft-count buckets derived from the verify T buckets
    (T = 1 + k: k ∈ 1, 2, 4, 8, ...), capped at k_cap — the adaptive-k
    controller only ever requests these lengths, so per-row adaptation can
    never mint a verify (or drafter-scan) program the fixed-k path would
    not also compile."""
    out = []
    b = 1
    while b < k_cap:
        out.append(b)
        b *= 2
    out.append(k_cap)
    return out


class NgramProposer:
    """Per-row NgramIndex behind the Proposer protocol — the prompt-
    lookup drafter re-expressed as one implementation among several."""

    name = "ngram"

    def __init__(self, *, max_ngram: int = 4, max_entries: int = 65536):
        self.max_ngram = max_ngram
        self.max_entries = max_entries
        self._idx: dict[int, NgramIndex] = {}

    def attach(self, row: int, tokens: list[int]) -> None:
        self._idx[row] = NgramIndex(list(tokens), max_ngram=self.max_ngram,
                                    max_entries=self.max_entries)

    def detach(self, row: int) -> None:
        self._idx.pop(row, None)

    def push(self, row: int, tok: int) -> None:
        idx = self._idx.get(row)
        if idx is not None:
            idx.append(tok)

    def propose(self, row: int, k: int) -> list[int]:
        idx = self._idx.get(row)
        if idx is None or k <= 0:
            return []
        return idx.propose_extended(k)

    def propose_batch(self, want: dict[int, int]) -> dict[int, list[int]]:
        return {row: d for row, k in want.items()
                if (d := self.propose(row, k))}

    def observe(self, row: int, accepted: int) -> None:
        pass  # the corpus already advanced via push()

    def ready(self, row: int, k: int, min_draft: int) -> bool:
        """Cheap advisory probe: would propose() return >= min_draft?"""
        return len(self.propose(row, k)) >= min_draft


class AdaptiveK:
    """Per-row adaptive draft length (docs/SERVING.md "Model-based
    drafting"): each row's k follows its own accept EMA so chat, code, json
    and open-ended rows co-batched in one engine each find their own
    operating point. k values are drawn from draft_buckets() (the verify
    T buckets minus 1) so adaptation cannot cause recompile creep.

    Policy per verify turn (observe): full accept counts as accepted+1 —
    the row would likely have accepted more, so the EMA can climb past the
    current bucket and k grows; a partial accept pulls the EMA toward the
    measured accept length and k shrinks to the smallest bucket covering
    it. Below `engage` the row DISENGAGES (k_for -> 0: no drafts, no wasted
    verify width); while disengaged — and on any turn the row passes
    without drafting (tick) — the EMA regresses slowly UP toward
    `reprobe_to` (just past the engage floor, never dragging an
    already-confident row down): the engine-wide slow-reprobe policy per row, so
    after ~a dozen idle turns the row re-probes with the SMALLEST bucket
    (one cheap draft) and only ramps back up if the probe accepts —
    a hopeless row (e.g. a high-temperature stochastic stream sampling far
    from the drafter's argmax) costs one 1-token draft per horizon instead
    of riding every verify at full width."""

    def __init__(self, k_cap: int, *, alpha: float = 0.3,
                 engage: float = 0.35, reprobe: float = 0.05):
        self.k_cap = max(int(k_cap), 1)
        self.buckets = draft_buckets(self.k_cap)
        self.alpha = alpha
        self.engage = engage
        self.reprobe = reprobe
        self.reprobe_to = 2.0 * engage  # re-probe lands on the k=1 bucket
        import threading

        # stats() is read from API threads while the scheduler adapts
        self._lock = threading.Lock()  # guards: _ema
        self._ema: dict[int, float] = {}

    def attach(self, row: int) -> None:
        with self._lock:
            # optimistic start (the engine EMA's convention): speculation
            # engages at full width and adapts down on hopeless rows
            self._ema[row] = float(self.k_cap) + 1.0

    def detach(self, row: int) -> None:
        with self._lock:
            self._ema.pop(row, None)

    def _k_from_ema(self, ema: float) -> int:
        """The one place the engage threshold + bucket choice live (k_for
        and stats() must report the same policy)."""
        if ema < self.engage:
            return 0
        for b in self.buckets:
            if b >= ema:
                return b
        return self.k_cap

    def k_for(self, row: int) -> int:
        with self._lock:
            ema = self._ema.get(row)
        if ema is None:
            return self.k_cap  # unattached rows get the fixed-k behavior
        return self._k_from_ema(ema)

    def observe(self, row: int, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return self.tick(row)
        val = accepted + 1.0 if accepted >= drafted else float(accepted)
        with self._lock:
            if row in self._ema:
                self._ema[row] += self.alpha * (val - self._ema[row])

    def tick(self, row: int) -> None:
        """A turn passed without this row drafting (scan, or rode a verify
        draftless): regress slowly up toward the re-probe point so
        disengagement is never forever — and never drag a confident row's
        EMA down (a row paused only because its proposer went dry must not
        forget its accept history)."""
        with self._lock:
            ema = self._ema.get(row)
            if ema is not None and ema < self.reprobe_to:
                self._ema[row] = ema + self.reprobe * (self.reprobe_to - ema)

    def stats(self) -> dict[int, dict]:
        with self._lock:
            snap = dict(self._ema)
        return {row: {"ema": round(ema, 3), "k": self._k_from_ema(ema)}
                for row, ema in snap.items()}


class DrafterError(ValueError):
    """A failure of the model drafter's own: its file does not load, its vocabulary is
    not the target's, its bookkeeping is inconsistent. With an injected fault, the only
    failure ProposerMux and the BatchEngine's drafter load degrade on."""


def drafter_failure(e: BaseException) -> bool:
    """True for the failures the drafter may degrade on: a DrafterError, or a fault
    injected at one of its points. Everything else (a kernel build error, a kernel
    wrapper refusing its inputs, a CUDA launch error, a device fault) propagates as on
    every other path."""
    return isinstance(e, (DrafterError, FaultInjected, TransientDispatchError))


class ProposerMux:
    """Per-row routing between a model drafter and the n-gram fallback
    (docs/SERVING.md "Model-based drafting"). The drafter serves every row
    it can (attached, within its own context window, healthy) in one scan
    dispatch; remaining rows fall back to prompt lookup. A raising drafter
    degrades: the failing dispatch's rows fall back to n-gram proposals
    (the request never sees the failure), and `max_failures` CONSECUTIVE
    propose failures disable the drafter for the engine's lifetime —
    n-gram-only from then on, exactly the pre-drafter behavior.

    `grammar` (constrain.GrammarProposer) is consulted FIRST for rows it
    serves: a grammar-constrained row whose automaton sits on a
    forced-transition chain drafts that chain — the target's only legal
    continuation, guaranteed accept, zero drafting compute — while
    co-batched unconstrained rows in the SAME want dict fall through to
    the model/ngram routing unchanged.

    Scheduler-thread-only except stats()/describe() (reads of counters and
    the drafter's own locked stats — torn reads only skew a stats scrape)."""

    name = "mux"

    def __init__(self, ngram: NgramProposer, drafter=None, *,
                 grammar=None, max_failures: int = 8):
        self.ngram = ngram
        self.drafter = drafter
        self.grammar = grammar
        self.max_failures = max_failures
        self.failures = 0  # consecutive; reset on success
        self.errors = 0  # lifetime (stats)
        self.disabled = False
        # which proposer drafted each row's LAST proposal (per-proposer
        # accept attribution; scheduler-thread-only)
        self.last_src: dict[int, str] = {}

    def _model_ok(self) -> bool:
        return self.drafter is not None and not self.disabled

    def attach(self, row: int, tokens: list[int]) -> None:
        self.ngram.attach(row, tokens)
        if self.drafter is not None:
            self.drafter.attach(row, tokens)

    def detach(self, row: int) -> None:
        self.ngram.detach(row)
        if self.drafter is not None:
            self.drafter.detach(row)
        if self.grammar is not None:
            self.grammar.detach(row)
        self.last_src.pop(row, None)

    def push(self, row: int, tok: int) -> None:
        self.ngram.push(row, tok)
        if self.drafter is not None:
            self.drafter.push(row, tok)

    def propose(self, row: int, k: int) -> list[int]:
        return self.propose_batch({row: k}).get(row, [])

    def propose_batch(self, want: dict[int, int]) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        # grammar first: forced-chain drafts are certain accepts, so they
        # always beat a learned draft for the rows they cover; remaining
        # (unconstrained / off-chain) rows keep the model/ngram routing
        if self.grammar is not None:
            for row, d in self.grammar.propose_batch(want).items():
                out[row] = d
                self.last_src[row] = "grammar"
                _PROPOSED.labels(proposer="grammar").inc(len(d))
            want = {row: k for row, k in want.items() if row not in out}
            if not want:
                return out
        mout: dict[int, list[int]] = {}
        if self._model_ok():
            try:
                mout = self.drafter.propose_batch(want)
                self.failures = 0
            except Exception as e:
                if not drafter_failure(e):
                    raise  # the card's and the kernels' faults are not the drafter's
                # a failing drafter costs only its drafts — every row falls
                # back to prompt lookup below, the request never notices
                self.failures += 1
                self.errors += 1
                _DRAFT_ERRORS.inc()
                if self.failures >= self.max_failures and not self.disabled:
                    self.disabled = True
                    _DRAFT_DISABLED.set(1)
                    import sys

                    print(f"🔴 model drafter disabled after "
                          f"{self.failures} consecutive failures: {e!r} — "
                          "degrading to n-gram drafting", file=sys.stderr)
                mout = {}
        for row, d in mout.items():
            out[row] = d
            self.last_src[row] = "model"
            _PROPOSED.labels(proposer="model").inc(len(d))
        for row, k in want.items():
            if row in out:
                continue
            d = self.ngram.propose(row, k)
            if d:
                out[row] = d
                self.last_src[row] = "ngram"
                _PROPOSED.labels(proposer="ngram").inc(len(d))
        return out

    def observe(self, row: int, accepted: int) -> None:
        src = self.last_src.get(row)
        if src is not None and accepted > 0:
            _PROP_ACCEPTED.labels(proposer=src).inc(accepted)
        if self.drafter is not None:
            self.drafter.observe(row, accepted)

    def ready(self, row: int, k: int, min_draft: int) -> bool:
        if k <= 0:
            return False
        if self.grammar is not None and self.grammar.ready(row, k,
                                                           min_draft):
            return True  # a forced chain long enough is a certain accept
        if self._model_ok() and self.drafter.can_serve(row, k):
            return True  # a model drafts k tokens whenever it can run
        return self.ngram.ready(row, k, min_draft)

    def describe(self) -> dict:
        d = self.drafter
        out = {"model": d is not None, "disabled": self.disabled,
               "errors": self.errors}
        if d is not None:
            out["drafter"] = d.stats()
        if self.grammar is not None:
            out["grammar"] = self.grammar.stats()
        return out


_PROPOSED = metrics.counter(
    "batch_spec_proposer_drafted_total",
    "Draft tokens fed to batched verify dispatches, by proposer",
    labelnames=("proposer",))
_PROP_ACCEPTED = metrics.counter(
    "batch_spec_proposer_accepted_total",
    "Accepted draft tokens, by the proposer that drafted them",
    labelnames=("proposer",))
_DRAFT_ERRORS = metrics.counter(
    "batch_draft_errors_total",
    "Model-drafter propose failures degraded to n-gram drafting")
_DRAFT_DISABLED = metrics.gauge(
    "batch_draft_disabled",
    "1 while the model drafter is disabled after consecutive failures")


def generate_speculative(engine, prompt_tokens: list[int], max_tokens: int,
                         sampler, *, k: int = 8, on_token=None,
                         stop_check=None,
                         history_tokens: list[int] | None = None):
    """Greedy generation with prompt-lookup drafts; returns (tokens, stats)
    exactly equal to engine.generate()'s output for temperature 0.

    Each iteration runs ONE step over [last_token] + draft (T <= 1+k),
    accepts the matching prefix, emits the step's own argmax as the
    correction, and rewinds the cache to the verified frontier via
    engine.seek(). Extra stats fields: spec_steps (verify dispatches),
    spec_drafted, spec_accepted (draft tokens that matched)."""
    from .engine import GenerationStats

    assert getattr(sampler, "temperature", 0.0) == 0.0, (
        "speculative decoding is greedy-only; use the sequential loop for "
        "temperature > 0")
    stats = GenerationStats()
    # spec_steps/spec_drafted/spec_accepted/spec_step_ms start at their
    # GenerationStats dataclass defaults

    # the proposer's corpus: the FULL conversation when the caller prefix-
    # reused most of it (api_server passes history_tokens=whole prompt while
    # prompt_tokens is just the delta) — prompt-lookup draws its drafts from
    # exactly that repetitive history
    assert history_tokens is None or (
        history_tokens[-len(prompt_tokens):] == list(prompt_tokens)), (
        "history_tokens must end with prompt_tokens")
    history = NgramIndex(list(history_tokens) if history_tokens
                         else list(prompt_tokens))
    if len(prompt_tokens) > 1:
        # prefill everything but the last prompt token; each verify block
        # starts with the pending token, so its logits re-derive in-block
        engine.prefill(prompt_tokens[:-1], stats)
    stats.prompt_tokens = len(prompt_tokens)
    out: list[int] = []
    last = prompt_tokens[-1]
    done = False
    while not done and len(out) < max_tokens:
        t0 = time.perf_counter()
        room = engine.spec.seq_len - engine.pos - 1
        if room <= 0:
            break
        # draft cap room-1, not room: emitting full[i] is sequential-legal only
        # while the ingest position after it stays BELOW seq_len (the
        # sequential loop breaks at pos >= seq_len before sampling again), so
        # the block may fill at most up to position seq_len-1
        draft = history.propose_extended(
            min(k, room - 1, max_tokens - len(out) - 1))
        block = [last] + draft
        pos_before = engine.pos
        with trace.span("spec.verify", {"draft": len(draft), "pos": pos_before}):
            full = engine.infer_chunk_logits(block)  # (T, vocab)
        stats.spec_steps += 1
        stats.spec_drafted += len(draft)
        accepted = 0
        emitted: list[int] = []
        for i in range(len(block)):
            target = sampler.sample(full[i])  # argmax w/ sampler's tie-breaks
            emitted.append(target)
            if i < len(draft) and target == draft[i]:
                accepted += 1
            else:
                break
        # under sp each rank verified on logits of its own ring order: rank 0's turn
        # holds (the accepted drafts, then one correction)
        emitted = engine._agree(emitted, len(block))
        accepted = len(emitted) - 1
        stats.spec_accepted += accepted
        stats.spec_turns.append((len(out), len(draft), accepted))
        _VERIFY_STEPS.inc()
        _DRAFTED.inc(len(draft))
        _ACCEPTED.inc(accepted)
        if _DRAFTED.value > 0:
            _ACCEPT_RATE.set(_ACCEPTED.value / _DRAFTED.value)
        # real per-dispatch verify time; token_ms/infer_ms get the per-token
        # AVERAGE of it (see GenerationStats: percentiles are synthetic when
        # spec_steps > 0, aggregate tokens/s stays correct)
        dt_full = (time.perf_counter() - t0) * 1000.0
        stats.spec_step_ms.append(dt_full)
        dt_ms = dt_full / len(emitted)
        # the turn's tokens up to max_tokens, through the callbacks until a stop (under
        # tp, rank 0's stop on every rank: engine._deliver)
        emit = emitted[:max_tokens - len(out)]
        _, stop_j = engine._deliver(emit, on_token, stop_check)
        for tok in emit if stop_j is None else emit[:stop_j + 1]:
            out.append(tok)
            history.append(tok)
            stats.generated_tokens += 1
            _ENGINE_DECODE_TOKENS.inc()
            stats.token_ms.append(dt_ms)
            stats.infer_ms.append(dt_ms)
        done = stop_j is not None
        # rewind to the verified frontier: rows beyond it were computed from
        # rejected inputs (masked reads make the stale rows invisible). On a
        # stop at emitted index j the frontier excludes the stop token's
        # ingestion — the sequential loop breaks before inferring it.
        frontier = pos_before + 1 + (stop_j if stop_j is not None else accepted)
        engine.seek(frontier)
        last = out[-1]
        if engine.pos >= engine.spec.seq_len:
            break
    return out, stats
