"""Regex -> byte DFA -> token-level mask automaton (the port's copy of the JAX
package's constrain/automaton.py: numpy only, the same arrays for the same grammar).

The supported regex subset (literals, classes, escapes, alternation,
grouping, `* + ? {m,n}` quantifiers, `.`) is compiled byte-level: a
Thompson NFA over the UTF-8 byte alphabet, subset-constructed into a DFA,
dead states pruned (a state that cannot reach acceptance disallows every
byte into it), then lowered against the tokenizer vocab by walking every
token's bytes through the DFA in lockstep. The result is a TokenAutomaton:

  mask   (S, ceil(V/32)) uint32  bit v&31 of word v>>5 = token v allowed
  delta  (S, V) int32            next state, -1 = disallowed
  forced (S,) int32              the single allowed token, -1 if not forced

State indices are LOCAL (0 = grammar start). EOS is allowed exactly at
accepting states and transitions to an absorbing `done` state (index S-1)
whose only allowed token is EOS again — a constrained row that completes
its grammar can only pad with EOS until the scheduler retires it. Every
reachable state has a non-empty mask by construction (pruning removed the
rest), so a masked argmax/sample always has a candidate.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class CompileError(ValueError):
    """Grammar rejected at compile time (malformed, unsupported, or too
    large) — the api edge maps this to 400 invalid_request_error."""


# maximum DFA states before lowering: bounds compile time and the device
# table row budget a single grammar can claim
MAX_DFA_STATES = 4096

_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = _DIGITS | frozenset(range(0x41, 0x5B)) | frozenset(
    range(0x61, 0x7B)) | frozenset((0x5F,))
_SPACE = frozenset(b" \t\n\r\f\v")
_ALL = frozenset(range(256))
_DOT = _ALL - frozenset((0x0A,))


class _Nfa:
    def __init__(self) -> None:
        self.edges: list[list[tuple[frozenset[int], int]]] = []
        self.eps: list[set[int]] = []

    def state(self) -> int:
        self.edges.append([])
        self.eps.append(set())
        return len(self.edges) - 1


class _RegexParser:
    """Recursive-descent Thompson construction; fragments are (start, end)
    state pairs in the shared NFA builder."""

    def __init__(self, pat: str, nfa: _Nfa):
        self.pat = pat
        self.nfa = nfa
        self.i = 0

    def _peek(self) -> str:
        return self.pat[self.i] if self.i < len(self.pat) else ""

    def _take(self) -> str:
        c = self._peek()
        if not c:
            raise CompileError("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self) -> tuple[int, int]:
        frag = self._alt()
        if self.i != len(self.pat):
            raise CompileError(
                f"unexpected {self.pat[self.i]!r} at {self.i}")
        return frag

    def _alt(self) -> tuple[int, int]:
        frags = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.state(), self.nfa.state()
        for fs, fe in frags:
            self.nfa.eps[s].add(fs)
            self.nfa.eps[fe].add(e)
        return s, e

    def _concat(self) -> tuple[int, int]:
        s = self.nfa.state()
        end = s
        while self._peek() not in ("", "|", ")"):
            fs, fe = self._repeat()
            self.nfa.eps[end].add(fs)
            end = fe
        return s, end

    def _repeat(self) -> tuple[int, int]:
        start_i = self.i
        frag = self._atom()
        end_i = self.i
        c = self._peek()
        if c == "*":
            self.i += 1
            return self._star(frag)
        if c == "+":
            self.i += 1
            s, e = frag
            rs, re_ = self._star(self._reparse(start_i, end_i))
            self.nfa.eps[e].add(rs)
            return s, re_
        if c == "?":
            self.i += 1
            return self._opt(frag)
        if c == "{":
            return self._counted(frag, start_i, end_i)
        return frag

    def _reparse(self, a: int, b: int) -> tuple[int, int]:
        # counted/`+` repetition copies the atom by re-parsing its source
        # span into the shared builder (fragments cannot be cloned cheaply)
        sub = _RegexParser(self.pat[:b], self.nfa)
        sub.i = a
        frag = sub._atom()
        if sub.i != b:
            raise CompileError("malformed quantified atom")
        return frag

    def _star(self, frag: tuple[int, int]) -> tuple[int, int]:
        fs, fe = frag
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].update((fs, e))
        self.nfa.eps[fe].update((fs, e))
        return s, e

    def _opt(self, frag: tuple[int, int]) -> tuple[int, int]:
        fs, fe = frag
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].update((fs, e))
        self.nfa.eps[fe].add(e)
        return s, e

    def _counted(self, frag, start_i: int, end_i: int) -> tuple[int, int]:
        self.i += 1  # '{'
        spec = ""
        while self._peek() != "}":
            spec += self._take()
        self.i += 1  # '}'
        try:
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else -1
            else:
                lo = hi = int(spec)
        except ValueError:
            raise CompileError(f"bad quantifier {{{spec}}}") from None
        if lo < 0 or (hi >= 0 and hi < lo) or lo > 256 or hi > 256:
            raise CompileError(f"bad quantifier bounds {{{spec}}}")
        s = self.nfa.state()
        end = s
        first = frag
        for _ in range(lo):
            fs, fe = first if first is not None else self._reparse(
                start_i, end_i)
            first = None
            self.nfa.eps[end].add(fs)
            end = fe
        if hi < 0:  # {m,}: m copies then a star
            fs, fe = self._star(first if first is not None
                                else self._reparse(start_i, end_i))
            self.nfa.eps[end].add(fs)
            end = fe
        else:
            for _ in range(hi - lo):
                fs, fe = self._opt(first if first is not None
                                   else self._reparse(start_i, end_i))
                first = None
                self.nfa.eps[end].add(fs)
                end = fe
            if first is not None:  # {0}: drop the parsed atom entirely
                pass
        return s, end

    def _atom(self) -> tuple[int, int]:
        c = self._take()
        if c == "(":
            if self.pat[self.i:self.i + 2] == "?:":
                self.i += 2
            frag = self._alt()
            if self._take() != ")":
                raise CompileError("unbalanced '('")
            return frag
        if c == "[":
            return self._byteset(self._cls())
        if c == ".":
            return self._byteset(_DOT)
        if c == "\\":
            return self._escape()
        if c in "*+?{)":
            raise CompileError(f"misplaced {c!r}")
        return self._literal(c)

    def _literal(self, ch: str) -> tuple[int, int]:
        bs = ch.encode("utf-8")
        s = self.nfa.state()
        cur = s
        for b in bs:
            nxt = self.nfa.state()
            self.nfa.edges[cur].append((frozenset((b,)), nxt))
            cur = nxt
        return s, cur

    def _byteset(self, byteset: frozenset[int]) -> tuple[int, int]:
        if not byteset:
            raise CompileError("empty character class")
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.edges[s].append((byteset, e))
        return s, e

    def _escape(self) -> tuple[int, int]:
        bs = self._escape_set(self._take())
        if len(bs) == 1:
            return self._byteset(bs)
        return self._byteset(bs)

    def _escape_set(self, c: str) -> frozenset[int]:
        table = {"d": _DIGITS, "D": _ALL - _DIGITS, "w": _WORD,
                 "W": _ALL - _WORD, "s": _SPACE, "S": _ALL - _SPACE,
                 "n": frozenset((0x0A,)), "t": frozenset((0x09,)),
                 "r": frozenset((0x0D,)), "f": frozenset((0x0C,)),
                 "v": frozenset((0x0B,)), "0": frozenset((0x00,))}
        if c in table:
            return table[c]
        if c == "x":
            hx = self._take() + self._take()
            try:
                return frozenset((int(hx, 16),))
            except ValueError:
                raise CompileError(f"bad \\x escape {hx!r}") from None
        if c.isalnum():
            raise CompileError(f"unsupported escape \\{c}")
        b = c.encode("utf-8")
        if len(b) != 1:
            raise CompileError(f"non-ASCII escape \\{c}")
        return frozenset(b)

    def _cls(self) -> frozenset[int]:
        negate = False
        if self._peek() == "^":
            negate = True
            self.i += 1
        out: set[int] = set()
        first = True

        def one() -> int | None:
            # single byte, or None when the item was a multi-byte escape
            # class (\d etc) already merged into `out`
            c = self._take()
            if c == "\\":
                s = self._escape_set(self._take())
                if len(s) == 1:
                    return next(iter(s))
                out.update(s)
                return None
            b = c.encode("utf-8")
            if len(b) != 1:
                raise CompileError("non-ASCII literal in class")
            return b[0]

        while True:
            if self._peek() == "]" and not first:
                self.i += 1
                break
            first = False
            lo = one()
            if lo is None:
                continue
            if self._peek() == "-" and self.pat[self.i + 1:self.i + 2] != "]":
                self.i += 1
                hi = one()
                if hi is None or hi < lo:
                    raise CompileError("bad class range")
                out.update(range(lo, hi + 1))
            else:
                out.add(lo)
        return frozenset(_ALL - out if negate else out)


class ByteDfa:
    """Subset-constructed byte DFA with dead states pruned. `table` is a
    (S+1, 256) int32 array whose last row is an absorbing dead sentinel —
    lockstep token walks index it without branching."""

    def __init__(self, table: np.ndarray, accepting: np.ndarray):
        self.table = table  # (S, 256) int32, -1 = dead
        self.accepting = accepting  # (S,) bool

    @property
    def n_states(self) -> int:
        return self.table.shape[0]


def compile_regex_bytes(pattern: str) -> ByteDfa:
    nfa = _Nfa()
    start, accept = _RegexParser(pattern, nfa).parse()

    def closure(states: frozenset[int]) -> frozenset[int]:
        out = set(states)
        stack = list(states)
        while stack:
            for t in nfa.eps[stack.pop()]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset((start,)))
    ids: dict[frozenset[int], int] = {start_set: 0}
    rows: list[list[int]] = []
    work = [start_set]
    while work:
        cur = work.pop()
        sid = ids[cur]
        while len(rows) <= sid:
            rows.append([-1] * 256)
        edges = [(bs, d) for s in cur for (bs, d) in nfa.edges[s]]
        by_byte: dict[int, set[int]] = {}
        for bs, d in edges:
            for b in bs:
                by_byte.setdefault(b, set()).add(d)
        for b, targets in by_byte.items():
            nxt = closure(frozenset(targets))
            nid = ids.get(nxt)
            if nid is None:
                nid = ids[nxt] = len(ids)
                if nid >= MAX_DFA_STATES:
                    raise CompileError(
                        f"grammar too large (> {MAX_DFA_STATES} DFA states)")
                work.append(nxt)
            rows[sid][b] = nid
    table = np.asarray(rows, np.int32).reshape(len(rows), 256)
    accepting = np.array([accept in s for s in
                          sorted(ids, key=ids.__getitem__)], bool)

    # prune states that cannot reach acceptance: every byte into them is
    # disallowed, so a masked sample can never paint a row into a corner
    alive = accepting.copy()
    changed = True
    while changed:
        changed = False
        reach = np.isin(table, np.flatnonzero(alive)).any(axis=1)
        grow = reach & ~alive
        if grow.any():
            alive |= grow
            changed = True
    if not alive[0]:
        raise CompileError("grammar matches no string")
    dead = ~alive
    table = np.where(np.isin(table, np.flatnonzero(dead)), -1, table)
    if dead.any():  # compact: renumber live states, drop dead rows
        remap = np.full(len(alive), -1, np.int32)
        remap[alive] = np.arange(int(alive.sum()), dtype=np.int32)
        table = table[alive]
        table = np.where(table >= 0, remap[np.clip(table, 0, None)], -1)
        accepting = accepting[alive]
    return ByteDfa(np.ascontiguousarray(table, np.int32), accepting)


@dataclass
class TokenAutomaton:
    """Token-level constraint automaton (module docstring). States are
    local; the engine's ConstraintTable rebases them when stacking."""

    mask: np.ndarray  # (S, W) uint32, W = ceil(V/32)
    delta: np.ndarray  # (S, V) int32, -1 disallowed
    forced: np.ndarray  # (S,) int32, -1 when the state is not forced
    eos_id: int
    source_hash: str = ""
    _bool_rows: dict[int, np.ndarray] = field(default_factory=dict,
                                              repr=False)

    @property
    def n_states(self) -> int:
        return self.delta.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.delta.shape[1]

    def allows(self, state: int, tok: int) -> bool:
        return bool(self.delta[state, tok] >= 0)

    def advance(self, state: int, tok: int) -> int:
        return int(self.delta[state, tok])

    def mask_bool(self, state: int) -> np.ndarray:
        """(V,) bool allowed row — host-side mirror of the device gather
        (cached per state; _advance_row masks prefill-boundary logits)."""
        row = self._bool_rows.get(state)
        if row is None:
            row = (self.delta[state] >= 0)
            self._bool_rows[state] = row
        return row

    def forced_chain(self, state: int, k: int) -> list[int]:
        """Up to k tokens along singleton-mask states from `state` — the
        GrammarProposer's guaranteed-accept draft. Stops at the first
        non-forced state and does not draft past EOS."""
        out: list[int] = []
        while len(out) < k:
            f = int(self.forced[state])
            if f < 0:
                break
            out.append(f)
            if f == self.eos_id:
                break
            state = int(self.delta[state, f])
        return out

    def validate(self, tokens: list[int]) -> tuple[bool, bool]:
        """(prefix_valid, complete): walk emitted tokens; EOS terminates
        the walk and is valid only at accepting states. A max_tokens-
        truncated output is a valid prefix but not complete."""
        st = 0
        for t in tokens:
            if t == self.eos_id:
                return self.allows(st, t), self.allows(st, t)
            st = self.advance(st, t)
            if st < 0:
                return False, False
        return True, self.allows(st, self.eos_id)


def token_automaton(dfa: ByteDfa, vocab: list[bytes], eos_id: int,
                    source_hash: str = "") -> TokenAutomaton:
    """Lower a byte DFA against the vocab: walk every token's bytes from
    EVERY DFA state in lockstep (numpy-vectorized over states, one pass
    per token). Empty pieces (BOS/pad/control tokens) are disallowed
    everywhere; EOS is allowed at accepting states into the absorbing
    `done` state."""
    sd = dfa.n_states
    if not (0 <= eos_id < len(vocab)):
        raise CompileError(f"eos id {eos_id} outside vocab")
    # sentinel dead row: index sd maps every byte to itself
    ext = np.vstack([np.where(dfa.table >= 0, dfa.table, sd).astype(np.int32),
                     np.full((1, 256), sd, np.int32)])
    v = len(vocab)
    done = sd  # absorbing post-EOS state
    delta = np.full((sd + 1, v), -1, np.int32)
    base = np.arange(sd, dtype=np.int32)
    for t, piece in enumerate(vocab):
        if t == eos_id or not piece:
            continue
        sv = base
        for b in piece:
            sv = ext[sv, b]
        delta[:sd, t] = np.where(sv < sd, sv, -1)
    delta[np.flatnonzero(dfa.accepting), eos_id] = done
    delta[done, eos_id] = done
    allowed = delta >= 0
    if not allowed[:sd].any(axis=1).all():
        # pruning guarantees byte-level liveness; a vocab that cannot spell
        # any continuation byte still strands the state — reject honestly
        raise CompileError("vocab cannot spell the grammar (empty mask row)")
    w = (v + 31) // 32
    padded = np.zeros((sd + 1, w * 32), bool)
    padded[:, :v] = allowed
    mask = (padded.reshape(sd + 1, w, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)
    counts = allowed.sum(axis=1)
    forced = np.where(counts == 1, allowed.argmax(axis=1), -1).astype(np.int32)
    return TokenAutomaton(mask=mask, delta=delta, forced=forced,
                          eos_id=eos_id, source_hash=source_hash)


def regex_token_automaton(pattern: str, vocab: list[bytes], eos_id: int,
                          source_hash: str = "") -> TokenAutomaton:
    return token_automaton(compile_regex_bytes(pattern), vocab, eos_id,
                           source_hash)
