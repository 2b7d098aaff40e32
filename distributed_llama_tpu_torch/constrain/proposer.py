"""GrammarProposer — the constraint automaton as a draft source (the port's copy of the
JAX package's constrain/proposer.py).

Implements the Proposer protocol (runtime/speculative.py): wherever the
row's automaton state sits on a forced-transition chain (singleton-mask
states — JSON punctuation, schema keys, closing brackets), the chain IS
the target model's only legal continuation, so proposing it gives
guaranteed accept without running any draft model. ProposerMux consults
it first for constrained rows; chat rows co-batched in the same engine
never reach it and keep their model/ngram drafts.

The proposer reads the engine's live per-slot constraint state (the same
object _emit advances), so propose() needs no corpus of its own — push()
and observe() are no-ops.
"""

from __future__ import annotations


class GrammarProposer:
    name = "grammar"

    def __init__(self) -> None:
        # row -> slot-constraint handle with .automaton / .state / .degraded
        self._rows: dict[int, object] = {}

    def attach_constraint(self, row: int, sc) -> None:
        self._rows[row] = sc

    def attach(self, row: int, tokens: list[int]) -> None:
        pass  # binding happens via attach_constraint at admission

    def detach(self, row: int) -> None:
        self._rows.pop(row, None)

    def push(self, row: int, tok: int) -> None:
        pass  # the engine advances the shared constraint state in _emit

    def observe(self, row: int, accepted: int) -> None:
        pass

    def propose(self, row: int, k: int) -> list[int]:
        sc = self._rows.get(row)
        if sc is None or sc.degraded or k <= 0:
            return []
        return sc.automaton.forced_chain(sc.state, k)

    def propose_batch(self, want: dict[int, int]) -> dict[int, list[int]]:
        return {row: d for row, k in want.items()
                if (d := self.propose(row, k))}

    def ready(self, row: int, k: int, min_draft: int) -> bool:
        return len(self.propose(row, k)) >= min_draft

    def stats(self) -> dict:
        return {"rows": len(self._rows)}
