"""Grammar-constrained decoding (the port's copy of the JAX package's constrain/).

JSON Schema / regex / EBNF grammars each lower to ONE token-level mask automaton
(automaton.py): a byte DFA over the tokenizer vocab precompiled to per-state packed
32-bit bitmask rows plus a dense transition table. The BatchEngine stacks attached
automata into one device-resident table (table.py: allocated once, re-uploaded in place,
so captured CUDA graphs keep reading it) and the batched decode/verify steps gather and
apply the mask before the sampler (runtime/device_loop.py, masked=True builds);
GrammarProposer walks forced-transition chains so the constraint itself drafts the
guaranteed-accept continuation (runtime/speculative.py ProposerMux).
"""

from .automaton import CompileError, TokenAutomaton
from .compiler import (byte_vocab, compile_grammar, compile_stats,
                       grammar_hash, vocab_bytes)
from .proposer import GrammarProposer
from .table import ConstraintTable

__all__ = [
    "CompileError", "TokenAutomaton", "GrammarProposer", "ConstraintTable",
    "byte_vocab", "compile_grammar", "compile_stats", "grammar_hash",
    "vocab_bytes",
]
