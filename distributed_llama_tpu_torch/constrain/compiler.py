"""Grammar forms -> TokenAutomaton, LRU-cached by grammar hash (the port's copy of the
JAX package's constrain/compiler.py, with its metric family and fault point).

Three forms lower to the shared byte-regex core (automaton.py):

  json_schema  canonical-JSON regex (no inter-token whitespace; object
               properties emitted in declaration order, all required;
               enum/const/anyOf as alternation; $ref/allOf rejected)
  regex        the byte-regex subset directly
  grammar      non-recursive EBNF (`name ::= body`), rules inlined in
               dependency order; recursion is a CompileError

Repeated schemas compile once: the cache is keyed by
sha256(kind ⊕ source ⊕ vocab signature) — the same hash the api edge logs
into the flight-recorder timeline and /v1/stats reports per compile.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
from collections import OrderedDict

from ..obs import metrics
from ..resilience import faults
from .automaton import CompileError, TokenAutomaton, regex_token_automaton

_COMPILES = metrics.counter(
    "constrain_compile_total",
    "Grammar compiles by outcome (hit = LRU cache hit)",
    labelnames=("outcome",))

_CACHE_CAP = 64
_cache: OrderedDict[str, TokenAutomaton] = OrderedDict()
_lock = threading.Lock()  # guards: _cache, _stats
_stats = {"hits": 0, "misses": 0, "errors": 0}


def grammar_hash(kind: str, source) -> str:
    src = source if isinstance(source, str) else json.dumps(
        source, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(f"{kind}\x00{src}".encode()).hexdigest()[:16]


def compile_stats() -> dict:
    with _lock:
        return dict(_stats, size=len(_cache))


def _vocab_sig(vocab: list[bytes], eos_id: int) -> str:
    h = hashlib.sha256(str((len(vocab), eos_id)).encode())
    for p in vocab[:256]:
        h.update(p or b"\x00")
    return h.hexdigest()[:12]


def vocab_bytes(tokenizer) -> list[bytes]:
    """Per-token byte pieces as served: `<0xNN>` byte-fallback tokens decode
    to their raw byte, everything else to its vocab piece."""
    out = []
    for i, piece in enumerate(tokenizer.vocab):
        b = tokenizer._byte_pieces[i]
        out.append(b if b is not None else piece)
    return out


def byte_vocab(vocab_size: int, specials: tuple[int, ...] = (0, 1, 2)
               ) -> list[bytes]:
    """Synthetic vocab for tokenizer-less engines (tests, tiny benches):
    token i spells the single byte i % 256; special ids (unk/bos/eos) spell
    nothing and are therefore never grammar-allowed except EOS's dedicated
    accepting-state handling."""
    return [b"" if i in specials else bytes([i % 256])
            for i in range(vocab_size)]


def compile_grammar(kind: str, source, vocab: list[bytes], eos_id: int
                    ) -> tuple[TokenAutomaton, str]:
    """Compile (or fetch) the automaton for one grammar. Raises
    CompileError for malformed/unsupported grammars — the api edge maps it
    to an honest 400 before any queue work."""
    faults.fire("constrain.compile", kind=kind)
    ghash = grammar_hash(kind, source)
    key = f"{ghash}:{_vocab_sig(vocab, eos_id)}"
    with _lock:
        aut = _cache.get(key)
        if aut is not None:
            _cache.move_to_end(key)
            _stats["hits"] += 1
            _COMPILES.labels(outcome="hit").inc()
            return aut, ghash
    try:
        if kind == "json_schema":
            pattern = schema_to_regex(source)
        elif kind == "regex":
            if not isinstance(source, str):
                raise CompileError("regex source must be a string")
            pattern = source
        elif kind == "grammar":
            if not isinstance(source, str):
                raise CompileError("grammar source must be a string")
            pattern = ebnf_to_regex(source)
        else:
            raise CompileError(f"unknown grammar kind {kind!r}")
        aut = regex_token_automaton(pattern, vocab, eos_id,
                                    source_hash=ghash)
    except CompileError:
        with _lock:
            _stats["errors"] += 1
        _COMPILES.labels(outcome="error").inc()
        raise
    except RecursionError:
        with _lock:
            _stats["errors"] += 1
        _COMPILES.labels(outcome="error").inc()
        raise CompileError("grammar too deeply nested") from None
    with _lock:
        _cache[key] = aut
        _stats["misses"] += 1
        while len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
    _COMPILES.labels(outcome="miss").inc()
    return aut, ghash


# ----------------------------------------------------------------------
# JSON Schema -> regex
# ----------------------------------------------------------------------

_ESC = {c: "\\" + c for c in "\\^$.|?*+()[]{}"}


def _rx_escape(s: str) -> str:
    return "".join(_ESC.get(c, c) for c in s)


_RX_STRING = '"(?:[^"\\\\\\x00-\\x1f]|\\\\["\\\\/bfnrt])*"'
_RX_INT = "-?(?:0|[1-9][0-9]{0,17})"
_RX_NUMBER = _RX_INT + "(?:\\.[0-9]{1,17})?(?:[eE][+-]?[0-9]{1,3})?"

_MAX_SCHEMA_DEPTH = 12


def schema_to_regex(schema) -> str:
    if isinstance(schema, str):
        try:
            schema = json.loads(schema)
        except ValueError as e:
            raise CompileError(f"json_schema is not valid JSON: {e}") from None
    if not isinstance(schema, dict):
        raise CompileError("json_schema must be an object")
    return _schema_rx(schema, 0)


def _schema_rx(schema: dict, depth: int) -> str:
    if depth > _MAX_SCHEMA_DEPTH:
        raise CompileError("json_schema nests too deep")
    if not isinstance(schema, dict):
        raise CompileError("schema node must be an object")
    for bad in ("$ref", "allOf", "not", "patternProperties"):
        if bad in schema:
            raise CompileError(f"unsupported json_schema keyword {bad!r}")
    if "const" in schema:
        return _rx_escape(json.dumps(schema["const"],
                                     separators=(",", ":")))
    if "enum" in schema:
        opts = schema["enum"]
        if not isinstance(opts, list) or not opts:
            raise CompileError("enum must be a non-empty array")
        return "(?:" + "|".join(
            _rx_escape(json.dumps(v, separators=(",", ":")))
            for v in opts) + ")"
    for alt_kw in ("anyOf", "oneOf"):
        if alt_kw in schema:
            alts = schema[alt_kw]
            if not isinstance(alts, list) or not alts:
                raise CompileError(f"{alt_kw} must be a non-empty array")
            return "(?:" + "|".join(_schema_rx(a, depth + 1)
                                    for a in alts) + ")"
    t = schema.get("type")
    if isinstance(t, list):
        return "(?:" + "|".join(
            _schema_rx(dict(schema, type=one), depth + 1) for one in t) + ")"
    if t == "string":
        if "pattern" in schema:
            # anchored pattern over the string BODY; the subset has no
            # anchors so the author's pattern constrains the full body
            return '"' + str(schema["pattern"]) + '"'
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is not None or hi is not None:
            lo = int(lo or 0)
            hi = int(hi if hi is not None else lo + 64)
            if hi < lo:
                raise CompileError("maxLength < minLength")
            ch = '(?:[^"\\\\\\x00-\\x1f]|\\\\["\\\\/bfnrt])'
            return f'"{ch}{{{lo},{hi}}}"'
        return _RX_STRING
    if t == "integer":
        return _RX_INT
    if t == "number":
        return _RX_NUMBER
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = _schema_rx(schema.get("items", {"type": "string"}), depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is None:
            if lo == 0:
                return f"\\[(?:{item}(?:,{item})*)?\\]"
            return f"\\[{item}(?:,{item}){{{lo - 1},}}\\]"
        hi = int(hi)
        if hi < lo:
            raise CompileError("maxItems < minItems")
        if hi == 0:
            return "\\[\\]"
        body = f"{item}(?:,{item}){{{max(lo - 1, 0)},{hi - 1}}}"
        return f"\\[(?:{body})?\\]" if lo == 0 else f"\\[{body}\\]"
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise CompileError("properties must be an object")
        if not props:
            return "\\{\\}"
        # canonical emission: every declared property, declaration order,
        # no whitespace — the schema's one unambiguous serialization, so
        # forced-transition chains stay long (docs/SERVING.md)
        parts = [f"{_rx_escape(json.dumps(k))}:{_schema_rx(v, depth + 1)}"
                 for k, v in props.items()]
        return "\\{" + ",".join(parts) + "\\}"
    raise CompileError(f"unsupported json_schema type {t!r}")


# ----------------------------------------------------------------------
# EBNF -> regex (non-recursive rules, inlined)
# ----------------------------------------------------------------------

_RULE_RE = re.compile(r"^\s*([A-Za-z_][\w-]*)\s*::=\s*(.*)$")
_TOKEN_RE = re.compile(
    r"""\s*(?:
        "((?:[^"\\]|\\.)*)" |       # double-quoted terminal
        '((?:[^'\\]|\\.)*)' |       # single-quoted terminal
        (\[(?:[^\]\\]|\\.)*\]) |    # character class, passed through
        ([A-Za-z_][\w-]*)    |      # rule reference
        ([()|*+?])                  # structure
    )""", re.VERBOSE)


def ebnf_to_regex(src: str) -> str:
    rules: dict[str, str] = {}
    order: list[str] = []
    for raw in src.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        m = _RULE_RE.match(line)
        if m is None:
            raise CompileError(f"bad EBNF rule line: {line.strip()!r}")
        name, body = m.group(1), m.group(2)
        if name in rules:
            raise CompileError(f"duplicate EBNF rule {name!r}")
        rules[name] = body
        order.append(name)
    if not rules:
        raise CompileError("empty EBNF grammar")
    root = "root" if "root" in rules else order[0]
    return _ebnf_rx(root, rules, ())


def _ebnf_rx(name: str, rules: dict[str, str], stack: tuple[str, ...]) -> str:
    if name in stack:
        raise CompileError(
            f"recursive EBNF rule {name!r} (recursion is unsupported; "
            "bound the repetition explicitly)")
    if name not in rules:
        raise CompileError(f"undefined EBNF rule {name!r}")
    body = rules[name]
    out: list[str] = []
    i = 0
    while i < len(body):
        if body[i].isspace():
            i += 1
            continue
        m = _TOKEN_RE.match(body, i)
        if m is None:
            raise CompileError(f"bad EBNF token at {body[i:]!r}")
        i = m.end()
        dq, sq, cls, ref, op = m.groups()
        lit = dq if dq is not None else sq
        if lit is not None:
            text = lit.replace('\\"', '"').replace("\\'", "'")
            text = text.replace("\\n", "\n").replace("\\t", "\t")
            text = text.replace("\\\\", "\\")
            out.append("(?:" + _rx_escape(text) + ")")
        elif cls is not None:
            out.append(cls)
        elif ref is not None:
            out.append("(?:" + _ebnf_rx(ref, rules, stack + (name,)) + ")")
        else:
            out.append(op)
    return "".join(out)
