"""llama2.c-style BPE tokenizer (host-side, byte-oriented).

Behavior-parity port of the reference encoder/decoder (src/tokenizer.cpp:150-292):
greedy highest-score pair merging, UTF-8 codepoint pre-chunking, byte-fallback with the
+3 offset, dummy-prefix space, and the BOS leading-space decode strip. One deliberate
fix: the reference's byte-token detection compares `sscanf(...) == bosId`
(tokenizer.cpp:157) — a literal `== 1` only by accident of llama2's bosId; we treat a
successful `<0xXX>` parse as a byte token regardless of bosId.

Works on bytes throughout (vocab entries are raw byte strings from the `.t` file).
"""

from __future__ import annotations

import re

from ..formats.tfile import TokenizerData

_BYTE_TOKEN_RE = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")


class Tokenizer:
    def __init__(self, data: TokenizerData):
        self.data = data
        self.vocab = data.vocab
        self.scores = data.scores
        self.bos_id = data.bos_id
        self.eos_id = data.eos_id
        self.chat_eos_id = data.chat_eos_id if data.chat_eos_id >= 0 else data.eos_id
        self.chat_template = data.chat_template
        self.chat_stop = data.chat_stop
        # first occurrence wins for duplicate pieces (reference bsearch picks
        # an arbitrary duplicate; dict-of-first is deterministic)
        self._lookup: dict[bytes, int] = {}
        for i, piece in enumerate(self.vocab):
            self._lookup.setdefault(piece, i)
        self._byte_pieces: list[bytes | None] = [None] * len(self.vocab)
        for i, piece in enumerate(self.vocab):
            m = _BYTE_TOKEN_RE.match(piece)
            if m:
                self._byte_pieces[i] = bytes([int(m.group(1), 16)])

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        from ..formats.tfile import load_tokenizer

        return cls(load_tokenizer(path))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def eos_piece(self) -> str:
        """Printable chat-EOS string (used as the template's eos marker)."""
        if self.chat_eos_id >= 0:
            return self.vocab[self.chat_eos_id].decode("utf-8", "replace")
        return "</s>"

    def chat_stops(self) -> list[bytes]:
        """Stop byte-strings for chat generation (reference TokenizerChatStops,
        tokenizer.cpp:417-434): the chat-EOS piece plus the optional extra stop."""
        stops: list[bytes] = []
        if self.chat_eos_id >= 0:
            stops.append(self.vocab[self.chat_eos_id])
        if self.chat_stop:
            stops.append(self.chat_stop.encode())
        return stops

    def encode(self, text: str | bytes, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        """Reference Tokenizer::encode (tokenizer.cpp:170-292)."""
        raw = text.encode("utf-8") if isinstance(text, str) else text
        tokens: list[int] = []
        if add_bos and self.bos_id >= 0:
            tokens.append(self.bos_id)
        if raw:
            dummy = self._lookup.get(b" ")
            if dummy is not None:
                tokens.append(dummy)

        # UTF-8 codepoint chunking: accumulate continuation bytes (max 4), then lookup
        i, n = 0, len(raw)
        while i < n:
            j = i + 1
            while j < n and (raw[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            chunk = raw[i:j]
            tid = self._lookup.get(chunk)
            if tid is not None:
                tokens.append(tid)
            else:
                # byte fallback: first 3 vocab slots are <unk>, <s>, </s>
                tokens.extend(b + 3 for b in chunk)
            i = j

        # greedy merge: repeatedly merge the adjacent pair whose concatenation is the
        # highest-scoring vocab entry
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for k in range(len(tokens) - 1):
                merged = self.vocab[tokens[k]] + self.vocab[tokens[k + 1]]
                mid = self._lookup.get(merged)
                if mid is not None and self.scores[mid] > best_score:
                    best_score = self.scores[mid]
                    best_id = mid
                    best_idx = k
            if best_idx == -1:
                break
            tokens[best_idx:best_idx + 2] = [best_id]

        if add_eos and self.eos_id >= 0:
            tokens.append(self.eos_id)
        return tokens

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        """Reference Tokenizer::decode (tokenizer.cpp:150-161): returns the raw bytes for
        one token given its predecessor (BOS leading-space strip)."""
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            piece = piece[1:]
        b = self._byte_pieces[token]
        if b is not None:
            return b
        return piece

    def decode(self, tokens: list[int]) -> str:
        out = bytearray()
        prev = self.bos_id if tokens and tokens[0] == self.bos_id else -1
        for t in tokens:
            if t == self.bos_id:
                prev = t
                continue
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")
