"""Streaming stop-sequence detector.

Behavior-parity port of EosDetector (src/tokenizer.cpp:502-575): matches stop strings
that may be split across token boundaries, tolerating `padding_left` junk bytes before
and `padding_right` after the stop string inside the held-back window, and short-circuits
on the EOS token id. Operates on bytes (token pieces may be partial UTF-8).
"""

from __future__ import annotations

import enum


class EosResult(enum.Enum):
    NOT_EOS = 0
    MAYBE_EOS = 1
    EOS = 2


class EosDetector:
    def __init__(self, eos_ids: int | list[int], stops: list[bytes | str],
                 padding_left: int = 0, padding_right: int = 0):
        self.eos_ids = {eos_ids} if isinstance(eos_ids, int) else set(eos_ids)
        self.stops = [s.encode() if isinstance(s, str) else s for s in stops]
        self.padding_left = padding_left
        self.padding_right = padding_right
        self.buffer = bytearray()
        self.eos_pos = -1

    def append(self, token_id: int, piece: bytes) -> EosResult:
        piece_start = len(self.buffer)
        self.buffer += piece

        if token_id in self.eos_ids:
            self.eos_pos = piece_start
            return EosResult.EOS
        self.eos_pos = -1

        n_buf = len(self.buffer)
        for stop in self.stops:
            stop_size = len(stop)
            if n_buf > stop_size + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = n_buf - lo
                if n == 0 or n > stop_size + self.padding_right:
                    continue
                n = min(n, stop_size)
                if self.buffer[lo:lo + n] == stop[:n]:
                    if n == stop_size:
                        self.eos_pos = lo
                        return EosResult.EOS
                    return EosResult.MAYBE_EOS
        return EosResult.NOT_EOS

    def get_delta(self) -> bytes | None:
        """Printable bytes accumulated so far (up to the stop match, if any)."""
        if self.eos_pos == -1:
            return bytes(self.buffer) or None
        if self.eos_pos == 0:
            return None
        return bytes(self.buffer[:self.eos_pos])

    def clear(self) -> None:
        self.buffer.clear()


class TokenStreamer:
    """Drives an EosDetector over a token stream, emitting printable deltas.

    Shared state machine for CLI chat and the API server: holds back bytes that might be
    the start of a stop sequence, flushes them when they turn out not to be, and reports
    when generation should stop."""

    def __init__(self, detector: EosDetector, decode_piece, emit):
        self.detector = detector
        self.decode_piece = decode_piece
        self.emit = emit
        self.stopped = False

    def on_token(self, token_id: int) -> None:
        res = self.detector.append(token_id, self.decode_piece(token_id))
        if res == EosResult.MAYBE_EOS:
            return  # hold back until resolved
        delta = self.detector.get_delta()
        if delta:
            self.emit(delta)
        if res == EosResult.EOS:
            self.stopped = True
        else:
            self.detector.clear()

    def stop_check(self, _token_id: int) -> bool:
        return self.stopped
