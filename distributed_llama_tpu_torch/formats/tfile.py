"""`.t` tokenizer file format — byte-compatible reader/writer.

Format (reference: src/tokenizer.cpp:39-138 for parsing, converter/tokenizer-writer.py):

    [magic 0x567124 i32][header_size i32][(key i32, value i32) * nKv]
    [chat_template bytes][chat_stop bytes]
    per token i in 0..vocab_size: [score f32][len i32][bytes]

Header keys (tokenizer.hpp:24-34): version=0, vocab_size=1, max_token_length=2, bos_id=3,
eos_id=4, pad_id=5, chat_eos_id=6, chat_template(len)=7, chat_stop(len)=8. The legacy
magic 0x567123 uses a fixed struct header.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = 0x567124
LEGACY_MAGIC = 0x567123

KEY_VERSION = 0
KEY_VOCAB_SIZE = 1
KEY_MAX_TOKEN_LENGTH = 2
KEY_BOS_ID = 3
KEY_EOS_ID = 4
KEY_PAD_ID = 5
KEY_CHAT_EOS_ID = 6
KEY_CHAT_TEMPLATE = 7
KEY_CHAT_STOP = 8


@dataclass
class TokenizerData:
    vocab: list[bytes]
    scores: list[float]
    bos_id: int = -1
    eos_id: int = -1
    chat_eos_id: int = -1
    max_token_length: int = 0
    chat_template: str | None = None
    chat_stop: str | None = None
    pad_id: int = -1

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def load_tokenizer(path: str) -> TokenizerData:
    with open(path, "rb") as f:
        magic = struct.unpack("<i", f.read(4))[0]
        chat_template = chat_stop = None
        chat_eos_id = -1
        pad_id = -1
        if magic == LEGACY_MAGIC:
            # TokenizerOldHeader: vocabSize, maxTokenLength, bosId, eosId, padId
            vocab_size, max_len, bos_id, eos_id, pad_id = struct.unpack("<5i", f.read(20))
        elif magic == MAGIC:
            header_size = struct.unpack("<i", f.read(4))[0]
            n = (header_size - 8) // 4
            ints = struct.unpack(f"<{n}i", f.read(n * 4))
            kv = {ints[i]: ints[i + 1] for i in range(0, n, 2)}
            if kv.get(KEY_VERSION) != 1:
                raise ValueError("old tokenizer version, please regenerate")
            vocab_size = kv[KEY_VOCAB_SIZE]
            max_len = kv[KEY_MAX_TOKEN_LENGTH]
            bos_id = kv.get(KEY_BOS_ID, -1)
            eos_id = kv.get(KEY_EOS_ID, -1)
            chat_eos_id = kv.get(KEY_CHAT_EOS_ID, -1)
            pad_id = kv.get(KEY_PAD_ID, -1)
            tpl_len = kv.get(KEY_CHAT_TEMPLATE, 0)
            stop_len = kv.get(KEY_CHAT_STOP, 0)
            if tpl_len > 0:
                chat_template = f.read(tpl_len).decode("utf-8", errors="replace")
                # reference stores the template WITH its NUL terminator included in len
                chat_template = chat_template.rstrip("\x00")
            if stop_len > 0:
                chat_stop = f.read(stop_len).decode("utf-8", errors="replace").rstrip("\x00")
        else:
            raise ValueError(f"invalid tokenizer file magic {magic:#x}")

        vocab: list[bytes] = []
        scores: list[float] = []
        for _ in range(vocab_size):
            score = struct.unpack("<f", f.read(4))[0]
            ln = struct.unpack("<i", f.read(4))[0]
            vocab.append(f.read(ln))
            scores.append(score)

    return TokenizerData(vocab=vocab, scores=scores, bos_id=bos_id, eos_id=eos_id,
                         chat_eos_id=chat_eos_id, max_token_length=max_len,
                         chat_template=chat_template, chat_stop=chat_stop, pad_id=pad_id)


def write_tokenizer(path: str, t: TokenizerData) -> None:
    kv: list[tuple[int, int]] = [
        (KEY_VERSION, 1),
        (KEY_VOCAB_SIZE, t.vocab_size),
        (KEY_MAX_TOKEN_LENGTH, t.max_token_length or max(len(v) for v in t.vocab)),
    ]
    if t.bos_id >= 0:
        kv.append((KEY_BOS_ID, t.bos_id))
    if t.eos_id >= 0:
        kv.append((KEY_EOS_ID, t.eos_id))
    if t.pad_id >= 0:
        kv.append((KEY_PAD_ID, t.pad_id))
    if t.chat_eos_id >= 0:
        kv.append((KEY_CHAT_EOS_ID, t.chat_eos_id))
    # no NUL terminator — reference converters write the raw utf-8 bytes
    tpl = t.chat_template.encode() if t.chat_template else b""
    stop = t.chat_stop.encode() if t.chat_stop else b""
    if tpl:
        kv.append((KEY_CHAT_TEMPLATE, len(tpl)))
    if stop:
        kv.append((KEY_CHAT_STOP, len(stop)))
    data = b"".join(struct.pack("<ii", k, v) for k, v in kv)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", MAGIC))
        f.write(struct.pack("<i", 8 + len(data)))
        f.write(data)
        f.write(tpl)
        f.write(stop)
        for score, piece in zip(t.scores, t.vocab):
            f.write(struct.pack("<f", float(score)))
            f.write(struct.pack("<i", len(piece)))
            f.write(piece)
