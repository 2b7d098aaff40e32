"""PyTorch port: the tokenizer, chat templates, EOS detection and the sampler are copies
of the JAX package's jax-free modules; held to identical ids, renders, EOS results and
seeded sample streams."""

import numpy as np
import pytest

from distributed_llama_tpu.formats.tfile import TokenizerData as JData
from distributed_llama_tpu.runtime.sampler import Sampler as JSampler
from distributed_llama_tpu.tokenizer import ChatItem as JItem
from distributed_llama_tpu.tokenizer import ChatTemplate as JTemplate
from distributed_llama_tpu.tokenizer import EosDetector as JEos
from distributed_llama_tpu.tokenizer import Tokenizer as JTok
from distributed_llama_tpu_torch.formats.tfile import TokenizerData as TData
from distributed_llama_tpu_torch.runtime.sampler import Sampler as TSampler
from distributed_llama_tpu_torch.tokenizer import ChatItem as TItem
from distributed_llama_tpu_torch.tokenizer import ChatTemplate as TTemplate
from distributed_llama_tpu_torch.tokenizer import EosDetector as TEos
from distributed_llama_tpu_torch.tokenizer import Tokenizer as TTok

_VOCAB = ([b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
          + [b" ", b"h", b"e", b"l", b"o", b"he", b"ll", b"llo", b"hello", b" hello",
             "é".encode(), b"<|im_end|>"])
_SCORES = [0.0] * 259 + [-float(i) for i in range(len(_VOCAB) - 259)]


def _toks():
    kw = dict(vocab=_VOCAB, scores=_SCORES, bos_id=1, eos_id=2, chat_eos_id=len(_VOCAB) - 1,
              max_token_length=10, chat_template="<|im_start|>")
    return JTok(JData(**kw)), TTok(TData(**kw))


@pytest.mark.parametrize("text", ["hello", "hello hello", "hé☃llo", "", "x\ny"])
def test_tokenizer_same_ids_and_text(text):
    j, t = _toks()
    ids = t.encode(text, add_bos=True, add_eos=True)
    assert ids == j.encode(text, add_bos=True, add_eos=True)
    assert t.decode(ids) == j.decode(ids)
    assert [t.decode_piece(1, i) for i in ids] == [j.decode_piece(1, i) for i in ids]
    assert t.chat_stops() == j.chat_stops() and t.eos_piece() == j.eos_piece()


@pytest.mark.parametrize("ttype", ["llama2", "llama3", "zephyr", "chatml", "unknown"])
def test_chat_templates_render_identically(ttype):
    msgs = [("system", "be brief"), ("user", "hi"), ("assistant", "hello"), ("user", "ok?")]
    j = JTemplate(ttype, "<|im_start|>", "</s>")
    t = TTemplate(ttype, "<|im_start|>", "</s>")
    assert (t.generate([TItem(r, m) for r, m in msgs])
            == j.generate([JItem(r, m) for r, m in msgs]))


def test_eos_detector_results_identical():
    stream = [(5, b"Hel"), (6, b"lo <"), (7, b"|im_"), (8, b"end"), (9, b"|> x"), (2, b"")]
    for pl, pr in ((0, 0), (2, 2)):
        j = JEos(2, ["<|im_end|>"], padding_left=pl, padding_right=pr)
        t = TEos(2, ["<|im_end|>"], padding_left=pl, padding_right=pr)
        for tid, piece in stream:
            assert t.append(tid, piece).value == j.append(tid, piece).value
            assert t.get_delta() == j.get_delta()


@pytest.mark.parametrize("temperature,topp", [(0.0, 0.9), (0.8, 0.9), (1.0, 1.0),
                                              (1.5, 0.5)])
def test_seeded_sample_streams_identical(temperature, topp):
    rng = np.random.RandomState(11)
    j = JSampler(300, temperature=temperature, topp=topp, seed=12345)
    t = TSampler(300, temperature=temperature, topp=topp, seed=12345)
    for _ in range(40):
        logits = (rng.randn(300) * 3).astype(np.float32)
        assert t.sample(logits) == j.sample(logits)
    assert int(t.state) == int(j.state)
