"""PyTorch port: `.m` and `.t` files against the JAX package's readers and writers.
The formats are byte streams, so parity is exact."""

import numpy as np
import pytest

from distributed_llama_tpu.formats import mfile as jm
from distributed_llama_tpu.formats import tfile as jt
from distributed_llama_tpu.models.params import init_random_params
from distributed_llama_tpu.models.spec import ArchType, ModelSpec, RopeType
from distributed_llama_tpu.quants import FloatType
from distributed_llama_tpu.quants import QTensor as JQTensor
from distributed_llama_tpu_torch.formats import mfile as tm
from distributed_llama_tpu_torch.formats import tfile as tt
from distributed_llama_tpu_torch.models import params as tparams
from distributed_llama_tpu_torch.models.spec import ArchType as TArch
from distributed_llama_tpu_torch.models.spec import ModelSpec as TSpec
from distributed_llama_tpu_torch.quants import FloatType as TFloat
from distributed_llama_tpu_torch.quants import QTensor as TQTensor

_KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=262,
           seq_len=64)


@pytest.mark.parametrize("ftype", [FloatType.Q40, FloatType.Q80, FloatType.F32])
def test_load_model_of_jax_written_file(tmp_path, ftype):
    spec = ModelSpec(arch_type=ArchType.LLAMA, rope_type=RopeType.LLAMA, **_KW).resolved()
    params = init_random_params(spec, ftype, seed=9)
    path = str(tmp_path / "m.m")
    jm.write_model(path, spec, jm.params_file_order(spec, params), ftype)

    jspec, jp = jm.load_model(path)
    tspec, tp = tm.load_model(path)
    assert tuple(tspec.__dict__.values()) == tuple(jspec.__dict__.values())
    assert tm.read_spec(path)[1:] == (TFloat(int(ftype)), jm.read_spec(path)[2])
    np.testing.assert_array_equal(tp["embedding"].numpy(), jp["embedding"])
    np.testing.assert_array_equal(tp["rms_final"].numpy(), jp["rms_final"])
    for name, jv in list(jp["blocks"].items()) + [("wcls", jp["wcls"])]:
        tv = tp["wcls"] if name == "wcls" else tp["blocks"][name]
        if isinstance(jv, JQTensor):
            assert isinstance(tv, TQTensor) and tv.ftype == int(jv.ftype)
            np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))
            if jv.scales is not None:
                np.testing.assert_array_equal(tv.scales.numpy(), np.asarray(jv.scales))
        else:
            np.testing.assert_array_equal(tv.numpy(), jv)


def test_write_model_byte_identical(tmp_path):
    """The port writes the same bytes as the JAX package from the same weights."""
    jspec = ModelSpec(arch_type=ArchType.LLAMA, **_KW).resolved()
    tspec = TSpec(arch_type=TArch.LLAMA, **_KW).resolved()
    jp = init_random_params(jspec, FloatType.Q40, seed=3)
    tp = tparams.init_random_params(tspec, TFloat.Q40, seed=3)
    jpath, tpath = str(tmp_path / "j.m"), str(tmp_path / "t.m")
    jm.write_model(jpath, jspec, jm.params_file_order(jspec, jp), FloatType.Q40)
    tm.write_model(tpath, tspec, tm.params_file_order(tspec, tp), TFloat.Q40)
    with open(jpath, "rb") as f1, open(tpath, "rb") as f2:
        assert f1.read() == f2.read()


def test_tokenizer_file_round_trip(tmp_path):
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b" ab", b"cd"]
    scores = [0.0] * 259 + [-1.0, -2.0]
    kw = dict(bos_id=1, eos_id=2, chat_eos_id=2, max_token_length=4,
              chat_template="{% [INST] %}", chat_stop="</s>")
    a, b = str(tmp_path / "a.t"), str(tmp_path / "b.t")
    jt.write_tokenizer(a, jt.TokenizerData(vocab=vocab, scores=scores, **kw))
    tt.write_tokenizer(b, tt.TokenizerData(vocab=vocab, scores=scores, **kw))
    with open(a, "rb") as f1, open(b, "rb") as f2:
        assert f1.read() == f2.read()
    assert tt.load_tokenizer(a).__dict__ == jt.load_tokenizer(b).__dict__
