"""Port parity: ``models/pretrained.py`` (``save_pretrained`` /
``from_pretrained``, ``AutoModel``, ``AutoConfig``) and
``framework/io.py`` (the ``.pits`` tensor store).

* A directory the JAX package saves loads into the port, and one the
  port saves loads into the JAX package, with logits allclose (fp32,
  rtol and atol 1e-5) for GPT, GPT-MoE, LLaMA with GQA and
  ErnieForPretraining.
* The port's ``.pits`` writer gives the reference's native writer's
  bytes; a bfloat16 round trip is bitwise, and the reader needs no
  ``ml_dtypes``.
* The reference's ``model.pdparams`` pickle fallback loads.
* A directory holding another architecture raises the reference's
  "holds a X, not a Y".  ErnieForMaskedLM and
  ErnieForSequenceClassification, unported until the training recipe's
  slice, load through ``AutoModel`` with the JAX model's logits and save
  back into the JAX package.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu import native as jnative
from paddle_infer_tpu.core.tensor import Tensor
from paddle_infer_tpu.models import AutoModel as JAutoModel
from paddle_infer_tpu.models import ErnieConfig as JErnieConfig
from paddle_infer_tpu.models import ErnieForMaskedLM as JErnieMLM
from paddle_infer_tpu.models import ErnieForPretraining as JErnie
from paddle_infer_tpu.models import \
    ErnieForSequenceClassification as JErnieCls
from paddle_infer_tpu.models import GPTConfig as JGPTConfig
from paddle_infer_tpu.models import GPTForCausalLM as JGPT
from paddle_infer_tpu.models import GPTMoEForCausalLM as JGPTMoE
from paddle_infer_tpu.models import MoEConfig as JMoEConfig
from paddle_infer_tpu.models import LlamaConfig as JLlamaConfig
from paddle_infer_tpu.models import LlamaForCausalLM as JLlama
from paddle_infer_tpu_torch.framework import io as fio
from paddle_infer_tpu_torch.models import (AutoConfig, AutoModel,
                                           ErnieForPretraining,
                                           GPTForCausalLM, LlamaConfig,
                                           LlamaForCausalLM)

from _torch_jax_isolation import ensure_jax_native

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
ERNIE = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=32, type_vocab_size=2,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _jax_model(kind):
    pit.seed(0)
    if kind == "gpt":
        m = JGPT(JGPTConfig(**TINY, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0))
    elif kind == "gpt_moe":
        m = JGPTMoE(JMoEConfig(num_experts=4, **TINY,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0))
    elif kind == "llama_gqa":
        m = JLlama(JLlamaConfig(**TINY, num_key_value_heads=2))
    else:
        m = JErnie(JErnieConfig(**ERNIE))
    m.eval()
    return m


def _ids():
    return np.random.RandomState(0).randint(0, 96, (2, 8)).astype(np.int32)


def _jax_logits(m, ids):
    out = m(Tensor(ids))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _port_logits(m, ids):
    with torch.no_grad():
        out = m(torch.tensor(ids, dtype=torch.long))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


KINDS = ["gpt", "gpt_moe", "llama_gqa", "ernie"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_saved_dir_loads_in_port(tmp_path, kind):
    jm = _jax_model(kind)
    jm.save_pretrained(str(tmp_path))
    tm = AutoModel.from_pretrained(str(tmp_path), device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    assert not tm.training
    assert next(tm.parameters()).dtype == torch.float32
    for a, b in zip(_port_logits(tm, _ids()), _jax_logits(jm, _ids())):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_port_saved_dir_loads_in_jax(tmp_path, kind):
    jm = _jax_model(kind)
    jm.save_pretrained(str(tmp_path / "jax"))
    tm = AutoModel.from_pretrained(str(tmp_path / "jax"), device="cpu")
    tm.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config.json") as f:
        cfg = json.load(f)
    with open(tmp_path / "jax" / "config.json") as f:
        assert cfg == json.load(f)
    assert sorted(os.listdir(tmp_path / "port")) == ["config.json",
                                                      "model.pits"]
    back = JAutoModel.from_pretrained(str(tmp_path / "port"))
    for a, b in zip(_jax_logits(back, _ids()), _port_logits(tm, _ids())):
        np.testing.assert_allclose(a, b, **TOL)


def test_pits_bytes_equal_native_writer(tmp_path):
    if not ensure_jax_native():
        pytest.skip("the JAX package's native library did not load")
    rs = np.random.RandomState(1)
    tensors = {"w": rs.randn(3, 5).astype(np.float32),
               "ids": rs.randint(0, 9, (4,)).astype(np.int64),
               "mask": np.array([True, False]), "s": np.float32(2.5),
               "empty": np.zeros((0, 7), np.float16)}
    # the reference's writer stores a numpy scalar as shape (1,)
    fio.save_tensors(str(tmp_path / "port.pits"),
                     {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in tensors.items()})
    jnative.save_tensors(str(tmp_path / "jax.pits"), tensors)
    assert ((tmp_path / "port.pits").read_bytes()
            == (tmp_path / "jax.pits").read_bytes())
    got = fio.load_tensors(str(tmp_path / "jax.pits"))
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert got[k].numpy().dtype == np.asarray(v).dtype


def test_bf16_round_trip_bitwise_without_ml_dtypes(tmp_path, monkeypatch):
    m = LlamaForCausalLM(LlamaConfig(**TINY, num_key_value_heads=2),
                         device="cpu", dtype=torch.bfloat16, seed=3)
    m.save_pretrained(str(tmp_path))
    # the reader must never reach for numpy's bfloat16
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    back = LlamaForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    raw = fio.load_tensors(str(tmp_path / "model.pits"))
    assert {t.dtype for t in raw.values()} == {torch.bfloat16}
    for (n, p), (n2, q) in zip(m.named_parameters(),
                               back.named_parameters()):
        assert n == n2 and q.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), q.view(torch.int16))
        assert torch.equal(raw[n].view(torch.int16), p.view(torch.int16))
    monkeypatch.undo()
    # the reference's native reader sees the same bits
    if ensure_jax_native():
        ref = jnative.load_tensors(str(tmp_path / "model.pits"))
        for n, p in m.named_parameters():
            assert np.array_equal(ref[n].view(np.uint16),
                                  p.view(torch.int16).numpy().view(
                                      np.uint16))


def test_dtype_and_device_arguments(tmp_path):
    """A model loads in the dtype it was saved in, on the device asked
    for."""
    _jax_model("gpt").save_pretrained(str(tmp_path / "f32"))
    tm = GPTForCausalLM.from_pretrained(str(tmp_path / "f32"), device="cpu")
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {p.device.type for p in tm.parameters()} == {"cpu"}
    tm.to(torch.bfloat16).save_pretrained(str(tmp_path / "bf16"))
    back = AutoModel.from_pretrained(str(tmp_path / "bf16"), device="cpu")
    assert {p.dtype for p in back.parameters()} == {torch.bfloat16}


def test_pdparams_fallback_loads(tmp_path):
    jm = _jax_model("llama_gqa")
    jm.save_pretrained(str(tmp_path))
    os.remove(tmp_path / "model.pits")
    pit.save({n: np.asarray(p._data) for n, p in jm.named_parameters()},
             str(tmp_path / "model.pdparams"))
    tm = AutoModel.from_pretrained(str(tmp_path), device="cpu")
    for a, b in zip(_port_logits(tm, _ids()), _jax_logits(jm, _ids())):
        np.testing.assert_allclose(a, b, **TOL)


def test_architecture_checked(tmp_path):
    jm = _jax_model("llama_gqa")
    jm.save_pretrained(str(tmp_path))
    m2 = LlamaForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert m2.config.num_key_value_heads == 2
    assert m2.config.rope_theta == jm.config.rope_theta
    with pytest.raises(ValueError, match="holds a LlamaForCausalLM"):
        GPTForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not a ErnieForPretraining"):
        ErnieForPretraining.from_pretrained(str(tmp_path), device="cpu")
    cfg = AutoConfig.from_pretrained(str(tmp_path))
    assert type(cfg).__name__ == "LlamaConfig"
    assert cfg.hidden_size == 32 and cfg.num_key_value_heads == 2


@pytest.mark.parametrize("arch", ["ErnieForMaskedLM",
                                  "ErnieForSequenceClassification"])
def test_unported_architectures_raise(tmp_path, arch):
    """The two ERNIE heads that raised here until the training recipe's
    slice ported them: a JAX-saved directory now loads through
    ``AutoModel`` (``num_classes`` riding on the config) with logits
    allclose to the JAX model's, ``AutoConfig`` reads the config, and the
    port's save loads back into the JAX package with the same logits."""
    pit.seed(2)
    if arch == "ErnieForSequenceClassification":
        jm = JErnieCls(JErnieConfig(**ERNIE), num_classes=5)
    else:
        jm = JErnieMLM(JErnieConfig(**ERNIE))
    jm.eval()
    jm.save_pretrained(str(tmp_path / "jax"))
    tm = AutoModel.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert type(tm).__name__ == arch
    cfg = AutoConfig.from_pretrained(str(tmp_path / "jax"))
    assert type(cfg).__name__ == "ErnieConfig"
    if arch == "ErnieForSequenceClassification":
        assert cfg.num_classes == 5 and tm.classifier.weight.shape == (32, 5)
    want = _jax_logits(jm, _ids())
    for a, b in zip(_port_logits(tm, _ids()), want):
        np.testing.assert_allclose(a, b, **TOL)
    tm.save_pretrained(str(tmp_path / "port"))
    back = JAutoModel.from_pretrained(str(tmp_path / "port"))
    for a, b in zip(_jax_logits(back, _ids()), want):
        np.testing.assert_allclose(a, b, **TOL)


def test_unknown_architecture_raises(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"architecture": "Bogus"}, f)
    with pytest.raises(ValueError, match="unknown architecture"):
        AutoModel.from_pretrained(str(tmp_path))


def test_missing_and_corrupt_stores(tmp_path):
    with pytest.raises(FileNotFoundError):
        fio.load_tensors(str(tmp_path / "none.pits"))
    fio.save_tensors(str(tmp_path / "a.pits"), {"w": torch.ones(4, 4)})
    data = (tmp_path / "a.pits").read_bytes()
    (tmp_path / "cut.pits").write_bytes(data[:-3])
    with pytest.raises(ValueError, match="corrupt"):
        fio.load_tensors(str(tmp_path / "cut.pits"))
    (tmp_path / "magic.pits").write_bytes(b"NOPE" + data[4:])
    with pytest.raises(ValueError, match="corrupt"):
        fio.load_tensors(str(tmp_path / "magic.pits"))
