"""Port parity: the GPT family.

The reference speculation tests' fixture model (vocab 96, hidden 32, 2
layers, 4 heads, ffn 64, 64 positions, dropout 0) through the port's
``GPTForCausalLM`` against the JAX model, weights carried over by
``from_jax_state_dict``: dense logits, the ragged paged forward under
six-element caches, and a speculative step under seven-element caches
(verify rows), at 1e-4 (float32 matmuls sum in another order in XLA and
PyTorch).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_infer_tpu as pit
from paddle_infer_tpu.core.tensor import Tensor as JT
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.models import GPT_PRESETS as J_PRESETS
from paddle_infer_tpu.models import GPTConfig as JConfig
from paddle_infer_tpu.models import GPTForCausalLM as JGPT
from paddle_infer_tpu.nn import functional as JF
from paddle_infer_tpu_torch.models import (GPT_PRESETS, GPTConfig,
                                           GPTForCausalLM)
from paddle_infer_tpu_torch.models.transformer_block import (
    ParallelMLP, ParallelTransformerLayer)
from paddle_infer_tpu_torch.nn.layers import Embedding
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
PAGE, MAX_PAGES = 8, 4
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


@pytest.fixture(scope="module")
def pair():
    pit.seed(0)
    jm = JGPT(JConfig(**TINY))
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu", seed=7)
    from_jax_state_dict(tm, sd)
    return jm, tm, sd


def test_presets_equal_jax():
    assert GPT_PRESETS == J_PRESETS
    cfg = GPTConfig.from_preset("gpt3-6.7b")
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size,
            cfg.vocab_size, cfg.max_position_embeddings) == (
        4096, 32, 16384, 50304, 2048)


def test_state_dict_round_trips_every_key(pair):
    _, tm, sd = pair
    got = tm.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_dense_logits_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(1).randint(0, 96, (2, 11)).astype(np.int32)
    want = jm(JT(jnp.asarray(ids))).numpy()
    with torch.inference_mode():
        got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lm_head_is_tied(pair):
    _, tm, _ = pair
    assert not any("lm_head" in k for k in tm.state_dict())
    ids = torch.tensor([[3, 1, 4, 1, 5]])
    with torch.inference_mode():
        hidden = tm.gpt(ids)
        assert torch.equal(tm(ids),
                           hidden @ tm.gpt.word_embeddings.weight.t())


def _pools(b, h, d, layers):
    p = b * MAX_PAGES + 1
    return [(np.zeros((p, h, PAGE, d), np.float32),
             np.zeros((p, h, PAGE, d), np.float32)) for _ in range(layers)]


def _paged_steps(jm, tm, steps, verify=None):
    """Run ``steps`` ([qlens per step]) through both models under the
    ragged paged caches; with ``verify = (rows, W)`` every step carries
    the seven-element cache.  Returns per-step (port, jax, valid)."""
    cfg = tm.config
    h = cfg.num_attention_heads
    d = cfg.hidden_size // h
    b, c = len(steps[0]), 12
    scratch = b * MAX_PAGES
    tables = np.arange(b * MAX_PAGES, dtype=np.int32).reshape(b, MAX_PAGES)
    pools = _pools(b, h, d, cfg.num_hidden_layers)
    jeng = JEngine(jm, page_size=PAGE)
    jk = [jnp.asarray(k) for k, _ in pools]
    jv = [jnp.asarray(v) for _, v in pools]
    tk = [torch.tensor(k) for k, _ in pools]
    tv = [torch.tensor(v) for _, v in pools]
    rs = np.random.RandomState(0)
    ctx = np.zeros(b, np.int32)
    extra_j, extra_t = (), ()
    if verify is not None:
        rows, w = verify
        spec2d = np.broadcast_to(np.asarray(rows)[:, None], (b, w))
        extra_j, extra_t = (jnp.asarray(spec2d),), (torch.tensor(spec2d),)
    out = []
    for qlens in steps:
        qlens = np.asarray(qlens, np.int32)
        ids = rs.randint(0, cfg.vocab_size, (b, c)).astype(np.int32)
        i2d = np.arange(c, dtype=np.int32)[None].repeat(b, 0)
        pos = np.where(i2d < qlens[:, None], ctx[:, None] + i2d, 0)
        jc = [(jk[i], jv[i], jnp.asarray(tables), jnp.asarray(ctx),
               jnp.asarray(qlens), jnp.asarray(scratch, jnp.int32))
              + extra_j for i in range(cfg.num_hidden_layers)]
        jl, jc = jeng._model_step(jeng._params, jnp.asarray(ids),
                                  jnp.asarray(pos), None, jc)
        jk = [x[0] for x in jc]
        jv = [x[1] for x in jc]
        tc = [(tk[i], tv[i], torch.tensor(tables), torch.tensor(ctx),
               torch.tensor(qlens), torch.tensor(scratch, dtype=torch.int32))
              + extra_t for i in range(cfg.num_hidden_layers)]
        with torch.inference_mode():
            tl, tc = tm(torch.tensor(ids), position_ids=torch.tensor(pos),
                        caches=tc)
        assert len(tc[0]) == 6 + len(extra_t)
        np.testing.assert_array_equal(tc[0][3].numpy(), ctx + qlens)
        valid = np.arange(c)[None] < qlens[:, None]
        out.append((tl.numpy(), np.asarray(jl), valid))
        ctx = ctx + qlens
    return out


def test_ragged_paged_forward_matches_jax(pair):
    """A prompt chunk, then decode steps, rows at different depths and
    an inactive row."""
    jm, tm, _ = pair
    steps = [[12, 5, 0]] + [[1, 1, 0]] * 3
    for got, want, valid in _paged_steps(jm, tm, steps):
        np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_speculative_step_matches_jax(pair):
    """Seven-element caches: rows 0 and 1 verify a window of 4 (after a
    prompt step), row 2 stays a plain decode row."""
    jm, tm, _ = pair
    steps = [[9, 6, 3], [4, 3, 1], [2, 4, 1]]
    for got, want, valid in _paged_steps(jm, tm, steps,
                                         verify=([True, True, False], 4)):
        np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_mlp_gelu_is_exact_erf():
    mlp = ParallelMLP(8, 16, device="cpu")
    x = torch.randn(3, 16)
    want = JF.gelu(JT(jnp.asarray(x.numpy()))).numpy()
    np.testing.assert_allclose(mlp.activation(x).numpy(), want,
                               atol=1e-6, rtol=1e-6)


def test_embedding_layer():
    emb = Embedding(10, 4, device="cpu")
    emb.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 3, 9]])
    np.testing.assert_array_equal(emb(ids)[0].numpy(),
                                  emb.weight[[0, 3, 9]].numpy())


def test_unported_block_forms_raise():
    with pytest.raises(NotImplementedError):
        ParallelTransformerLayer(8, 2, 16, num_experts=2, device="cpu")
    with pytest.raises(NotImplementedError):
        GPTForCausalLM(GPTConfig(**dict(TINY, num_experts=4)), device="cpu")
    with pytest.raises(ValueError):
        ParallelMLP(8, 16, activation="relu", device="cpu")


def test_model_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(GPTConfig(**TINY))
