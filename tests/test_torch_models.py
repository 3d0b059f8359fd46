"""Port parity: the tiny LLaMA of tests/test_llama.py (vocab 96, hidden
32, 2 layers, 4 heads, ffn 64, 64 positions; MHA and a 2-KV-head GQA
variant) through the ragged paged forward of ``paddle_infer_tpu_torch``
against the JAX model under the same six-element caches, weights carried
over by ``from_jax_state_dict``.

Logit tolerance 1e-4: float32 matmuls sum in another order in XLA and
PyTorch.  Ops with no reduction (RoPE) are held at 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_infer_tpu as pit
from paddle_infer_tpu.core.dispatch import dispatch as JD
from paddle_infer_tpu.core.tensor import Tensor as JT
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.models import LlamaConfig as JConfig
from paddle_infer_tpu.models import LlamaForCausalLM as JLlama
from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_infer_tpu_torch.nn.layers import LayerNorm, RMSNorm
from paddle_infer_tpu_torch.ops.attention import rope
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
PAGE, MAX_PAGES = 8, 4


def _pair(**kw):
    cfg = dict(TINY, **kw)
    pit.seed(0)
    jm = JLlama(JConfig(**cfg))
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=7)
    from_jax_state_dict(tm, sd)
    return jm, tm, sd


@pytest.fixture(scope="module", params=["mha", "gqa"])
def pair(request):
    return _pair(**({"num_key_value_heads": 2}
                    if request.param == "gqa" else {}))


def test_from_jax_state_dict_round_trips_every_key(pair):
    _, tm, sd = pair
    got = tm.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_from_jax_state_dict_rejects_mismatches(pair):
    _, tm, sd = pair
    missing = dict(sd)
    missing.pop("lm_head.weight")
    with pytest.raises(KeyError):
        from_jax_state_dict(tm, missing)
    with pytest.raises(KeyError):
        from_jax_state_dict(tm, dict(sd, extra=np.zeros(1, np.float32)))
    bad = dict(sd)
    bad["llama.norm.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        from_jax_state_dict(tm, bad)


def test_bf16_load_casts_on_the_target_dtype(pair):
    _, tm32, sd = pair
    tm = LlamaForCausalLM(tm32.config, device="cpu", dtype=torch.bfloat16)
    from_jax_state_dict(tm, sd)
    for k, t in tm.state_dict().items():
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
        np.testing.assert_array_equal(
            t.float().numpy(),
            torch.tensor(sd[k]).to(torch.bfloat16).float().numpy())


def _caches_np(b, h, d, layers):
    p = b * MAX_PAGES + 1
    return [(np.zeros((p, h, PAGE, d), np.float32),
             np.zeros((p, h, PAGE, d), np.float32)) for _ in range(layers)]


def test_ragged_paged_forward_matches_jax(pair):
    """One prefill-chunk step, then three decode steps, for a 2-row
    batch with rows at different depths (plus an inactive third row)."""
    jm, tm, _ = pair
    cfg = tm.config
    h = cfg.num_attention_heads
    d = cfg.hidden_size // h
    b, c = 3, 12
    scratch = b * MAX_PAGES
    tables = np.arange(b * MAX_PAGES, dtype=np.int32).reshape(b, MAX_PAGES)
    tables[2] = scratch
    pools = _caches_np(b, h, d, cfg.num_hidden_layers)
    jeng = JEngine(jm, page_size=PAGE)
    jk = [jnp.asarray(k) for k, _ in pools]
    jv = [jnp.asarray(v) for _, v in pools]
    tk = [torch.tensor(k) for k, _ in pools]
    tv = [torch.tensor(v) for _, v in pools]
    rs = np.random.RandomState(0)
    ctx = np.zeros(b, np.int32)
    steps = [np.asarray([12, 5, 0], np.int32)] + \
        [np.asarray([1, 1, 0], np.int32)] * 3
    for qlens in steps:
        ids = rs.randint(0, cfg.vocab_size, (b, c)).astype(np.int32)
        i2d = np.arange(c, dtype=np.int32)[None].repeat(b, 0)
        pos = np.where(i2d < qlens[:, None], ctx[:, None] + i2d, 0)
        jc = [(jk[i], jv[i], jnp.asarray(tables), jnp.asarray(ctx),
               jnp.asarray(qlens), jnp.asarray(scratch, jnp.int32))
              for i in range(cfg.num_hidden_layers)]
        jl, jc = jeng._model_step(jeng._params, jnp.asarray(ids),
                                  jnp.asarray(pos), None, jc)
        jk = [x[0] for x in jc]
        jv = [x[1] for x in jc]
        tc = [(tk[i], tv[i], torch.tensor(tables), torch.tensor(ctx),
               torch.tensor(qlens), torch.tensor(scratch, dtype=torch.int32))
              for i in range(cfg.num_hidden_layers)]
        with torch.inference_mode():
            tl, tc = tm(torch.tensor(ids), position_ids=torch.tensor(pos),
                        caches=tc)
        valid = np.arange(c)[None] < qlens[:, None]
        np.testing.assert_allclose(tl.numpy()[valid],
                                   np.asarray(jl)[valid], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tc[0][3].numpy(), ctx + qlens)
        ctx = ctx + qlens
    # the pools the two paths wrote agree on every live page
    live = tables[:2].reshape(-1)
    for i in range(cfg.num_hidden_layers):
        np.testing.assert_allclose(tk[i].numpy()[live],
                                   np.asarray(jk[i])[live], atol=1e-5)


def test_dense_forward_matches_jax(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(1).randint(0, 96, (2, 9)).astype(np.int32)
    want = jm(JT(jnp.asarray(ids))).numpy()
    with torch.inference_mode():
        got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_rope_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 3, 8).astype(np.float32)
    pos = rs.randint(0, 60, (2, 5)).astype(np.int32)
    want = JD("rope", JT(jnp.asarray(x)), JT(jnp.asarray(pos)),
              theta=10000.0).numpy()
    got = rope(torch.tensor(x), torch.tensor(pos), theta=10000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_norms_match_jax():
    from paddle_infer_tpu.nn import functional as JF

    rs = np.random.RandomState(3)
    x = rs.randn(4, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32)
    bias = rs.randn(16).astype(np.float32)
    rms = RMSNorm(16, epsilon=1e-6, device="cpu")
    rms.weight.data = torch.tensor(w)
    want = JF.rms_norm(JT(jnp.asarray(x)), JT(jnp.asarray(w)), 1e-6).numpy()
    np.testing.assert_allclose(rms(torch.tensor(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    ln = LayerNorm(16, epsilon=1e-5, device="cpu")
    ln.weight.data = torch.tensor(w)
    ln.bias.data = torch.tensor(bias)
    want = JF.layer_norm(JT(jnp.asarray(x)), (16,), JT(jnp.asarray(w)),
                         JT(jnp.asarray(bias)), 1e-5).numpy()
    np.testing.assert_allclose(ln(torch.tensor(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_model_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig(**TINY))


def test_unported_cache_arities_raise(pair):
    """The five-tuple windowed prefill cache and the reference's growing
    two-tuple cache are not ported (three, four and six to eight are)."""
    _, tm, _ = pair
    attn = tm.llama.layers[0].self_attn
    x = torch.zeros(1, 1, 32)
    for n in (5, 2):
        with pytest.raises(NotImplementedError):
            attn(x, cache=(None,) * n)
