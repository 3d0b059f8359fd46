"""Port parity: a trainable LLaMA and expert-parallel MoE training
against the JAX package.

* ``LlamaForCausalLM`` trains through ``FleetTrainStep`` (it raised
  ``StopIteration`` while its parameters were frozen): three fp32 AdamW
  steps of the shifted causal-LM loss on the JAX step's trajectory,
  losses within 1e-5 relative and parameters within 1e-5 of the JAX
  parameters' (MHA and GQA); the model starts in eval mode.
* A GPT-MoE at ep=2 (``[cpu] * 2``): the first step's gradients equal
  the JAX step's at ep=2 (its ``global_scatter`` / ``global_gather``
  differentiate through ``_a2a_grad``) within 2e-5 of each tensor's
  max-abs, the port's path through its own all-to-alls (one scatter and
  one gather per MoE layer), and three steps on JAX's losses within
  1e-5 relative.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu.models import LlamaConfig as JLlamaConfig
from paddle_infer_tpu.models import LlamaForCausalLM as JLlama
from paddle_infer_tpu.models import GPTMoEForCausalLM as JGPTMoE
from paddle_infer_tpu.models import MoEConfig as JMoEConfig
from paddle_infer_tpu.models.gpt import gpt_lm_loss as j_lm_loss
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import FleetTrainStep as JStep
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import topology as jtopo
from paddle_infer_tpu_torch import optimizer as topt
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.models import (GPTMoEForCausalLM, LlamaConfig,
                                           LlamaForCausalLM, MoEConfig,
                                           gpt_lm_loss)
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, fleet, topology)
from paddle_infer_tpu_torch.parallel import moe as tmoe
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import _pinned_globals

LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the suite runs files side by side, and these
    tiny shapes gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _reset():
    yield
    jtopo.set_current_mesh(None)
    jfleet._state.initialized = False
    jfleet._state.hcg = jfleet._state.strategy = None
    jtopo._CURRENT_HCG = None
    topology.set_hybrid_communicate_group(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


def _sd(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _strategies(n, **hc):
    js, ts = JStrategy(), DistributedStrategy()
    js.hybrid_configs = dict(js.hybrid_configs, **hc)
    ts.hybrid_configs = dict(ts.hybrid_configs, **hc)
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:n])
    fleet.init(strategy=ts, devices=["cpu"] * n)
    return js, ts


def _ids(vocab, b=4, s=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[:, :2] = -100
    return ids, labels


def _lm(jmodel_loss, tmodel_loss):
    return (lambda m, i, l: jmodel_loss(m(i), l),
            lambda m, i, l: tmodel_loss(m(i), l))


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_llama_three_fp32_steps_match_jax(kv):
    cfg = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=kv,
               intermediate_size=64, max_position_embeddings=64)
    with _pinned_globals():
        pit.seed(0)
        jm = JLlama(JLlamaConfig(**cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu",
                          keys=KeyStream(3))
    assert not tm.training
    assert all(p.requires_grad for p in tm.parameters())
    from_jax_state_dict(tm, _sd(jm))
    js, ts = _strategies(1)
    jl, tl = _lm(j_lm_loss, gpt_lm_loss)
    jstep = JStep(jm, jl, pit.optimizer.AdamW(learning_rate=LR,
                                              parameters=jm.parameters()),
                  strategy=js)
    tstep = FleetTrainStep(tm, tl, topt.AdamW(learning_rate=LR),
                           strategy=ts)
    assert set(tstep.params) == set(jstep.params)
    batch = _ids(96)
    for i in range(3):
        lj = float(jstep(*batch).numpy())
        lt = float(tstep(*batch))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
    for n, p in tstep.params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(jstep.params[n]))
        assert diff.max() <= 1e-5, (n, float(diff.max()))


DIMS = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)


def _moe_pair():
    with _pinned_globals():
        pit.seed(0)
        jm = JGPTMoE(JMoEConfig(num_experts=4, **DIMS))
    jm.train()
    tm = GPTMoEForCausalLM(MoEConfig(num_experts=4, **DIMS), device="cpu",
                           seed=9, keys=KeyStream(5))
    from_jax_state_dict(tm, _sd(jm))
    tm.train()
    return jm, tm


def _moe_losses():
    def jl(m, ids, labels):
        return j_lm_loss(m(ids), labels) + 0.01 * m.gpt.moe_aux_loss()

    def tl(m, ids, labels):
        return gpt_lm_loss(m(ids), labels) + 0.01 * m.moe_aux_loss()

    return jl, tl


def test_moe_ep2_grads_equal_jax(monkeypatch):
    import jax.numpy as jnp

    jm, tm = _moe_pair()
    js, ts = _strategies(2, ep_degree=2)
    jl, tl = _moe_losses()
    jstep = JStep(jm, jl, pit.optimizer.AdamW(learning_rate=LR),
                  strategy=js)
    tstep = FleetTrainStep(tm, tl, topt.AdamW(learning_rate=LR),
                           strategy=ts)
    assert tstep.param_specs["gpt.layers.0.mlp.w1"] == ("ep", None, None)
    calls = []
    for name in ("global_scatter", "global_gather"):
        real = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda x, _r=real, _n=name:
                            calls.append(_n) or _r(x))
    batch = _ids(96, b=4, s=24)
    pit.seed(7)
    key = pit.core.random.next_key()
    pure = jstep._pure_loss({})
    arrays = tuple(jnp.asarray(a) for a in batch)
    jg = jax.grad(lambda p: pure(p, jstep.buffers, key, arrays)[0])(
        jstep.params)
    tm.keys.seed(7)
    tkey = tstep.keys.next_key()
    tstep._loss(tkey, *(torch.tensor(a) for a in batch)).backward()
    assert calls.count("global_scatter") == DIMS["num_hidden_layers"]
    assert calls.count("global_gather") == DIMS["num_hidden_layers"]
    for n, p in tstep.params.items():
        want = np.asarray(jg[n])
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 2e-5 * scale, (n, err, scale)


def test_moe_ep2_three_steps_on_jax_losses():
    jm, tm = _moe_pair()
    js, ts = _strategies(2, ep_degree=2)
    jl, tl = _moe_losses()
    jstep = JStep(jm, jl, pit.optimizer.AdamW(learning_rate=LR),
                  strategy=js)
    tstep = FleetTrainStep(tm, tl, topt.AdamW(learning_rate=LR),
                           strategy=ts)
    pit.seed(7)
    tm.keys.seed(7)
    batch = _ids(96, b=4, s=24)
    for i in range(3):
        lj = float(jstep(*batch).numpy())
        lt = float(tstep(*batch))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
