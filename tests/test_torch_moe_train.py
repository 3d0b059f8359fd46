"""Port parity: Mixture-of-Experts training and the GPT training path
(``paddle_infer_tpu_torch/parallel/moe.py``, ``models/gpt.py``,
``parallel/fleet.py``) against the JAX package.

* ``fused_moe``'s gradients (input, gate, ``w1``, ``b1``, ``w2``,
  ``b2``, through the output and the ``l_aux`` term) equal the JAX
  ``fused_moe`` VJP within 2e-5 of each gradient's max-abs, for switch,
  gshard (with and without drops) and naive (top-2 and top-3); the
  reference's ``test_aux_loss_set_and_differentiable`` and
  ``test_moe_trains`` on the port.
* ``FleetTrainStep`` takes a GPT and a GPT-MoE (it raised
  ``StopIteration`` before: their parameters were frozen) and updates the
  parameters the JAX step updates; three fp32 steps with dropout on JAX's
  trajectory (losses within 1e-5 relative, parameters within 1e-5, or 3
  x LR where a gradient sat at rounding level), the GPT-MoE's loss with
  ``0.01 * moe_aux_loss()``; the aux loss stays differentiable.
* A serving step of a model whose parameters require grad records no
  autograd graph: the ragged ``EngineCore``, the paged and dense
  ``generate`` and ``SpeculativeEngine``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_infer_tpu as pit
from paddle_infer_tpu.core.dispatch import dispatch as JD
from paddle_infer_tpu.core.tensor import Tensor as JT
from paddle_infer_tpu.models import GPTConfig as JGPTConfig
from paddle_infer_tpu.models import GPTForCausalLM as JGPT
from paddle_infer_tpu.models import GPTMoEForCausalLM as JGPTMoE
from paddle_infer_tpu.models import MoEConfig as JMoEConfig
from paddle_infer_tpu.models.gpt import gpt_lm_loss as j_lm_loss
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import FleetTrainStep as JStep
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import moe as jmoe
from paddle_infer_tpu_torch import optimizer as topt
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, GenerationEngine, PagedGenerationEngine)
from paddle_infer_tpu_torch.inference.speculative import SpeculativeEngine
from paddle_infer_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                           GPTMoEForCausalLM, MoEConfig,
                                           gpt_lm_loss)
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, fleet)
from paddle_infer_tpu_torch.parallel import moe as tmoe
from paddle_infer_tpu_torch.serving.engine_core import EngineCore
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import _pinned_globals

DIMS = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
LR = 1e-3
AUX = 0.01


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


# ------------------------------------------------------------ the layer

GRAD_CASES = [("switch", 1, 2.0), ("gshard", 2, 2.0), ("gshard", 2, 0.25),
              ("naive", 2, 1.0), ("naive", 3, 0.5)]


@pytest.mark.parametrize("gate,k,cf", GRAD_CASES,
                         ids=[f"{g}{k}-cf{c}" for g, k, c in GRAD_CASES])
def test_fused_moe_grads_equal_jax_vjp(gate, k, cf):
    rng = np.random.RandomState(0)
    d, f, e = 16, 32, 4
    ws = [rng.randn(d, e), rng.randn(e, d, f) * 0.2, rng.randn(e, f) * 0.1,
          rng.randn(e, f, d) * 0.2, rng.randn(e, d) * 0.1]
    ws = [w.astype(np.float32) for w in ws]
    x = rng.randn(2, 12, d).astype(np.float32)
    ct = rng.randn(2, 12, d).astype(np.float32)

    def objective(x, gw, w1, b1, w2, b2):
        out, aux = jmoe._fused_moe_impl(x, gw, w1, b1, w2, b2, gate=gate,
                                        top_k=k, capacity_factor=cf)
        return jnp.sum(out * ct) + 0.37 * aux

    want = jax.grad(objective, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in [x] + ws])
    got = [torch.tensor(a, requires_grad=True) for a in [x] + ws]
    out, aux = tmoe.fused_moe(*got, gate=gate, top_k=k, capacity_factor=cf)
    (torch.sum(out * torch.tensor(ct)) + 0.37 * aux).backward()
    for name, w, t in zip(("x", "gate_weight", "w1", "b1", "w2", "b2"),
                          want, got):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=2e-5 * scale, err_msg=name)


def _layer(gate="gshard", seed=3, cf=8.0):
    """A trainable port layer with the JAX layer's weights."""
    with _pinned_globals():
        pit.seed(seed)
        jl = jmoe.MoELayer(16, 32, 4, gate=gate, capacity_factor=cf)
    tl = tmoe.MoELayer(16, 32, 4, gate=gate, capacity_factor=cf,
                       device="cpu")
    from_jax_state_dict(tl, {n: np.asarray(v.numpy())
                             for n, v in jl.state_dict().items()})
    return jl, tl.requires_grad_(True)


def test_aux_loss_set_and_differentiable():
    """``tests/test_moe.py:102`` on the port, and the gate gradient of
    ``mean(out) + l_aux`` equal to JAX's."""
    jl, tl = _layer(gate="switch")
    x = np.random.RandomState(6).randn(2, 4, 16).astype(np.float32)
    out = tl(torch.tensor(x))
    assert tl.l_aux is not None and float(tl.l_aux.detach()) > 0
    (out.mean() + tl.l_aux).backward()
    g = tl.gate_weight.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    jx = JT(jnp.asarray(x), stop_gradient=False)
    (JD("mean", jl(jx)) + jl.l_aux).backward()
    np.testing.assert_allclose(g, jl.gate_weight.grad.numpy(), rtol=0,
                               atol=2e-5 * np.abs(g).max())


def test_moe_trains():
    """``tests/test_moe.py:114`` on the port: 25 AdamW steps of a gshard
    layer and a linear head on ``cross_entropy + 0.01 * l_aux``."""
    from paddle_infer_tpu_torch.nn import Linear
    from paddle_infer_tpu_torch.nn import functional as PF

    _, lay = _layer(seed=7, cf=4.0)
    head = Linear(16, 4, device="cpu")
    head.reset_parameters(torch.Generator().manual_seed(7))
    head.requires_grad_(True)
    opt = topt.AdamW(learning_rate=1e-2, parameters=list(
        lay.parameters()) + list(head.parameters()))
    rng = np.random.RandomState(8)
    x = torch.tensor(rng.randn(64, 4, 16).astype(np.float32))
    y = torch.tensor(rng.randint(0, 4, (64, 4)).astype(np.int64))
    losses = []
    for _ in range(25):
        out = head(lay(x))
        loss = PF.cross_entropy(out.reshape(-1, 4), y.reshape(-1)) \
            + 0.01 * lay.l_aux
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses[::8]


# ------------------------------------------------------------- the step

def _jax_model(moe, **over):
    with _pinned_globals():
        pit.seed(0)
        if moe:
            m = JGPTMoE(JMoEConfig(num_experts=4, **dict(DIMS, **over)))
        else:
            m = JGPT(JGPTConfig(**dict(DIMS, **over)))
    m.train()
    return m


def _port_model(jm, moe, **over):
    cls, cfg = (GPTMoEForCausalLM, MoEConfig(num_experts=4,
                                             **dict(DIMS, **over))) \
        if moe else (GPTForCausalLM, GPTConfig(**dict(DIMS, **over)))
    tm = cls(cfg, device="cpu", seed=9, keys=KeyStream(5))
    from_jax_state_dict(tm, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    tm.train()
    return tm


def _losses(moe):
    """(JAX loss_fn, port loss_fn): the causal-LM loss, plus ``AUX x``
    the aux loss for a GPT-MoE."""
    def jl(m, ids, labels):
        loss = j_lm_loss(m(ids), labels)
        return loss + AUX * m.gpt.moe_aux_loss() if moe else loss

    def tl(m, ids, labels):
        loss = gpt_lm_loss(m(ids), labels)
        return loss + AUX * m.moe_aux_loss() if moe else loss

    return jl, tl


def _steps(moe):
    jm = _jax_model(moe)
    tm = _port_model(jm, moe)
    js, ts = JStrategy(), DistributedStrategy()
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:1])
    fleet.init(strategy=ts, devices=["cpu"])
    jloss, tloss = _losses(moe)
    jstep = JStep(jm, jloss, pit.optimizer.AdamW(learning_rate=LR),
                  strategy=js)
    tstep = FleetTrainStep(tm, tloss, topt.AdamW(learning_rate=LR),
                           strategy=ts)
    pit.seed(7)
    tm.keys.seed(7)
    return jstep, tstep


def _batch(b=4, s=24, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, DIMS["vocab_size"], (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    return ids, labels


@pytest.mark.parametrize("moe", [False, True], ids=["gpt", "gpt_moe"])
def test_fleet_step_trains_what_jax_trains(moe):
    """The fault repaired: ``FleetTrainStep`` over a GPT or a GPT-MoE
    takes every parameter and one step moves the same ones JAX's moves
    (every expert and gate tensor of the GPT-MoE among them)."""
    jstep, tstep = _steps(moe)
    jm = jstep.model
    assert set(tstep.params) == {n for n, p in jm.named_parameters()
                                 if not p.stop_gradient}
    before = {n: p.detach().clone() for n, p in tstep.params.items()}
    jbefore = {n: np.asarray(v) for n, v in jstep.params.items()}
    batch = _batch()
    jstep(*batch)
    tstep(*batch)
    moved = {n for n, p in tstep.params.items()
             if not torch.equal(p.detach(), before[n])}
    jmoved = {n for n, v in jstep.params.items()
              if not np.array_equal(np.asarray(v), jbefore[n])}
    assert moved == jmoved == set(tstep.params)
    if moe:
        experts = [n for n in moved if n.rsplit(".", 1)[-1] in
                   ("gate_weight", "w1", "b1", "w2", "b2")]
        assert len(experts) == 5 * DIMS["num_hidden_layers"]


@pytest.mark.parametrize("moe", [False, True], ids=["gpt", "gpt_moe"])
def test_three_fp32_steps_match_jax(moe):
    """Losses within 1e-5 relative at every step, dropout 0.1 on both
    sides from the same keys; parameters after three steps within 1e-5,
    except elements whose gradient at some step lay within 1e-5 of the
    tensor's max-abs of zero (the key third of each ``qkv_proj.bias``
    among them): at rounding level in both runs, Adam moves such an
    element by up to the rate per step either way, so those agree within
    ``3 * LR``, as ``tests/test_torch_train_recipe.py`` holds them."""
    jstep, tstep = _steps(moe)
    batch = _batch()
    tiny = {n: torch.zeros_like(p, dtype=torch.bool)
            for n, p in tstep.params.items()}
    for i in range(3):
        lj = float(jstep(*batch).numpy())
        lt = float(tstep(*batch))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
        for n, p in tstep.params.items():
            g = p.grad.abs()
            tiny[n] |= g <= 1e-5 * g.max()
    for n, p in tstep.params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(jstep.params[n]))
        t = tiny[n].numpy()
        assert diff[t].max(initial=0.0) <= 3 * LR, n
        assert diff[~t].max(initial=0.0) <= 1e-5, (n, float(diff.max()))


def test_moe_aux_loss_is_differentiable():
    """``moe_aux_loss()`` of the last forward reaches every gate weight;
    the last layer's experts come after its gate, so they get none."""
    jm = _jax_model(True, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    tm = _port_model(jm, True, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    ids, _ = _batch()
    tm(torch.tensor(ids))
    aux = tm.moe_aux_loss()
    assert aux.requires_grad and float(aux.detach()) > 0
    aux.backward()
    last = f"gpt.layers.{DIMS['num_hidden_layers'] - 1}.mlp."
    for n, p in tm.named_parameters():
        if n.endswith("gate_weight"):
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, n
        elif n.startswith(last):
            assert p.grad is None or float(p.grad.abs().sum()) == 0, n


def test_forward_lets_the_last_aux_graph_go_first():
    """A GPT-MoE forward drops the last forward's aux losses, and with
    them that forward's autograd graph, before it reads a parameter: a
    CUDA graph captured after an eager warm-up then makes its own
    gradient accumulators instead of reusing the warm-up's."""
    import weakref

    tm = GPTMoEForCausalLM(MoEConfig(num_experts=4, **DIMS), device="cpu",
                           seed=3)
    tm.train()
    ids = torch.tensor(_batch()[0])
    tm(ids)
    last = [weakref.ref(layer.mlp.l_aux) for layer in tm.gpt.layers]
    assert all(r() is not None and r().grad_fn is not None for r in last)
    seen = []
    hook = tm.gpt.word_embeddings.register_forward_pre_hook(
        lambda mod, args: seen.append([r() is None for r in last]))
    try:
        aux = tm(ids) is not None and tm.moe_aux_loss()
    finally:
        hook.remove()
    assert seen == [[True] * len(last)]
    assert aux.requires_grad and float(aux.detach()) > 0


# ---------------------------------------------------------- no recording

class _Saved:
    """Counts the tensors autograd saves for a backward."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        def pack(t):
            self.n += 1
            return t

        self._ctx = torch.autograd.graph.saved_tensors_hooks(pack,
                                                             lambda t: t)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


@pytest.mark.parametrize("moe", [False, True], ids=["gpt", "gpt_moe"])
def test_serving_records_no_autograd(moe):
    """Parameters that require grad (a training model) do not make the
    serving paths record: the ragged core's mixed steps, paged and dense
    ``generate`` and ``SpeculativeEngine`` save no tensor for a backward
    and return nothing that requires grad."""
    cls, cfg = (GPTMoEForCausalLM, MoEConfig(num_experts=4, **DIMS)) \
        if moe else (GPTForCausalLM, GPTConfig(**DIMS))
    model = cls(cfg, device="cpu", seed=3)
    assert all(p.requires_grad for p in model.parameters())
    ids = np.random.RandomState(1).randint(0, 96, (2, 9)).astype(np.int64)
    g = GenerationConfig(max_new_tokens=4)
    with _Saved() as saved:
        paged = PagedGenerationEngine(model, page_size=8, device="cpu")
        out = paged.generate(ids, g)
        dense = GenerationEngine(model, device="cpu").generate(ids, g)
        spec = SpeculativeEngine(model, model, num_draft_tokens=2,
                                 device="cpu").generate(ids, g)
        core = EngineCore(PagedGenerationEngine(
            cls(cfg, device="cpu", seed=3), page_size=8, device="cpu"),
            device="cpu")
        reqs = [core.submit(row, g)[0] for row in ids]
        while not all(r.done for r in reqs):
            core.run_once()
    assert saved.n == 0
    for o in (out, dense, spec):
        o = o[0] if isinstance(o, tuple) else o
        assert not (isinstance(o, torch.Tensor) and o.requires_grad)
    assert all(len(r.tokens) == 4 for r in reqs)


def test_chip_smoke_moe_train_phase_on_cpu(monkeypatch):
    """``chip_smoke``'s ``[moe_train]`` phase at a tiny GPT-MoE on the
    CPU: the eager twin of the (here also eager) graph run EQUAL in
    losses and parameters, one first call, every gate and expert tensor
    moved, the aux loss above 0."""
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    res = chip_smoke.moe_train_phase(
        torch.device("cpu"), "cpu",
        config=MoEConfig(num_experts=4, **DIMS), batch=2, seq=16)
    assert res["launches"] == {"flash_fwd": 0, "flash_dkdv": 0,
                               "flash_dq": 0}
