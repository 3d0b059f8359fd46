"""Port parity: ``parallel/pipeline.py`` (``LayerDesc``,
``PipelineStack``) against the JAX package's pipeline on its forced
host devices, the twins of ``tests/test_pipeline.py``.

The stacked weights are the JAX stack's (``weights.py``), the inputs
numpy-seeded.  Outputs and gradients are within the reference test's
1e-5 (atol and rtol) of the port's sequential stack and within 1e-5 of
the JAX pipeline's max-abs (each framework rounds its products in its
own order); pp=2 x dp=2 x mp=2 trains through
``FleetTrainStep`` with the loss falling, on the JAX step's
trajectory within 1e-5 relative.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu.nn.layer import Layer as JLayer
from paddle_infer_tpu.parallel import LayerDesc as JDesc
from paddle_infer_tpu.parallel import PipelineStack as JStack
from paddle_infer_tpu.parallel import topology as jtopo
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.nn import functional as PF
from paddle_infer_tpu_torch.nn.layers import Linear
from paddle_infer_tpu_torch.optimizer import AdamW
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, LayerDesc,
                                             PipelineStack, fleet, topology)
from paddle_infer_tpu_torch.weights import from_jax_state_dict


class JBlock(JLayer):
    def __init__(self, hidden=16):
        super().__init__()
        from paddle_infer_tpu.nn.layers_common import Linear as JLinear

        self.fc = JLinear(hidden, hidden)

    def forward(self, x):
        from paddle_infer_tpu.nn import functional as F

        return x + F.gelu(self.fc(x))


class TBlock(torch.nn.Module):
    def __init__(self, hidden=16):
        super().__init__()
        self.fc = Linear(hidden, hidden, device="cpu")

    def forward(self, x):
        return x + PF.gelu(self.fc(x))


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
    topology.set_current_mesh(None)
    topology.set_hybrid_communicate_group(None)


def _x(b=8, s=4, h=16, seed=0):
    return np.random.RandomState(seed).randn(b, s, h).astype(np.float32)


def _pair(num_layers, micro_batches=1, interleave=1):
    js = JStack(JDesc(JBlock, 16), num_layers=num_layers,
                micro_batches=micro_batches, interleave=interleave)
    ts = PipelineStack(LayerDesc(TBlock, 16), num_layers=num_layers,
                       micro_batches=micro_batches, interleave=interleave)
    from_jax_state_dict(ts, {k: np.asarray(v.numpy())
                             for k, v in js.state_dict().items()})
    js.eval()
    ts.eval()
    return js, ts


def _jax_run(js, x, pp):
    prev = jtopo.get_current_mesh()
    if pp > 1:
        jtopo.set_current_mesh(jtopo.create_hybrid_mesh(
            pp=pp, devices=jax.devices()[:pp]))
    try:
        xs = pit.Tensor(x, stop_gradient=False)
        out = js(xs)
        out.sum().backward()
        return (out.numpy(), xs.grad.numpy(),
                {n: p.grad.numpy() for n, p in js.named_parameters()})
    finally:
        jtopo.set_current_mesh(prev)


def _port_run(ts, x, pp):
    if pp > 1:
        topology.set_current_mesh(topology.create_hybrid_mesh(
            pp=pp, devices=["cpu"] * pp))
    try:
        xs = torch.tensor(x, requires_grad=True)
        out = ts(xs)
        out.sum().backward()
        grads = {n: p.grad.numpy().copy() for n, p in ts.named_parameters()}
        for p in ts.parameters():
            p.grad = None
        return out.detach().numpy(), xs.grad.numpy(), grads
    finally:
        topology.set_current_mesh(None)


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _close_jax(a, b):
    """Across frameworks each product rounds in its own order: within
    1e-5 of the reference's max-abs."""
    err = float(np.abs(a - b).max())
    assert err <= 1e-5 * max(float(np.abs(b).max()), 1.0), err


def test_fallback_matches_jax_and_names():
    js, ts = _pair(4)
    assert set(ts.state_dict()) == set(js.state_dict())
    assert ts.fc__weight.dist_attr == ("pp", None, None)
    x = _x()
    for a, b in zip(_port_run(ts, x, 1)[:2], _jax_run(js, x, 1)[:2]):
        _close_jax(a, b)


def test_fallback_grads_match_jax():
    js, ts = _pair(4)
    x = _x(b=4)
    got, want = _port_run(ts, x, 1), _jax_run(js, x, 1)
    for n in want[2]:
        _close_jax(got[2][n], want[2][n])


@pytest.mark.parametrize("micro_batches,interleave", [
    (1, 1), (2, 1), (4, 1), (4, 2), (8, 2)])
def test_pipelined_outputs_and_grads_match_sequential(micro_batches,
                                                      interleave):
    """pp=4 against the port's sequential stack (itself on the JAX
    stack's values above): outputs, input gradients and every stacked
    weight's gradient."""
    _, ts = _pair(8, micro_batches, interleave)
    x = _x()
    seq = _port_run(ts, x, 1)
    got = _port_run(ts, x, 4)
    for a, b in zip(got[:2], seq[:2]):
        _close(a, b)
    for n in seq[2]:
        _close(got[2][n], seq[2][n])


def test_pipelined_matches_jax_pipeline():
    js, ts = _pair(4, micro_batches=2)
    x = _x(b=4)
    got, want = _port_run(ts, x, 4), _jax_run(js, x, 4)
    for a, b in zip(got[:2], want[:2]):
        _close_jax(a, b)


def test_recompute_grads_match():
    _, ts = _pair(4, micro_batches=2)
    x = _x(b=4)
    want = _port_run(ts, x, 4)
    ts.recompute = True
    got = _port_run(ts, x, 4)
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)
    for n in got[2]:
        _close(got[2][n], want[2][n])


def test_interleave_validation():
    _, ts = _pair(8, micro_batches=2, interleave=2)
    topology.set_current_mesh(topology.create_hybrid_mesh(
        pp=4, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="divisible by pp"):
        ts(torch.tensor(_x()))


def test_pipeline_in_fleet_train_step():
    """pp=2 x dp=2 x mp=2: three AdamW steps on the JAX step's losses,
    the loss falling over six."""
    from paddle_infer_tpu.nn.layers_common import Linear as JLinear
    from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
    from paddle_infer_tpu.parallel import FleetTrainStep as JStep
    from paddle_infer_tpu.parallel import fleet as jfleet

    class JModel(JLayer):
        def __init__(self):
            super().__init__()
            self.embed = JLinear(8, 16)
            self.stack = JStack(JDesc(JBlock, 16), num_layers=4,
                                micro_batches=2)
            self.head = JLinear(16, 8)

        def forward(self, x):
            return self.head(self.stack(self.embed(x)))

    class TModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = Linear(8, 16, device="cpu")
            self.stack = PipelineStack(LayerDesc(TBlock, 16), num_layers=4,
                                       micro_batches=2)
            self.head = Linear(16, 8, device="cpu")
            self.keys = KeyStream(0)

        def forward(self, x):
            return self.head(self.stack(self.embed(x)))

    def loss_fn(m, x, y):
        d = m(x) - y
        return (d * d).mean()

    js = JStrategy()
    js.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:8])
    try:
        jm = JModel()
        jm.eval()
        tm = TModel()
        from_jax_state_dict(tm, {k: np.asarray(v.numpy())
                                 for k, v in jm.state_dict().items()})
        tm.requires_grad_(True)
        tm.eval()
        st = DistributedStrategy()
        st.hybrid_configs = dict(st.hybrid_configs, dp_degree=2,
                                 mp_degree=2, pp_degree=2)
        fleet.init(strategy=st, devices=["cpu"] * 8)
        jstep = JStep(jm, loss_fn, pit.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters()), strategy=js)
        tstep = FleetTrainStep(tm, loss_fn, AdamW(learning_rate=1e-3))
        assert tstep.param_specs["stack.fc__weight"] == ("pp", None, None)
        rng = np.random.RandomState(0)
        x = rng.randn(8, 4, 8).astype(np.float32)
        y = rng.randn(8, 4, 8).astype(np.float32)
        losses = []
        for i in range(6):
            lt = float(tstep(x, y))
            if i < 3:
                lj = float(jstep(x, y).numpy())
                assert abs(lt - lj) <= 1e-5 * abs(lj), (i, lt, lj)
            losses.append(lt)
        assert losses[-1] < losses[0], losses
    finally:
        jfleet._state.initialized = False
        jfleet._state.hcg = jfleet._state.strategy = None
        jtopo._CURRENT_HCG = None


def test_transformer_stack_with_mp_inside_stages():
    """pp=2 x mp=2 over ``ParallelTransformerLayer`` blocks (the
    reference's ``TestTransformerPipeline``): each stage's layers run per
    mp shard on live slices of the stacked weights; outputs and gradients
    within 1e-5 of the sequential stack (rank-order partial sums add in
    another order)."""
    from paddle_infer_tpu_torch.models.transformer_block import \
        ParallelTransformerLayer
    from paddle_infer_tpu_torch.inference.generation import Placement

    stack = PipelineStack(LayerDesc(ParallelTransformerLayer, 32, 2, 64,
                                    dropout=0.0, causal=True,
                                    normalize_before=True, device="cpu"),
                          num_layers=4, micro_batches=2)
    stack.eval()
    x = _x(b=4, s=8, h=32, seed=5)
    co = np.random.RandomState(6).randn(4, 8, 32).astype(np.float32)

    def run():
        xs = torch.tensor(x, requires_grad=True)
        out = stack(xs)
        (out * torch.tensor(co)).sum().backward()
        grads = {n: p.grad.numpy().copy() for n, p in stack.named_parameters()}
        for p in stack.parameters():
            p.grad = None
        return out.detach().numpy(), xs.grad.numpy(), grads

    want = run()
    mesh = topology.create_hybrid_mesh(pp=2, mp=2, devices=["cpu"] * 4)
    placement = Placement(stack, mesh, live=True)
    assert placement.get(stack._template.self_attn.qkv_proj).n == 2
    topology.set_current_mesh(mesh, placement)
    got = run()
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)
    for n in want[2]:
        _close(got[2][n], want[2][n])
