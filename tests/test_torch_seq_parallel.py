"""Port parity: ``parallel/sequence_parallel.py`` (ring and Ulysses
attention over ``sep``) against the JAX package on its forced host
devices, the twins of ``tests/test_sequence_parallel.py``.

Inputs are numpy-seeded; outputs and the gradients of q, k and v are
held to the JAX functions and their VJPs within 1e-5 (atol and rtol),
and to the port's unsplit plain attention the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from paddle_infer_tpu.parallel import ring_attention as jring
from paddle_infer_tpu.parallel import ulysses_attention as julysses
from paddle_infer_tpu_torch.ops.attention import _xla_sdpa
from paddle_infer_tpu_torch.parallel import (ring_attention, topology,
                                             ulysses_attention)


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
    topology.set_current_mesh(None)


def _make(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, s, h, d) * 0.5).astype(np.float32)
            for _ in range(3)]


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _jax(fn, arrs, n, causal, co):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sep",))
    spec = P(None, "sep", None, None)

    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, is_causal=causal, spec=spec)
        return jnp.sum(out * co), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in arrs))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(fn, arrs, n, causal, co):
    mesh = topology.create_hybrid_mesh(sep=n, devices=["cpu"] * n)
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    out = fn(*ts, mesh=mesh, is_causal=causal)
    (out * torch.tensor(co)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_grads_match_jax(kind, causal):
    arrs = _make(1, 32, 4, 16, seed=1 + causal)
    co = np.random.RandomState(5).randn(*arrs[0].shape).astype(np.float32)
    fns = {"ring": (ring_attention, jring),
           "ulysses": (ulysses_attention, julysses)}[kind]
    out, grads = _port(fns[0], arrs, 4, causal, co)
    jout, jgrads = _jax(fns[1], arrs, 4, causal, co)
    _close(out, jout)
    for a, b in zip(grads, jgrads):
        _close(a, b)
    ts = [torch.tensor(a) for a in arrs]
    _close(out, _xla_sdpa(*ts, None, None, 0.0, causal, None).numpy())


def test_hybrid_mesh_ring():
    """dp=2 x sep=2 x mp=2: only sep splits the sequence; the result is
    the unsplit attention's."""
    mesh = topology.create_hybrid_mesh(dp=2, sep=2, mp=2,
                                       devices=["cpu"] * 8)
    arrs = [torch.tensor(a) for a in _make(4, 32, 4, 16)]
    out = ring_attention(*arrs, mesh=mesh, is_causal=True)
    _close(out.numpy(), _xla_sdpa(*arrs, None, None, 0.0, True,
                                  None).numpy())


def test_ulysses_heads_must_divide():
    mesh = topology.create_hybrid_mesh(sep=4, devices=["cpu"] * 4)
    arrs = [torch.tensor(a) for a in _make(1, 16, 2, 8)]
    with pytest.raises(ValueError, match="not divisible by sep"):
        ulysses_attention(*arrs, mesh=mesh)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_layer_integration(kind):
    """``ParallelSelfAttention(seq_parallel=...)`` under an sep=4 mesh:
    output and the QKV weight's gradient equal to the unsplit port layer
    on the JAX layer's weights (whose plain output the port's parity
    tests hold), and the ring layer's output equal to the JAX layer's
    under its mesh."""
    import paddle_infer_tpu as pit
    from paddle_infer_tpu.models.transformer_block import \
        ParallelSelfAttention as JAttn
    from paddle_infer_tpu.parallel import topology as jtopo
    from paddle_infer_tpu_torch.models.transformer_block import \
        ParallelSelfAttention
    from paddle_infer_tpu_torch.weights import from_jax_state_dict

    ja = JAttn(32, 4, causal=True, seq_parallel=kind)
    state = {k: np.asarray(v.numpy()) for k, v in ja.state_dict().items()}
    x = np.random.RandomState(7).randn(1, 32, 32).astype(np.float32)

    def port(seq_parallel):
        ta = ParallelSelfAttention(32, 4, causal=True, device="cpu",
                                   seq_parallel=seq_parallel)
        from_jax_state_dict(ta, state)
        ta.requires_grad_(True)
        out = ta(torch.tensor(x))
        out.sum().backward()
        return out.detach().numpy(), ta.qkv_proj.weight.grad.numpy()

    want, wgrad = port(None)
    topology.set_current_mesh(topology.create_hybrid_mesh(
        sep=4, devices=["cpu"] * 4))
    out, grad = port(kind)
    _close(out, want)
    _close(grad, wgrad)
    if kind == "ring":
        jtopo.set_current_mesh(jtopo.create_hybrid_mesh(
            sep=4, devices=jax.devices()[:4]))
        try:
            _close(out, ja(pit.Tensor(x)).numpy())
        finally:
            jtopo.set_current_mesh(None)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_fleet_train_step_at_sep4_on_jax_trajectory(kind):
    """A ``seq_parallel`` attention layer trained through
    ``FleetTrainStep`` at sep=4: three SGD steps with parameters within
    1e-5 of the JAX step's at sep=4 (and losses within 1e-5 relative)."""
    import paddle_infer_tpu as pit
    from paddle_infer_tpu.core.tensor import Tensor as JT  # noqa: F401
    from paddle_infer_tpu.models.transformer_block import \
        ParallelSelfAttention as JAttn
    from paddle_infer_tpu.nn.layer import Layer as JLayer
    from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
    from paddle_infer_tpu.parallel import FleetTrainStep as JStep
    from paddle_infer_tpu.parallel import fleet as jfleet
    from paddle_infer_tpu.parallel import topology as jtopo
    from paddle_infer_tpu_torch.core.random import KeyStream
    from paddle_infer_tpu_torch.models.transformer_block import \
        ParallelSelfAttention
    from paddle_infer_tpu_torch.optimizer import SGD
    from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                                 FleetTrainStep, fleet)
    from paddle_infer_tpu_torch.weights import from_jax_state_dict

    class JM(JLayer):
        def __init__(self):
            super().__init__()
            self.attn = JAttn(32, 4, causal=True, seq_parallel=kind)

        def forward(self, x):
            return self.attn(x)

    class TM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = ParallelSelfAttention(32, 4, causal=True,
                                              seq_parallel=kind,
                                              device="cpu")
            self.keys = KeyStream(0)

        def forward(self, x):
            return self.attn(x)

    def loss_fn(m, x, y):
        d = m(x) - y
        return (d * d).mean()

    pit.seed(2)
    jm = JM()
    tm = TM()
    from_jax_state_dict(tm, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    tm.requires_grad_(True)
    js, ts = JStrategy(), DistributedStrategy()
    js.hybrid_configs = dict(js.hybrid_configs, sep_degree=4)
    ts.hybrid_configs = dict(ts.hybrid_configs, sep_degree=4)
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:4])
    try:
        fleet.init(strategy=ts, devices=["cpu"] * 4)
        jstep = JStep(jm, loss_fn, pit.optimizer.SGD(
            learning_rate=0.5, parameters=jm.parameters()), strategy=js)
        tstep = FleetTrainStep(tm, loss_fn, SGD(learning_rate=0.5))
        rng = np.random.RandomState(3)
        x = rng.randn(2, 32, 32).astype(np.float32)
        y = rng.randn(2, 32, 32).astype(np.float32)
        for i in range(3):
            lj = float(jstep(x, y).numpy())
            lt = float(tstep(x, y))
            assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
        for n, p in tstep.params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstep.params[n]),
                                       atol=1e-5, rtol=1e-5, err_msg=n)
    finally:
        jtopo.set_current_mesh(None)
        jtopo._CURRENT_HCG = None
        jfleet._state.initialized = False
        jfleet._state.hcg = jfleet._state.strategy = None
        topology.set_hybrid_communicate_group(None)
        fleet._state.hcg = fleet._state.strategy = fleet._state.device = None
