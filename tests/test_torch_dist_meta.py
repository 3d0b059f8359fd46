"""Port parity: the data-parallel meta-optimizers against the JAX
package (``parallel/meta_optimizers.py``).

* ``dgc_compress``: ``g_send``, ``u``, ``v`` and the sent fraction EQUAL
  to JAX's, active and in rampup, at several sizes and sparsities, one
  of more than 2**24 + 1 elements where ``q * (n - 1)`` rounds in
  float32 (the threshold's order statistic is then not the one a float64
  index picks, and ``torch.quantile`` refuses the size).
* LocalSGD at ``k_steps=1`` equals synchronous SGD through
  ``FleetTrainStep``; at ``k_steps=4`` six fp32 steps of a tiny ERNIE
  over two replicas (momentum SGD) follow JAX's ``LocalSGDTrainStep``
  trajectory at 1e-5 (losses relative, replica parameters absolute), at
  dropout 0 and 0.1; replicas equal after each sync step and apart
  between.
* ``DGCTrainStep`` follows JAX's trajectory across the rampup step.
* ``distributed_train_step`` routes as JAX's and raises its errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu import nn as jnn
from paddle_infer_tpu.models import ErnieConfig as JErnieConfig
from paddle_infer_tpu.models import ErnieForPretraining as JErnie
from paddle_infer_tpu.models.ernie import ernie_pretrain_loss as j_loss
from paddle_infer_tpu.parallel import DGCTrainStep as JDGC
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import LocalSGDTrainStep as JLocal
from paddle_infer_tpu.parallel import dgc_compress as j_dgc
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import topology as jtopo
from paddle_infer_tpu.core.tensor import Tensor
from paddle_infer_tpu_torch import nn as tnn
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.models.ernie import (ErnieConfig,
                                                 ErnieForPretraining,
                                                 ernie_pretrain_loss)
from paddle_infer_tpu_torch.optimizer import SGD, AdamW, Momentum
from paddle_infer_tpu_torch.optimizer.clip import (ClipGradByGlobalNorm,
                                                   ClipGradByNorm)
from paddle_infer_tpu_torch.parallel import (DGCTrainStep,
                                             DistributedStrategy,
                                             FleetTrainStep,
                                             LocalSGDTrainStep,
                                             dgc_compress,
                                             distributed_train_step, fleet,
                                             topology)
from paddle_infer_tpu_torch.parallel.meta_optimizers import quantile_points
from paddle_infer_tpu_torch.weights import from_jax_state_dict

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=64)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
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


def _init(dp):
    js, ts = JStrategy(), DistributedStrategy()
    js.hybrid_configs = {"dp_degree": dp}
    ts.hybrid_configs = dict(ts.hybrid_configs, dp_degree=dp)
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:dp])
    fleet.init(strategy=ts, devices=["cpu"] * dp)
    return js, ts


# ------------------------------------------------------------ dgc_compress

@pytest.mark.parametrize("n,sparsity", [(32, 0.75), (1000, 0.999),
                                         (4099, 0.9), (12345, 0.5)])
def test_dgc_compress_equals_jax(n, sparsity):
    rng = np.random.RandomState(n)
    g, u, v = (rng.randn(n).astype(np.float32) for _ in range(3))
    v[::5] = v[0]                                  # ties at the threshold
    for active in (True, False):
        want = j_dgc(jnp.asarray(g), jnp.asarray(u), jnp.asarray(v), 0.9,
                     sparsity, active=active)
        got = dgc_compress(torch.from_numpy(g), torch.from_numpy(u),
                           torch.from_numpy(v), 0.9, sparsity,
                           active=torch.tensor(active))
        for w, t in zip(want, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_dgc_threshold_past_two_to_the_24_equals_jax():
    n, q = 2 ** 24 + 3, 0.999
    lo, _, lw, _ = quantile_points(n, q)
    # q * (n - 1) rounds in float32: a float64 index would take another
    # order statistic (and torch.quantile refuses this many elements)
    assert lo != int(np.floor(np.float64(np.float32(q)) * (n - 1)))
    assert lw == 1.0
    rng = np.random.RandomState(3)
    g = rng.randn(n).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    want = j_dgc(jnp.asarray(g), jnp.asarray(zeros), jnp.asarray(zeros),
                 0.9, q)
    got = dgc_compress(torch.from_numpy(g), torch.zeros(n), torch.zeros(n),
                       0.9, q)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert 0 < float(got[3]) < 0.01


def test_dgc_compress_with_clip_close_to_jax():
    rng = np.random.RandomState(1)
    g = rng.randn(64).astype(np.float32) * 5
    z = np.zeros(64, np.float32)
    want = j_dgc(jnp.asarray(g), jnp.asarray(z), jnp.asarray(z), 0.9, 0.75,
                 clip_norm=1.0)
    got = dgc_compress(torch.from_numpy(g), torch.zeros(64),
                       torch.zeros(64), 0.9, 0.75, clip_norm=1.0)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# --------------------------------------------------------------- LocalSGD

class _JLin(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 1)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _TLin(torch.nn.Module):
    def __init__(self, state):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16, device="cpu")
        self.fc2 = tnn.Linear(16, 1, device="cpu")
        from_jax_state_dict(self, state)
        self.requires_grad_(True)
        self.keys = KeyStream(0)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jmse(m, x, y):
    d = m(x) - y
    return (d * d).mean()


_tmse = _jmse


def _toy(seed=0, n=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = (x @ rng.randn(8, 1) + 0.01 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def _lin_pair():
    pit.seed(0)
    jm = _JLin()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, _TLin(state), state


def test_localsgd_k1_equals_sync_sgd_fleet_step():
    _, _, state = _lin_pair()
    x, y = _toy()
    _, ts = _init(8)
    local = _TLin(state)
    step = LocalSGDTrainStep(local, _tmse, SGD(learning_rate=0.1,
                             parameters=local.parameters()), strategy=ts,
                             k_steps=1)
    sync = _TLin(state)
    fstep = FleetTrainStep(sync, _tmse, SGD(learning_rate=0.1,
                           parameters=sync.parameters()), strategy=ts)
    for _ in range(5):
        a, b = float(step(x, y)), float(fstep(x, y))
        assert abs(a - b) <= 1e-5 * abs(b)
    step.sync_params_to_model()
    for (n, p), q in zip(local.named_parameters(), sync.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def _ernie_pair(dropout, seed=5):
    cfg = dict(CFG, hidden_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout)
    jm = JErnie(JErnieConfig(**cfg))
    jm.train()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig(**cfg), device="cpu",
                             keys=KeyStream(seed))
    from_jax_state_dict(tm, state)
    tm.train()
    return jm, tm


def _ernie_batch(b=4, s=32, pad=4, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - pad:] = 0
    labels = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    labels[:, s - pad:] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return ids, mask, labels, nsp


def _jl(m, ids, mask, labels, nsp):
    mlm, nsp_logits = m(ids, attention_mask=mask)
    return j_loss(mlm, nsp_logits, labels, nsp)


def _tl(m, ids, mask, labels, nsp):
    mlm, nsp_logits = m(ids, attention_mask=mask)
    return ernie_pretrain_loss(mlm, nsp_logits, labels, nsp)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_localsgd_k4_follows_jax_trajectory(dropout):
    jm, tm = _ernie_pair(dropout)
    js, ts = _init(2)
    # momentum SGD: its update is linear in the gradient, so elements
    # whose gradient is zero up to rounding (the key third of each
    # qkv_proj.bias, see test_torch_ernie.py) stay within rounding too,
    # where Adam would move them by up to lr either way
    jstep = JLocal(jm, _jl, pit.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=jm.parameters()),
        strategy=js, k_steps=4)
    tstep = LocalSGDTrainStep(tm, _tl, Momentum(
        learning_rate=0.05, momentum=0.9, parameters=tm.parameters()),
        strategy=ts, k_steps=4)
    pit.seed(7)
    tm.keys.seed(7)
    for i in range(6):
        batch = _ernie_batch(seed=i % 2)
        lj = float(jstep(*batch).numpy())
        lt = float(tstep(*batch))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
        blocks = tstep.params
        apart = max(float((b[0] - b[1]).abs().max()) for b in
                    blocks.values())
        if (i + 1) % 4 == 0:
            assert apart == 0.0, i
        else:
            assert apart > 0.0, i
    for n, b in tstep.params.items():
        diff = np.abs(b.numpy() - np.asarray(jstep.params[n]))
        assert diff.max() <= 1e-5, (n, float(diff.max()))


# -------------------------------------------------------------------- DGC

def test_dgc_step_follows_jax_across_rampup():
    jm, _, state = _lin_pair()
    x, y = _toy(seed=2)
    js, ts = _init(2)
    tm = _TLin(state)
    jstep = JDGC(jm, _jmse, learning_rate=0.05, momentum=0.9, sparsity=0.75,
                 rampup_begin_step=2, weight_decay=1e-3, strategy=js)
    tstep = DGCTrainStep(tm, _tmse, learning_rate=0.05, momentum=0.9,
                         sparsity=0.75, rampup_begin_step=2,
                         weight_decay=1e-3, strategy=ts)
    fracs = []
    for i in range(6):
        lj = float(jstep(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y)))
                   .numpy())
        lt = float(tstep(x, y))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
        assert abs(jstep.last_sent_fraction
                   - tstep.last_sent_fraction) <= 1e-6
        fracs.append(tstep.last_sent_fraction)
    assert fracs[0] == fracs[1] == 1.0 and max(fracs[2:]) < 0.5
    for n, p in tstep.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstep.params[n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    for k in ("u", "v"):
        for n, r in tstep.residuals[k].items():
            assert tuple(r.shape) == (2,) + tuple(tstep.params[n].shape)
            np.testing.assert_allclose(r.numpy(),
                                       np.asarray(jstep.residuals[k][n]),
                                       rtol=1e-5, atol=1e-6)


def test_dgc_rejects_a_non_dp_mesh():
    _, _, state = _lin_pair()
    st = DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=2, mp_degree=2)
    fleet.init(strategy=st, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="extra axes"):
        DGCTrainStep(_TLin(state), _tmse, strategy=st)


# ---------------------------------------------------------------- routing

def test_distributed_train_step_routes_and_raises():
    _, _, state = _lin_pair()
    _, st = _init(2)
    m = _TLin(state)
    opt = SGD(learning_rate=0.1, parameters=m.parameters())
    assert type(distributed_train_step(m, _tmse, opt, strategy=st)) \
        is FleetTrainStep
    st.localsgd = True
    assert isinstance(distributed_train_step(m, _tmse, opt, strategy=st),
                      LocalSGDTrainStep)
    st.dgc = True
    with pytest.raises(ValueError, match="exclusive"):
        distributed_train_step(m, _tmse, opt, strategy=st)
    st.localsgd = False
    opt2 = Momentum(learning_rate=0.05, momentum=0.8, weight_decay=1e-4,
                    grad_clip=ClipGradByNorm(clip_norm=2.0),
                    parameters=m.parameters())
    routed = distributed_train_step(m, _tmse, opt2, strategy=st)
    assert isinstance(routed, DGCTrainStep)
    assert routed.momentum == pytest.approx(0.8)
    assert routed.lr == pytest.approx(0.05)
    assert routed.weight_decay == pytest.approx(1e-4)
    assert routed.clip_norm == pytest.approx(2.0)
    opt2.set_lr(0.01)                  # a live learning-rate source
    assert routed.lr == pytest.approx(0.01)
    with pytest.raises(TypeError, match="Momentum or SGD"):
        distributed_train_step(m, _tmse, AdamW(
            learning_rate=1e-3, parameters=m.parameters()), strategy=st)
    with pytest.raises(ValueError, match="ClipGradByNorm"):
        distributed_train_step(m, _tmse, Momentum(
            learning_rate=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
            parameters=m.parameters()), strategy=st)
    with pytest.raises(ValueError, match="optimizer"):
        distributed_train_step(m, _tmse, None, strategy=st)
    with pytest.raises(ValueError, match="distributed_train_step"):
        FleetTrainStep(m, _tmse, opt, strategy=st)
