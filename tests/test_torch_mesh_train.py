"""Port parity: mesh training through ``FleetTrainStep`` on ``[cpu] * n``
meshes against the JAX package on its forced host devices.

* The twins of ``tests/test_parallel.py``: a column -> row MLP at dp=2 x
  mp=4 after three SGD steps, and ZeRO stages 1-3 at dp=2 x sharding=4
  after three Adam steps, against the JAX single-device eager run at
  the reference's own tolerances (rtol 2e-4 / atol 2e-5 and 3e-4 /
  3e-5); the offload flag trains and is recorded as a no-op.
* The twins of ``tests/test_zero_placement.py``: the step's recorded
  parameter, slot and gradient specs equal the JAX step's
  ``PartitionSpec``s per stage and per facade, each shard 1/4 of dim 0.
* A masked-LM step whose two dp shards hold different numbers of masked
  tokens: loss and gradients equal to JAX's GSPMD step within 1e-5 of
  max-abs (the loss is the global batch's mean, not a mean of
  per-shard means).
* A dp=2 x mp=2 ERNIE with dropout 0.1 for three fp32 steps on the JAX
  step's trajectory (losses within 1e-5 relative, parameters within
  2e-5 of max-abs plus the key-bias caveat of ``test_torch_ernie.py``);
  the JAX side runs its ``_mesh_sharded_attn`` on the plain attention,
  so each (dp, mp) shard's dropout seed carries the reference's
  offset, which the port must reproduce.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu import nn as jnn
from paddle_infer_tpu.core.tensor import Tensor
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import FleetTrainStep as JStep
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import topology as jtopo
from paddle_infer_tpu.parallel.mp_layers import (
    ColumnParallelLinear as JCol, RowParallelLinear as JRow)
from paddle_infer_tpu_torch import nn as tnn
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.nn import functional as PF
from paddle_infer_tpu_torch.optimizer import SGD, Adam, AdamW
from paddle_infer_tpu_torch.parallel import (
    ColumnParallelLinear, DistributedStrategy, FleetTrainStep,
    RowParallelLinear, fleet, topology)
from paddle_infer_tpu_torch.weights import from_jax_state_dict


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
    jfleet._state.hcg = None
    jfleet._state.strategy = None
    jtopo._CURRENT_HCG = None
    topology.set_hybrid_communicate_group(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(tm, jm):
    from_jax_state_dict(tm, _state(jm))
    tm.requires_grad_(True)
    tm.keys = KeyStream(0)
    return tm


def _strategy(**hc):
    st = DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, **hc)
    return st


def _sq_loss(m, x, y):
    d = m(x) - y
    return (d * d).mean()


def _jax_eager(jm, opt, x, y, steps=3):
    for _ in range(steps):
        loss = _sq_loss(jm, Tensor(x), Tensor(y))
        loss.backward()
        opt.step()
        jm.clear_gradients()


class _JTP(jnn.Layer):
    def __init__(self, h, o):
        super().__init__()
        self.fc1 = JCol(h, h * 2, gather_output=False)
        self.fc2 = JRow(h * 2, o, input_is_parallel=True)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _TTP(torch.nn.Module):
    def __init__(self, h, o):
        super().__init__()
        # the reference's gather_output / input_is_parallel are layout
        # hints: the port gathers activations on the controller
        self.fc1 = ColumnParallelLinear(h, h * 2, device="cpu")
        self.fc2 = RowParallelLinear(h * 2, o, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def test_tp_matches_single_device():
    rng = np.random.RandomState(7)
    hidden, out_dim, bs = 8, 4, 16
    x = rng.randn(bs, hidden).astype(np.float32)
    y = rng.randn(bs, out_dim).astype(np.float32)
    pit.seed(7)
    jm = _JTP(hidden, out_dim)
    tm = _port(_TTP(hidden, out_dim), jm)
    _jax_eager(jm, pit.optimizer.SGD(learning_rate=0.1,
                                     parameters=jm.parameters()), x, y)
    hcg = fleet.init(strategy=_strategy(dp_degree=2, mp_degree=4),
                     devices=["cpu"] * 8)
    assert hcg.get_model_parallel_world_size() == 4
    step = FleetTrainStep(tm, _sq_loss, SGD(learning_rate=0.1))
    assert step.param_specs["fc1.weight"] == (None, "mp")
    assert step.param_specs["fc2.weight"] == ("mp", None)
    assert step._placement.get(tm.fc1).n == 4
    for _ in range(3):
        loss = step(x, y)
    assert np.isfinite(float(loss))
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(step.params[n].detach().numpy(),
                                   p.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=n)


def _jseq(hidden, out_dim):
    return jnn.Sequential(jnn.Linear(hidden, 16), jnn.ReLU(),
                          jnn.Linear(16, out_dim))


def _tseq(hidden, out_dim):
    return tnn.Sequential(tnn.Linear(hidden, 16, device="cpu"), tnn.ReLU(),
                          tnn.Linear(16, out_dim, device="cpu"))


@pytest.mark.parametrize("level,stage", [("os", 1), ("os_g", 2),
                                         ("p_g_os", 3)])
def test_zero_stages_match_baseline(level, stage):
    rng = np.random.RandomState(3)
    hidden, out_dim, bs = 8, 8, 16
    x = rng.randn(bs, hidden).astype(np.float32)
    y = rng.randn(bs, out_dim).astype(np.float32)
    jm = _jseq(hidden, out_dim)
    tm = _port(_tseq(hidden, out_dim), jm)
    _jax_eager(jm, pit.optimizer.Adam(learning_rate=0.05,
                                      parameters=jm.parameters()), x, y)
    st = _strategy(dp_degree=2, sharding_degree=4)
    st.sharding = True
    st.sharding_configs = {"stage": stage}
    fleet.init(strategy=st, devices=["cpu"] * 8)
    step = FleetTrainStep(tm, _sq_loss, Adam(learning_rate=0.05))
    for _ in range(3):
        loss = step(x, y)
    assert np.isfinite(float(loss))
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(step.params[n].detach().numpy(),
                                   p.numpy(), rtol=3e-4, atol=3e-5,
                                   err_msg=f"{level}:{n}")


def test_offload_flag_trains_on_cpu():
    st = _strategy(dp_degree=2, sharding_degree=4)
    st.sharding = True
    st.sharding_configs = {"stage": 2, "offload": True}
    fleet.init(strategy=st, devices=["cpu"] * 8)
    m = tnn.Linear(16, 4, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(1))
    m.requires_grad_(True)
    m.keys = KeyStream(1)

    def loss_fn(model, x, y):
        return PF.cross_entropy(model(x), y)

    step = FleetTrainStep(m, loss_fn, AdamW(learning_rate=1e-2))
    assert step.offload.startswith("no-op")
    rng = np.random.RandomState(2)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.int64)
    l0 = float(step(x, y))
    for _ in range(5):
        last = float(step(x, y))
    assert last < l0


# ------------------------------------------------ ZeRO placement twins

def _jax_zero_step(stage, facade=None, offload=False):
    js = JStrategy()
    js.hybrid_configs = {"dp_degree": 2, "sharding_degree": 4}
    if facade is None:
        js.sharding = True
        js.sharding_configs = {"stage": stage, "offload": offload}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:8])
    pit.seed(0)
    jm = jnn.Sequential(jnn.Linear(16, 16), jnn.ReLU(), jnn.Linear(16, 4))
    opt = pit.optimizer.Adam(learning_rate=0.01, parameters=jm.parameters())
    if facade is not None:
        js = facade(jm, opt, "jax")
    step = JStep(jm, _sq_loss, opt, strategy=js)
    return jm, step


def _port_zero_step(jm, stage, facade=None, offload=False):
    st = _strategy(dp_degree=2, sharding_degree=4)
    fleet.init(strategy=st, devices=["cpu"] * 8)
    if facade is None:
        st.sharding = True
        st.sharding_configs = {"stage": stage, "offload": offload}
    tm = _port(tnn.Sequential(tnn.Linear(16, 16, device="cpu"), tnn.ReLU(),
                              tnn.Linear(16, 4, device="cpu")), jm)
    opt = Adam(learning_rate=0.01)
    if facade is not None:
        st = facade(tm, opt, "port")
    return FleetTrainStep(tm, _sq_loss, opt, strategy=st)


def _xy():
    return (np.random.RandomState(0).randn(8, 16).astype(np.float32),
            np.random.RandomState(1).randn(8, 4).astype(np.float32))


def _facade(kind):
    def apply(model, opt, side):
        import paddle_infer_tpu.parallel as J
        import paddle_infer_tpu_torch.parallel as T

        mod = J if side == "jax" else T
        if kind == "p_g_os":
            model, opt = mod.group_sharded_parallel(model, opt,
                                                    level="p_g_os")
        elif kind == "stage3":
            return mod.GroupShardedStage3(model, opt)._strategy
        elif kind == "opt_stage2":
            mod.GroupShardedOptimizerStage2(params=None, optim=opt)
        else:
            mod.DygraphShardingOptimizer(optim=opt)
        return opt._fleet_strategy
    return apply


@pytest.mark.parametrize("stage,facade", [
    (1, None), (2, None), (3, None), (2, "offload"), (3, "p_g_os"),
    (3, "stage3"), (2, "opt_stage2"), (1, "dygraph")])
def test_recorded_specs_equal_jax_partition_specs(stage, facade):
    offload = facade == "offload"
    fac = None if facade in (None, "offload") else _facade(facade)
    jm, jstep = _jax_zero_step(stage, fac, offload)
    step = _port_zero_step(jm, stage, fac, offload)
    x, y = _xy()
    jstep(x, y)
    step(x, y)
    assert step.strategy.sharding_stage == stage
    assert set(step.param_specs) == set(jstep._param_specs)
    for n, spec in jstep._param_specs.items():
        assert step.param_specs[n] == tuple(spec), n
        assert step.param_specs[n] == tuple(
            step.params[n].dim() * [None]) or stage == 3, n
        for slot, jspec in jstep._opt_specs[n].items():
            got = step.opt_specs[n][slot]
            want = tuple(jspec)
            assert got + (None,) * (len(want) - len(got)) == want + (
                None,) * (len(got) - len(want)), (n, slot, got, want)
            if step.params[n].dim() >= 2 and got:
                shape = step.opt_state[n][slot].shape
                assert step.shard_shape(got, shape)[0] == shape[0] // 4
    pinned = [n for n in step.params
              if step.grad_specs[n] != step.param_specs[n]]
    rank2 = [n for n, p in step.params.items() if p.dim() >= 2]
    assert sorted(pinned) == (sorted(rank2) if stage == 2 else [])
    # the rows split over dp alone (the reference's batch spec is
    # ("dp", "sharding"): its sharding ranks of a replica group share
    # the group's rows here)
    assert step.batch_spec[0] == ("dp",)
    assert (step.offload is not None) == offload


# ------------------------------------- the loss of the global batch

def _ernie_pair(cfg, model="mlm", seed=5):
    from paddle_infer_tpu.models import ErnieConfig as JCfg
    from paddle_infer_tpu.models import ErnieForMaskedLM as JMLM
    from paddle_infer_tpu.models import ErnieForPretraining as JPre
    from paddle_infer_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForMaskedLM, ErnieForPretraining)

    jcls, tcls = ((JMLM, ErnieForMaskedLM) if model == "mlm"
                  else (JPre, ErnieForPretraining))
    jm = jcls(JCfg(**cfg))
    tm = tcls(ErnieConfig(**cfg), device="cpu", keys=KeyStream(seed))
    from_jax_state_dict(tm, _state(jm))
    return jm, tm


TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=64)


def test_masked_lm_loss_is_the_global_batch_mean():
    """Shard 0 (rows 0-1) holds 3 masked tokens, shard 1 (rows 2-3)
    holds 24: one SGD step at lr 1 moves every parameter by its
    gradient, which must equal the JAX GSPMD step's."""
    from paddle_infer_tpu.models.losses import masked_lm_loss as jl
    from paddle_infer_tpu_torch.models.losses import masked_lm_loss as tl

    cfg = dict(TINY, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    jm, tm = _ernie_pair(cfg)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 128, (4, 16)).astype(np.int32)
    labels = np.full((4, 16), -100, np.int32)
    labels[0, :2] = rng.randint(0, 128, 2)
    labels[1, 5] = 7
    labels[2:, 4:] = rng.randint(0, 128, (2, 12))
    js = JStrategy()
    js.hybrid_configs = {"dp_degree": 2}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:2])
    jm.train()
    jstep = JStep(jm, lambda m, i, l: jl(m(i), l),
                  pit.optimizer.SGD(learning_rate=1.0,
                                    parameters=jm.parameters()),
                  strategy=js)
    fleet.init(strategy=_strategy(dp_degree=2), devices=["cpu"] * 2)
    tm.train()
    tstep = FleetTrainStep(tm, lambda m, i, l: tl(m(i), l),
                           SGD(learning_rate=1.0))
    before = {n: p.detach().clone() for n, p in tstep.params.items()}
    pit.seed(3)
    tm.keys.seed(3)
    lj = float(jstep(ids, labels).numpy())
    lt = float(tstep(ids, labels))
    assert abs(lj - lt) <= 1e-5 * abs(lj), (lj, lt)
    for n, p in tstep.params.items():
        want = np.asarray(jstep.params[n]) - before[n].numpy()
        got = (p.detach() - before[n]).numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale + 1e-7, n


# ------------------------------------ dropout at dp x mp on JAX's path

@pytest.fixture
def jax_mesh_attention(monkeypatch):
    """The JAX package's ``_mesh_sharded_attn`` on its plain attention:
    the impl choice says "flash" and the kernel is ``_xla_sdpa`` with
    the shard's seed (the reference's own tests hold the kernels to
    ``_xla_sdpa`` bit for bit)."""
    import paddle_infer_tpu.ops.attention as JA
    import paddle_infer_tpu.ops.pallas.flash_attention as JFA

    def plain(q, k, v, q_segment_ids=None, kv_segment_ids=None,
              dropout_p=0.0, dropout_seed=None, is_causal=False, scale=None):
        return JA._xla_sdpa(q, k, v, None, dropout_seed, dropout_p,
                            is_causal, scale, q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids)

    monkeypatch.setattr(JA, "_attn_impl_choice",
                        lambda q, k, mask, quiet=False:
                        "xla" if mask is not None else "flash")
    monkeypatch.setattr(JFA, "flash_attention", plain)


def test_ernie_dp2_mp2_dropout_three_steps_on_jax_trajectory(
        jax_mesh_attention):
    from paddle_infer_tpu.models.ernie import ernie_pretrain_loss as jloss
    from paddle_infer_tpu_torch.models.ernie import ernie_pretrain_loss

    cfg = dict(TINY, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    jm, tm = _ernie_pair(cfg, model="pretrain")
    jm.train()
    tm.train()
    js = JStrategy()
    js.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:4])
    fleet.init(strategy=_strategy(dp_degree=2, mp_degree=2),
               devices=["cpu"] * 4)

    def jl(m, ids, mask, labels, nsp):
        mlm, ns = m(ids, attention_mask=mask)
        return jloss(mlm, ns, labels, nsp)

    def tl(m, ids, mask, labels, nsp):
        mlm, ns = m(ids, attention_mask=mask)
        return ernie_pretrain_loss(mlm, ns, labels, nsp)

    lr = 1e-3
    jstep = JStep(jm, jl, pit.optimizer.AdamW(learning_rate=lr,
                                              parameters=jm.parameters()),
                  strategy=js)
    tstep = FleetTrainStep(tm, tl, AdamW(learning_rate=lr))
    assert tstep._placement.get(tm.ernie.layers[0].self_attn.qkv_proj).n == 2
    rng = np.random.RandomState(0)
    b, s = 4, 32
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - 4:] = 0
    labels = rng.randint(0, 128, (b, s)).astype(np.int32)
    labels[:, s - 4:] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    pit.seed(7)
    tm.keys.seed(7)
    for i in range(3):
        lj = float(jstep(ids, mask, labels, nsp).numpy())
        lt = float(tstep(ids, mask, labels, nsp))
        assert abs(lj - lt) <= 1e-5 * abs(lj), (i, lj, lt)
    h = cfg["hidden_size"]
    for n, p in tstep.params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(jstep.params[n]))
        if n.endswith("qkv_proj.bias"):
            assert diff[h:2 * h].max() <= 3 * lr, n
            diff = np.concatenate([diff[:h], diff[2 * h:]])
        assert diff.max() <= 2e-5, (n, float(diff.max()))


def test_sdpa_mesh_path_equals_jax_mesh_sharded_attn():
    """The port's per-shard attention at dp=2 x mp=2 (each shard's rows
    and heads through ``sdpa`` with its ``shard_seed``, as
    ``ParallelSelfAttention._forward_mesh`` runs it) with dropout and
    padding segments against the JAX package's ``_mesh_sharded_attn``
    running its plain attention per shard: within 1e-6 (the same
    masks)."""
    import paddle_infer_tpu.ops.attention as JA
    from paddle_infer_tpu_torch.ops.attention import (sdpa, shard_offset,
                                                      shard_seed)

    rng = np.random.RandomState(9)
    b, s, h, d = 4, 32, 4, 16
    q, k, v = [(rng.randn(b, s, h, d) * 0.5).astype(np.float32)
               for _ in range(3)]
    seg = np.ones((b, s), np.int32)
    seg[:, s - 5:] = 0
    seed = 0x1234ABCD

    def plain(q, k, v, q_segment_ids=None, kv_segment_ids=None,
              dropout_p=0.0, dropout_seed=None, is_causal=False, scale=None):
        return JA._xla_sdpa(q, k, v, None, dropout_seed, dropout_p,
                            is_causal, scale, q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids)

    jtopo.set_current_mesh(jtopo.create_hybrid_mesh(
        dp=2, mp=2, devices=jax.devices()[:4]))
    want = np.asarray(JA._mesh_sharded_attn(
        plain, *(jnp.asarray(a) for a in (q, k, v)),
        q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
        dropout_p=0.1, dropout_seed=jnp.uint32(seed)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    ts = torch.from_numpy(seg)
    bs, hs = b // 2, h // 2
    got = np.zeros_like(want)
    for g in range(2):
        rows = slice(g * bs, (g + 1) * bs)
        for r in range(2):
            heads = slice(r * hs, (r + 1) * hs)
            got[rows, :, heads] = sdpa(
                *(x[rows, :, heads] for x in t), q_segment_ids=ts[rows],
                kv_segment_ids=ts[rows], dropout_p=0.1,
                seed=shard_seed(torch.tensor(seed),
                                shard_offset(g, r))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the unsplit call keys global (batch, head) coordinates by the bare
    # seed: other masks
    unsplit = sdpa(*t, q_segment_ids=ts, kv_segment_ids=ts, dropout_p=0.1,
                   seed=torch.tensor(seed)).numpy()
    assert not np.allclose(unsplit, got, atol=1e-3)


def _mesh_ernie_step(device, keys_seed=3):
    from paddle_infer_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForPretraining, ernie_pretrain_loss)

    cfg = dict(TINY, hidden_size=128, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    fleet.init(strategy=_strategy(dp_degree=2, mp_degree=2),
               devices=[device] * 4)
    model = ErnieForPretraining(ErnieConfig(**cfg), device=device, seed=0,
                                keys=KeyStream(keys_seed))
    model.train()

    def loss_fn(m, ids, mask, labels, nsp):
        mlm, ns = m(ids, attention_mask=mask)
        return ernie_pretrain_loss(mlm, ns, labels, nsp)

    rng = np.random.RandomState(0)
    b, s = 4, 32
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - 4:] = 0
    labels = rng.randint(0, 128, (b, s)).astype(np.int32)
    labels[:, s - 4:] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    data = [torch.from_numpy(a).to(device) for a in (ids, mask, labels, nsp)]
    return FleetTrainStep(model, loss_fn, AdamW(learning_rate=1e-3)), data


def test_mesh_step_reads_nothing_back():
    """The mesh step's body (per-shard slices, gathers, rank-order sums,
    the shards' dropout seeds) makes no host read, so the card can
    capture it as one CUDA graph."""
    from test_torch_graphs import _NoHostReads

    step, data = _mesh_ernie_step("cpu")
    step(*data)
    with _NoHostReads():
        loss = step(*data)
    assert torch.isfinite(loss)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_mesh_step_graph_equal_eager_on_card(cuda_device):
    """dp=2 x mp=2 on the card repeated: three steps on the graph EQUAL to
    three eager ones from the same weights and keys, one capture, each
    flash kernel once per shard a layer a step."""
    from paddle_infer_tpu_torch.core.graphs import disable_graphs
    from paddle_infer_tpu_torch.ops import _build

    runs = []
    for graphs in (True, False):
        step, data = _mesh_ernie_step(cuda_device)
        for kern in _build.KERNELS.values():
            kern.launches = 0
        if graphs:
            losses = [float(step(*data)) for _ in range(3)]
        else:
            with disable_graphs():
                losses = [float(step(*data)) for _ in range(3)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in step.params.items()},
                     _build.KERNELS["flash_fwd"].launches))
    (lg, pg, ng), (le, pe, ne) = runs
    assert lg == le
    assert all(torch.equal(pg[n], pe[n]) for n in pg)
    assert ng == ne == 3 * TINY["num_hidden_layers"] * 4
