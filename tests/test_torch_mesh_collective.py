"""Port parity: the training half of ``parallel/topology.py`` and
``parallel/collective.py``, ``parallel/random.py``, the package's
exports and the fleet's remaining refusals, against the JAX package.

Each collective's forward and backward is held to the JAX verb and its
VJP (``jax.vjp``) over a dp=4 mesh of conftest's forced host devices,
EQUAL: a JAX array sharded on dim 0 is the port's list of its four
blocks, a replicated one four references to one tensor, a replicated
result's cotangent sits on one rank (the result is one value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import paddle_infer_tpu.parallel as jpar
from paddle_infer_tpu.parallel import collective as jcol
from paddle_infer_tpu_torch.core import random as R
from paddle_infer_tpu_torch.parallel import collective as tcol
from paddle_infer_tpu_torch.parallel import fleet, topology
from paddle_infer_tpu_torch.serving import ShardedConfigError

N = 4
X = (np.arange(16, dtype=np.float32) + 1).reshape(16, 1) * 0.5
CT = (np.arange(16, dtype=np.float32) * 10 + 1).reshape(16, 1)


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
    topology.set_hybrid_communicate_group(None)
    topology.set_current_mesh(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


def _jgroup():
    mesh = jpar.create_hybrid_mesh(dp=N, devices=jax.devices()[:N])
    return mesh, jcol.Group(mesh, "dp")


def _tgroup():
    return tcol.Group(topology.create_hybrid_mesh(dp=N,
                                                  devices=["cpu"] * N), "dp")


# verb: (JAX call, port call, input sharded?, output sharded?)
VERBS = {
    "all_reduce": (lambda a, g: jcol.all_reduce(a, group=g),
                   lambda p, g: tcol.all_reduce(p, group=g), False, False),
    "all_gather": (lambda a, g: jcol.all_gather(a, group=g),
                   lambda p, g: tcol.all_gather(p, group=g), True, False),
    "reduce_scatter": (lambda a, g: jcol.reduce_scatter(a, group=g),
                       lambda p, g: tcol.reduce_scatter(p, group=g),
                       False, True),
    "broadcast": (lambda a, g: jcol.broadcast(a, src=1, group=g),
                  lambda p, g: tcol.broadcast(p, src=1, group=g),
                  True, True),
    "alltoall": (lambda a, g: jcol.alltoall(a, group=g),
                 lambda p, g: tcol.alltoall(p, group=g), True, True),
    "ppermute": (lambda a, g: jcol.ppermute(
        a, [(i, (i + 1) % N) for i in range(N)], group=g),
        lambda p, g: tcol.ppermute(
            p, [(i, (i + 1) % N) for i in range(N)], group=g), True, True),
    "reduce": (lambda a, g: jcol.reduce(a, dst=2, group=g),
               lambda p, g: tcol.reduce(p, dst=2, group=g), True, True),
    "p2p_transfer": (lambda a, g: jcol.p2p_transfer(a, 1, 3, group=g),
                     lambda p, g: tcol.p2p_transfer(p, 1, 3, group=g),
                     True, True),
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_collective_forward_and_vjp_equal_jax(verb):
    jcall, tcall, sharded_in, sharded_out = VERBS[verb]
    mesh, jg = _jgroup()
    x = jnp.asarray(X)
    if sharded_in:
        x = jax.device_put(x, NamedSharding(mesh, P("dp")))
    y, vjp = jax.vjp(lambda a: jcall(a, jg), x)
    (jdx,) = vjp(jnp.asarray(CT))

    tg = _tgroup()
    if sharded_in:
        leaves = [torch.tensor(b, requires_grad=True)
                  for b in np.split(X, N)]
        parts = leaves
    else:
        leaves = [torch.tensor(X, requires_grad=True)]
        parts = leaves * N
    out = tcall(parts, tg)
    if sharded_out:
        np.testing.assert_array_equal(
            torch.cat([o.detach() for o in out]).numpy(), np.asarray(y))
        cts = [torch.tensor(c) for c in np.split(CT, N)]
        torch.autograd.backward(out, cts)
    else:
        for o in out:
            np.testing.assert_array_equal(o.detach().numpy(), np.asarray(y))
        (out[0] * torch.tensor(CT)).sum().backward()
    got = torch.cat([t.grad for t in leaves]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdx))


def test_sums_in_rank_order_and_no_graph_without_grad():
    tg = _tgroup()
    parts = [torch.full((2,), float(r + 1)) for r in range(N)]
    out = tcol.all_reduce(parts, group=tg)
    assert all(o.grad_fn is None for o in out)
    assert torch.equal(out[0], torch.full((2,), 10.0))
    z = tcol.ppermute(parts, [(0, 1)], group=tg)
    assert torch.equal(z[1], parts[0]) and not z[0].any()


def test_groups_barrier_and_registry():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=2, mp_degree=2)
    hcg = fleet.init(strategy=st, devices=["cpu"] * 4)
    g = tcol.new_group(axis="mp")
    assert g.nranks == 2 and tcol.get_group(g.id) is g
    assert tcol.new_group(ranks=[0, 2]).axis == ("dp",)
    assert tcol.get_group(0).axis == ("dp",)
    tcol.barrier(hcg.get_model_parallel_group())
    with pytest.raises(ValueError, match="mesh-axis group"):
        tcol.new_group(ranks=[0, 3])


def test_topology_equals_jax():
    jt = jpar.CommunicateTopology(["pp", "dp", "mp"], [2, 2, 2])
    tt = topology.CommunicateTopology(["pp", "dp", "mp"], [2, 2, 2])
    assert tt.world_size() == jt.world_size() == 8
    assert tt.get_rank(pp=1, dp=0, mp=1) == jt.get_rank(pp=1, dp=0, mp=1)
    assert tuple(tt.get_coord(5)) == tuple(jt.get_coord(5))
    for axis in ("pp", "dp", "mp"):
        assert tt.get_comm_list(axis) == jt.get_comm_list(axis)
        assert tt.get_axis_list(axis, 1) == jt.get_axis_list(axis, 1)
    jh = jpar.HybridCommunicateGroup(dp_degree=2, mp_degree=4)
    th = topology.HybridCommunicateGroup(dp_degree=2, mp_degree=4,
                                         devices=["cpu"] * 8)
    for name in ("get_data_parallel_world_size",
                 "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size", "get_parallel_mode",
                 "get_model_parallel_rank", "get_stage_id",
                 "is_first_stage", "is_last_stage"):
        assert getattr(th, name)() == getattr(jh, name)(), name
    assert th.get_model_parallel_group().nranks == 4
    assert dict(th.mesh.shape) == {a: int(jh.mesh.shape[a])
                                   for a in topology.HYBRID_AXES}


def test_fleet_init_dp_inference_and_distinct_cards():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=-1, mp_degree=4)
    hcg = fleet.init(strategy=st, devices=["cpu"] * 8)
    assert hcg.get_data_parallel_world_size() == 2
    assert topology.get_hybrid_communicate_group() is hcg
    with pytest.raises(ShardedConfigError, match="distinct CUDA devices"):
        topology.HybridCommunicateGroup(
            dp_degree=2, devices=[torch.device("cuda", 0),
                                  torch.device("cuda", 1)])


def test_rng_tracker_equals_jax():
    from paddle_infer_tpu.parallel import random as jrand
    from paddle_infer_tpu.parallel import topology as jtopo
    from paddle_infer_tpu_torch.core.random import KeyStream
    from paddle_infer_tpu_torch.parallel import random as trand

    jtopo.set_hybrid_communicate_group(
        jpar.HybridCommunicateGroup(mp_degree=2, devices=jax.devices()[:2]))
    topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
        mp_degree=2, devices=["cpu"] * 2))
    try:
        jrand.model_parallel_random_seed(11)
        keys = KeyStream(0)
        trand.model_parallel_random_seed(11, keys=keys)
        jt, tt = jrand.get_rng_state_tracker(), trand.get_rng_state_tracker()
        name = trand.MODEL_PARALLEL_RNG
        want = np.asarray(jax.random.key_data(jt.states_[name]))
        np.testing.assert_array_equal(tt.states_[name].numpy(), want)
        # rank 1's local state differs; the global stream folds nothing
        assert not torch.equal(tt.local_key(name, 1), tt.states_[name])
        np.testing.assert_array_equal(keys.key.numpy(),
                                      R.PRNGKey(11).numpy())
        with tt.rng_state(name, keys=keys):
            drawn = keys.next_key()
        with jt.rng_state(name):
            from paddle_infer_tpu.core import random as jr

            jdrawn = jr.next_key()
        np.testing.assert_array_equal(
            drawn.numpy(), np.asarray(jax.random.key_data(jdrawn)))
    finally:
        jtopo._CURRENT_HCG = None
        jtopo.set_current_mesh(None)


STEP5 = {"LocalSGDTrainStep", "DGCTrainStep", "dgc_compress",
         "distributed_train_step"}


def test_exports_are_the_reference_names_less_step_five():
    import paddle_infer_tpu_torch.parallel as tpar

    assert set(tpar.__all__) == set(jpar.__all__) - STEP5
    for name in tpar.__all__:
        assert getattr(tpar, name) is not None, name


def test_remaining_refusals_name_their_roadmap_step():
    from paddle_infer_tpu_torch.core.random import KeyStream

    for knob in ("localsgd", "dgc"):
        st = fleet.DistributedStrategy()
        setattr(st, knob, True)
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md step 5 \(distributed/"):
            fleet.init(strategy=st, devices=["cpu"])
    fleet.init(strategy=fleet.DistributedStrategy(), devices=["cpu"])

    class WithBuffer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(2))
            self.register_buffer("running_mean", torch.zeros(2))
            self.keys = KeyStream(0)

    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md step 6 \(BatchNorm\)"):
        fleet.FleetTrainStep(WithBuffer(), lambda m: m.w.sum(), None)
    with pytest.raises(NotImplementedError, match="not a knob"):
        fleet.DistributedStrategy(fuse_all_reduce_ops=True)


def test_chip_smoke_mesh_train_phase_on_cpu(monkeypatch):
    """``chip_smoke``'s mesh_train runs (a)–(e) at tiny sizes on the CPU
    (the wrappers take their plain versions, so no flash launch is
    counted): every gate of the card's run holds."""
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from paddle_infer_tpu_torch.models import MoEConfig
    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    cpu = torch.device("cpu")
    cfg = ErnieConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64)
    a = cs.mesh_ernie(cpu, "cpu", cfg=cfg, batch=4, seq=32, launches_per_step=0)
    assert np.isfinite(a["step_ms_p50"])
    assert set(cs.mesh_zero(cpu, "cpu", cfg=cfg, batch=4, seq=32)) == {
        None, 1, 2, 3}
    assert set(cs.mesh_pipeline(cpu, "cpu", layers=4, micro=2, batch=4,
                                seq=16, hidden=64, heads=4, ffn=128,
                                reps=1)) == {1, 2}
    sep = cs.mesh_sep(cpu, "cpu", shape=dict(B=1, H=4, S=64, D=16), reps=1)
    assert {"ring", "ulysses"} <= set(sep)
    assert sep["ulysses launches"] == {"flash_fwd": 0, "flash_dkdv": 0,
                                       "flash_dq": 0}
    mc = MoEConfig(num_experts=4, vocab_size=96, hidden_size=32,
                   num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=64, max_position_embeddings=64)
    assert np.isfinite(cs.mesh_moe(cpu, "cpu", config=mc, batch=2,
                                   seq=16)["step_ms_p50"])
