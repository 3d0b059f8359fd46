"""Port parity: auto-parallel, the cost model, the collective / mesh /
compat facades and the package surface of ``distributed/`` against the
JAX package.

* ``Engine.fit`` on the reference's tensor-parallel model at dp=4 x mp=2
  follows the JAX ``Engine``'s epoch losses within 1e-5 relative and
  predicts the same logits; ``Engine.cost`` reports flops > 0 and
  argument bytes > 0 (temporary bytes 0 on the CPU); the tuner's search
  space equals JAX's and it picks a timed candidate; ``Engine.tune``
  rebuilds under the winner.
* ``shard_tensor`` / ``shard_op`` record and validate specs;
  ``ProcessMesh`` maps onto the port's mesh.
* Every lazy name of the reference's ``distributed`` resolves in the
  port's, and the two lists are the same.
* ``create_hybrid_mesh(devices=None)`` raises without a card.
* The compat surface: ``alltoall_single``, the p2p task handles,
  ``split``, the sparse-table entries and the slot datasets over the
  native data feed.
"""
import inspect
import re

import jax
import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
import paddle_infer_tpu.distributed as jdist
from paddle_infer_tpu.distributed import cost_model as jcost
from paddle_infer_tpu.distributed.auto_parallel import Engine as JEngine
from paddle_infer_tpu.parallel import ColumnParallelLinear as JCol
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import topology as jtopo
import paddle_infer_tpu_torch.distributed as tdist
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.distributed import compat
from paddle_infer_tpu_torch.distributed import cost_model as tcost
from paddle_infer_tpu_torch.distributed.auto_parallel import (Engine,
                                                              shard_op,
                                                              shard_tensor)
from paddle_infer_tpu_torch.distributed.mesh import ProcessMesh
from paddle_infer_tpu_torch.nn import functional as PF
from paddle_infer_tpu_torch.nn.layers import ColumnParallelLinear, Linear
from paddle_infer_tpu_torch.optimizer import AdamW
from paddle_infer_tpu_torch.parallel import collective, fleet, topology
from paddle_infer_tpu_torch.weights import from_jax_state_dict


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
    topology.set_current_mesh(None)
    topology.set_hybrid_communicate_group(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


# ------------------------------------------------------------- Engine

class JNet(pit.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = JCol(16, 32)
        self.fc2 = pit.nn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(pit.nn.functional.relu(self.fc1(x)))


class TNet(torch.nn.Module):
    def __init__(self, state):
        super().__init__()
        self.fc1 = ColumnParallelLinear(16, 32, device="cpu")
        self.fc2 = Linear(32, 4, device="cpu")
        self.keys = KeyStream(0)
        from_jax_state_dict(self, state)
        self.requires_grad_(True)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jce(m, x, y):
    return pit.nn.functional.cross_entropy(m(x), y)


def _tce(m, x, y):
    return PF.cross_entropy(m(x), y)


def test_engine_fit_tp_model_follows_jax():
    pit.seed(0)
    js = JStrategy()
    js.hybrid_configs = {"dp_degree": 4, "mp_degree": 2}
    jfleet.init(strategy=js, devices=jax.devices()[:8])
    jnet = JNet()
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=4, mp_degree=2)
    fleet.init(strategy=st, devices=["cpu"] * 8)
    tnet = TNet(state)
    rng = np.random.RandomState(1)
    x = rng.randn(16, 16).astype(np.float32)
    y = rng.randint(0, 4, (16,)).astype(np.int64)
    jeng = JEngine(jnet, _jce, pit.optimizer.AdamW(
        learning_rate=1e-2, parameters=jnet.parameters()))
    teng = Engine(tnet, _tce, AdamW(learning_rate=1e-2,
                                    parameters=tnet.parameters()))
    jh = jeng.fit([(x, y)] * 4, epochs=3)
    th = teng.fit([(x, y)] * 4, epochs=3)
    assert th["loss"][-1] < th["loss"][0]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    assert teng._step.param_specs["fc1.weight"] == (None, "mp")
    out = teng.predict([x[:4]])
    assert out[0].shape == (4, 4)
    np.testing.assert_allclose(out[0], jeng.predict([x[:4]])[0], rtol=1e-4,
                               atol=1e-5)
    ev = teng.evaluate([(x, y)])
    assert np.isfinite(ev["loss"])


def _mlp(state=None):
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = Linear(16, 64, device="cpu")
            self.fc2 = Linear(64, 16, device="cpu")
            self.keys = KeyStream(0)
            gen = torch.Generator().manual_seed(0)
            with torch.no_grad():
                self.fc1.reset_parameters(gen)
                self.fc2.reset_parameters(gen)
            self.requires_grad_(True)

        def forward(self, x):
            return self.fc2(PF.gelu(self.fc1(x)))

    return Net()


def _mse(m, x, y):
    d = m(x) - y
    return (d * d).mean()


def _xy(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 16).astype(np.float32),
            rng.randn(8, 16).astype(np.float32))


def test_engine_cost_counts_flops_and_bytes():
    m = _mlp()
    eng = Engine(m, _mse, AdamW(learning_rate=1e-3,
                                parameters=m.parameters()))
    cost = eng.cost(*_xy(0))
    # forward 2 products, backward 4 (the input's gradient skipped once)
    mm = 2 * 8 * 16 * 64
    assert cost.flops >= 5 * mm
    params = (16 * 64 + 64 + 64 * 16 + 16) * 4
    assert cost.argument_bytes == 3 * params        # Adam's m and v
    assert cost.temp_bytes == 0                     # not measured off a card
    assert cost.bytes_accessed >= cost.argument_bytes


def test_tuner_picks_a_valid_factorization():
    cands = tcost.candidate_factorizations(8, ("dp", "mp"))
    assert cands == jcost.candidate_factorizations(8, ("dp", "mp"))
    x, y = _xy(1)
    report = tcost.tune_parallelism(
        _mlp, _mse, lambda ps: AdamW(learning_rate=1e-3,
                                     parameters=list(ps)), (x, y),
        candidates=[{"dp": 8, "mp": 1}, {"dp": 2, "mp": 4},
                    {"dp": 16, "mp": 1}],
        measure_steps=2, devices=["cpu"] * 8)
    assert report.best in ({"dp": 8, "mp": 1}, {"dp": 2, "mp": 4})
    ok = [t for t in report.trials if t.cost is not None]
    assert len(ok) == 2 and all(t.cost.wall_ms > 0 for t in ok)
    assert report.trials[2].error            # 16 devices asked of 8
    assert fleet._state.hcg is None             # the caller's state back


def test_engine_tune_rebuilds_under_winner():
    m = _mlp()
    eng = Engine(m, _mse, AdamW(learning_rate=1e-3,
                                parameters=m.parameters()),
                 devices=["cpu"] * 4)
    x, y = _xy(2)
    with pytest.warns(UserWarning, match="optimizer_fn"):
        report = eng.tune((x, y), _mlp, measure_steps=1)
    assert report.best and len(report.trials) == 3
    hist = eng.fit([(x, y)] * 2, epochs=1)
    assert np.isfinite(hist["loss"][0])
    assert fleet._state.hcg.mesh.size == 4


# -------------------------------------------------------- annotations

def test_shard_tensor_records_and_validates():
    mesh = ProcessMesh([[0, 1, 2, 3], [4, 5, 6, 7]], dim_names=["dp", "mp"])
    t = shard_tensor(np.ones((8, 4), np.float32), mesh, ["dp", None])
    assert isinstance(t, torch.Tensor) and t.dist_attr == ("dp", None)
    with pytest.raises(AssertionError):
        shard_tensor(np.ones((4, 4), np.float32), mesh, ["zz", None])
    g = shard_op(lambda a: a * 2.0, mesh, in_shard_specs=[["dp", None]],
                 out_shard_specs=[["dp", None]])
    out = g(torch.ones(8, 2))
    assert out.dist_attr == ("dp", None) and float(out.sum()) == 32.0


def test_process_mesh_maps_onto_the_port_mesh():
    pm = ProcessMesh([[0, 1, 2, 3], [4, 5, 6, 7]], dim_names=["mp", "dp"])
    devs = [torch.device("cpu")] * 8
    mesh = pm.to_mesh(devs)
    assert mesh.shape["dp"] == 4 and mesh.shape["mp"] == 2
    assert pm.to_jax_mesh == pm.to_mesh
    with pytest.raises(ValueError, match="hybrid axes"):
        ProcessMesh([0, 1], dim_names=["x"]).to_mesh(devs[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.to_mesh()                                 # no card here


def test_create_hybrid_mesh_has_no_cpu_fallback():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topology.create_hybrid_mesh(dp=2)
    mesh = topology.create_hybrid_mesh(dp=2, devices=["cpu"] * 2)
    assert mesh.devices == [torch.device("cpu")] * 2


# ------------------------------------------------------------ surface

def _lazy_names(module):
    src = inspect.getsource(module.__getattr__)
    return set(re.findall(r'"([A-Za-z_]\w*)"', src)) - {"__name__"}


def test_lazy_names_resolve_as_the_references():
    want = _lazy_names(jdist)
    assert _lazy_names(tdist) == want
    assert len(want) > 40
    for name in sorted(want):
        assert getattr(jdist, name) is not None, name
        assert getattr(tdist, name) is not None, name
    assert set(tdist.__all__) == set(jdist.__all__)
    with pytest.raises(AttributeError):
        tdist.no_such_name
    from paddle_infer_tpu_torch.distributed import fleet as dfleet

    assert dfleet.init is fleet.init


def test_collective_facade_on_a_mesh():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=2)
    fleet.init(strategy=st, devices=["cpu"] * 2)
    g = tdist.new_group(axis="dp")
    parts = [torch.full((2,), float(r)) for r in range(2)]
    out = tdist.send(parts, dst=1, group=g, src=0)
    assert [float(p[0]) for p in out] == [0.0, 0.0]
    task = compat.isend(parts, 1, group=g)
    assert task.is_completed() and task.wait()
    back = list(parts)
    compat.irecv(back, src=1, group=g)
    assert float(back[0][0]) == 1.0
    red = tdist.all_reduce(parts, op=tdist.ReduceOp.SUM, group=g)
    assert float(red[1][0]) == 1.0
    ex = compat.alltoall_single([torch.arange(2.0), torch.arange(2.0) + 2],
                                group=g)
    assert [p.tolist() for p in ex] == [[0.0, 2.0], [1.0, 3.0]]
    with pytest.raises(NotImplementedError):
        compat.alltoall_single(parts, in_split_sizes=[1, 3], group=g)
    assert tdist.wait(parts) is parts
    assert compat.get_group(g.id) is g
    objs = []
    compat.all_gather_object(objs, {"a": 1})
    assert objs == [{"a": 1}]


def test_split_and_entries():
    x = torch.randn(4, 8)
    assert compat.split(x, (8, 6), "linear", axis=1).shape == (4, 6)
    assert compat.split(x, (8, 6), "linear", axis=0).shape == (4, 6)
    emb = compat.split(torch.tensor([1, 3]), (10, 5), "embedding")
    assert emb.shape == (2, 5)
    with pytest.raises(ValueError):
        compat.split(x, (8, 6), "conv")
    assert str(compat.ProbabilityEntry(0.5)) == "probability_entry:0.5"
    assert compat.CountFilterEntry(3)._to_attr() == "count_filter_entry:3"
    assert str(compat.ShowClickEntry("s", "c")) == "show_click_entry:s:c"
    with pytest.raises(ValueError):
        compat.ProbabilityEntry(0.0)
    assert compat.ParallelMode.SHARDING_PARALLEL == 3


class _V:
    def __init__(self, name, dtype):
        self.name, self.dtype = name, dtype


def _slot_file(tmp_path):
    f = tmp_path / "part-0"
    f.write_text("".join(f"1 {i} 2 {i}.5 {i}.25\n" for i in range(6)))
    return str(f)


def test_slot_datasets_match_jax(tmp_path):
    path = _slot_file(tmp_path)
    use = [_V("qid", "int64"), _V("emb", "float32")]
    jds, tds = jdist.InMemoryDataset(), tdist.InMemoryDataset()
    for ds in (jds, tds):
        ds.init(batch_size=2, use_var=use)
        ds.set_filelist([path])
        ds.load_into_memory()
        ds.local_shuffle()
    assert tds.get_memory_data_size() == 6
    jb, tb = list(jds), list(tds)
    assert len(tb) == 3
    for a, b in zip(jb, tb):
        for k in a:
            np.testing.assert_array_equal(a[k][0], b[k][0])
            np.testing.assert_array_equal(a[k][1], b[k][1])
    tds.release_memory()
    assert tds.get_memory_data_size() == 0
    q = tdist.QueueDataset()
    q.init(batch_size=3, use_var=use)
    q.set_filelist([path])
    with pytest.raises(RuntimeError):
        q.load_into_memory()
    assert len(list(q)) == 2
