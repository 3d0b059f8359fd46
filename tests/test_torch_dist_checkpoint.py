"""Port parity: distributed checkpoints (``distributed/checkpoint.py``)
against the JAX package, on its on-disk format.

* Arrays written by each package load in the other, whole and
  resharded (mp=4 -> dp=8), bfloat16 included, bit for bit; the port
  writes one chunk per distinct shard region of the recorded spec.
* ``save_train_state`` / ``load_train_state``: a pp=2 x mp=2 (x dp=2)
  step with AdamW resumes at dp=8 with every parameter and optimizer
  slot EQUAL and the next losses on the uninterrupted run's within
  1e-5, in the port and across the packages in both directions; the
  mp=4 -> dp=8 slot restore of ``tests/test_dist_checkpoint.py``.
* Multi-process saves merge per-process manifest fragments.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import paddle_infer_tpu as pit
from paddle_infer_tpu.distributed import checkpoint as jck
from paddle_infer_tpu.nn.layer import Layer as JLayer
from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import FleetTrainStep as JStep
from paddle_infer_tpu.parallel import LayerDesc as JDesc
from paddle_infer_tpu.parallel import PipelineStack as JStack
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import topology as jtopo
from paddle_infer_tpu_torch.core.random import KeyStream
from paddle_infer_tpu_torch.distributed import checkpoint as tck
from paddle_infer_tpu_torch.distributed import env
from paddle_infer_tpu_torch.nn import functional as PF
from paddle_infer_tpu_torch.nn.layers import Linear
from paddle_infer_tpu_torch.optimizer import AdamW
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, LayerDesc,
                                             PipelineStack, fleet, topology)
from paddle_infer_tpu_torch.weights import from_jax_state_dict


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _reset_all():
    jtopo.set_current_mesh(None)
    jfleet._state.initialized = False
    jfleet._state.hcg = jfleet._state.strategy = None
    jtopo._CURRENT_HCG = None
    topology.set_current_mesh(None)
    topology.set_hybrid_communicate_group(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


@pytest.fixture(autouse=True)
def _reset():
    yield
    _reset_all()


# ------------------------------------------------------------ arrays

def test_port_chunks_load_in_jax_and_reshard(tmp_path):
    ck = str(tmp_path / "ck")
    x = np.random.RandomState(0).rand(8, 16).astype(np.float32)
    mesh = topology.create_hybrid_mesh(mp=4, devices=["cpu"] * 4)
    tck.save_distributed({"w": torch.from_numpy(x)}, ck, mesh=mesh,
                         specs={"w": (None, "mp")})
    with open(os.path.join(ck, "manifest.json")) as f:
        meta = json.load(f)["arrays"]["w"]
    assert meta["spec"] == [None, "mp"] and meta["dtype"] == "float32"
    assert sorted(c["file"] for c in meta["chunks"]) == [
        f"w@0_{k}.bin" for k in (0, 12, 4, 8)]
    state, _ = jck.load_distributed(ck)
    np.testing.assert_array_equal(state["w"], x)
    jmesh = jtopo.create_hybrid_mesh(dp=8, devices=jax.devices()[:8])
    state, _ = jck.load_distributed(ck, mesh=jmesh,
                                    specs={"w": P("dp", None)})
    assert state["w"].sharding.spec == P("dp", None)
    np.testing.assert_array_equal(np.asarray(state["w"]), x)


def test_jax_chunks_load_in_port_and_reshard(tmp_path):
    ck = str(tmp_path / "ck")
    x = np.random.RandomState(1).rand(8, 16).astype(np.float32)
    jmesh = jtopo.create_hybrid_mesh(mp=4, devices=jax.devices()[:4])
    jck.save_distributed({"w": jax.device_put(
        x, NamedSharding(jmesh, P(None, "mp")))}, ck)
    state, _ = tck.load_distributed(ck)
    np.testing.assert_array_equal(state["w"].numpy(), x)
    mesh = topology.create_hybrid_mesh(dp=8, devices=["cpu"] * 8)
    state, _ = tck.load_distributed(ck, mesh=mesh,
                                    specs={"w": ("dp", None)})
    np.testing.assert_array_equal(state["w"].numpy(), x)
    # without specs: the saved spec filtered to the new mesh (no mp here)
    assert tck._restore_spec([None, "mp"], mesh, (8, 16)) == (None, None)
    m2 = topology.create_hybrid_mesh(dp=2, mp=2, devices=["cpu"] * 4)
    assert tck._restore_spec([None, "mp"], m2, (8, 16)) == (None, "mp")
    assert tck._restore_spec(["dp"], m2, (8, 16)) == ("dp", None)


def test_bfloat16_both_ways(tmp_path):
    x = (np.random.RandomState(2).rand(4, 6) * 3).astype(np.float32)
    jb = jnp.asarray(x, jnp.bfloat16)
    bits = np.asarray(jb).view(np.uint16)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jmesh = jtopo.create_hybrid_mesh(mp=2, devices=jax.devices()[:2])
    jck.save_distributed({"b": jax.device_put(
        jb, NamedSharding(jmesh, P("mp")))}, a)
    got, _ = tck.load_distributed(a)
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    mesh = topology.create_hybrid_mesh(mp=2, devices=["cpu"] * 2)
    tck.save_distributed({"b": got["b"]}, b, mesh=mesh,
                         specs={"b": ("mp", None)})
    back, _ = jck.load_distributed(b)
    assert back["b"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(np.asarray(back["b"]).view(np.uint16),
                                  bits)


def test_scalar_and_int_arrays_round_trip(tmp_path):
    ck = str(tmp_path / "ck")
    tck.save_distributed({"s": torch.tensor(3.5),
                          "i": torch.arange(6, dtype=torch.int32)}, ck,
                         extra={"note": 1})
    state, extra = jck.load_distributed(ck)
    assert float(state["s"]) == 3.5 and extra == {"note": 1}
    np.testing.assert_array_equal(state["i"], np.arange(6, dtype=np.int32))
    back, _ = tck.load_distributed(ck)
    assert back["i"].dtype == torch.int32 and float(back["s"]) == 3.5


def test_multi_process_fragments_merge(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    monkeypatch.setattr(env, "process_count", lambda: 2)
    monkeypatch.setattr(env, "process_index", lambda: 1)
    tck.save_distributed({"x": x}, ck)          # not primary: no chunks
    assert not os.path.exists(os.path.join(ck, "manifest.json"))
    monkeypatch.setattr(env, "process_index", lambda: 0)
    tck.save_distributed({"x": x}, ck)
    state, _ = jck.load_distributed(ck)
    np.testing.assert_array_equal(state["x"], x.numpy())
    with pytest.raises(ValueError, match="fresh directory"):
        tck.save_distributed({"x": x}, ck)


# --------------------------------------------------------- train state

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


class JModel(JLayer):
    def __init__(self):
        super().__init__()
        from paddle_infer_tpu.nn.layers_common import Linear as JLinear

        self.embed = JLinear(8, 16)
        self.stack = JStack(JDesc(JBlock, 16), num_layers=4, micro_batches=2)
        self.head = JLinear(16, 8)

    def forward(self, x):
        return self.head(self.stack(self.embed(x)))


class TModel(torch.nn.Module):
    def __init__(self, state):
        super().__init__()
        self.embed = Linear(8, 16, device="cpu")
        self.stack = PipelineStack(LayerDesc(TBlock, 16), num_layers=4,
                                   micro_batches=2)
        self.head = Linear(16, 8, device="cpu")
        self.keys = KeyStream(0)
        from_jax_state_dict(self, state)
        self.requires_grad_(True)

    def forward(self, x):
        return self.head(self.stack(self.embed(x)))


def _loss(m, x, y):
    d = m(x) - y
    return (d * d).mean()


@pytest.fixture(scope="module")
def state0():
    pit.seed(42)
    jm = JModel()
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(8, 4, 8).astype(np.float32),
             rng.randn(8, 4, 8).astype(np.float32)) for _ in range(4)]


def _tstep(state, **degrees):
    _reset_all()
    st = DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, **degrees)
    n = int(np.prod(list(degrees.values())))
    fleet.init(strategy=st, devices=["cpu"] * n)
    m = TModel(state)
    m.eval()
    return FleetTrainStep(m, _loss, AdamW(learning_rate=1e-3,
                                          parameters=m.parameters()))


def _jstep(state, **degrees):
    _reset_all()
    js = JStrategy()
    js.hybrid_configs = {f"{k}": v for k, v in degrees.items()}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:8])
    jm = JModel()
    jm.set_state_dict({k: pit.Tensor(v) for k, v in state.items()})
    jm.eval()
    return JStep(jm, _loss, pit.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), strategy=js)


def _snapshot(step):
    params = {n: np.array(np.asarray(p.detach().numpy()
                                     if isinstance(p, torch.Tensor) else p))
              for n, p in step.params.items()}
    slots = {n: {k: np.array(a.detach().numpy() if isinstance(
        a, torch.Tensor) else np.asarray(a)) for k, a in s.items()}
        for n, s in step.opt_state.items()}
    return params, slots


def _assert_state_equal(step, params, slots):
    got_p, got_s = _snapshot(step)
    assert got_p.keys() == params.keys()
    for n in params:
        np.testing.assert_array_equal(got_p[n], params[n], err_msg=n)
        for k in slots[n]:
            np.testing.assert_array_equal(got_s[n][k], slots[n][k],
                                          err_msg=f"{n}/{k}")


PIPE = dict(dp_degree=2, mp_degree=2, pp_degree=2)


def test_port_pp2_mp2_resumes_at_dp8(state0, tmp_path):
    batches = _batches()
    a = _tstep(state0, **PIPE)
    want = [float(a(*b)) for b in batches]
    b = _tstep(state0, **PIPE)
    for x in batches[:2]:
        b(*x)
    assert b.param_specs["stack.fc__weight"] == ("pp", None, None)
    ck = str(tmp_path / "ck")
    tck.save_train_state(b, ck)
    params, slots = _snapshot(b)
    with open(os.path.join(ck, "manifest.json")) as f:
        meta = json.load(f)["arrays"]
    assert len(meta["param/stack.fc__weight"]["chunks"]) == 2
    c = _tstep(state0, dp_degree=8)
    tck.load_train_state(c, ck)
    assert c._step_count == 2
    _assert_state_equal(c, params, slots)
    got = [float(c(*x)) for x in batches[2:]]
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)


def test_jax_train_state_resumes_in_port(state0, tmp_path):
    batches = _batches()
    j = _jstep(state0, **PIPE)
    for x in batches[:2]:
        j(*x)
    ck = str(tmp_path / "ck")
    jck.save_train_state(j, ck)
    params, slots = _snapshot(j)
    jd = _jstep(state0, dp_degree=8)
    jck.load_train_state(jd, ck)
    want = float(jd(*batches[2]).numpy())
    t = _tstep(state0, dp_degree=8)
    tck.load_train_state(t, ck)
    assert t._step_count == 2
    _assert_state_equal(t, params, slots)
    assert abs(float(t(*batches[2])) - want) <= 1e-5 * abs(want)


def test_port_train_state_resumes_in_jax(state0, tmp_path):
    batches = _batches()
    t = _tstep(state0, **PIPE)
    for x in batches[:2]:
        t(*x)
    ck = str(tmp_path / "ck")
    tck.save_train_state(t, ck)
    params, slots = _snapshot(t)
    j = _jstep(state0, dp_degree=8)
    jck.load_train_state(j, ck)
    assert j._step_count == 2
    _assert_state_equal(j, params, slots)


def test_optimizer_slots_restored_mp4_to_dp8(state0, tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(8, 4, 8).astype(np.float32)
    y = rng.randn(8, 4, 8).astype(np.float32)
    a = _tstep(state0, dp_degree=2, mp_degree=4)
    a(x, y)
    params, slots = _snapshot(a)
    ck = str(tmp_path / "ck")
    tck.save_train_state(a, ck)
    b = _tstep(state0, dp_degree=8)
    tck.load_train_state(b, ck)
    _assert_state_equal(b, params, slots)
