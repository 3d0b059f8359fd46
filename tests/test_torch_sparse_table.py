"""Port parity: the parameter server's sparse table
(``parallel/sparse_table.py``) against the JAX package.

The JAX table's rows are loaded into the port's (``set_state_dict``), so
both start equal; then the same pulls and pushes, with many repeated
ids, over 8 shards on each side.  Pulls are EQUAL; after the pushes
the table and slots are EQUAL to JAX's for sgd and within 1e-6 relative
(2e-8 absolute) for adagrad and adam, whose per-row sum and moment updates XLA fuses
into multiply-adds on the CPU while torch rounds each product.  Within
the port: 8 shards EQUAL one shard, two identical runs EQUAL, the
duplicate-id segment sum in occurrence order EQUAL to JAX's
``segment_sum``, and ``SparseEmbedding``'s backward queues its rows.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_infer_tpu.parallel import DistributedStrategy as JStrategy
from paddle_infer_tpu.parallel import fleet as jfleet
from paddle_infer_tpu.parallel import topology as jtopo
from paddle_infer_tpu.parallel.sparse_table import \
    ShardedSparseTable as JTable
from paddle_infer_tpu_torch.parallel import fleet, topology
from paddle_infer_tpu_torch.parallel.sparse_table import (
    ShardedSparseTable, SparseEmbedding, segment_sum_in_order)

ROWS, DIM = 200, 8


@pytest.fixture(autouse=True)
def meshes():
    js = JStrategy()
    js.hybrid_configs = {"dp_degree": 1, "sharding_degree": 8}
    jfleet.init(is_collective=True, strategy=js, devices=jax.devices()[:8])
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, dp_degree=1,
                             sharding_degree=8)
    fleet.init(strategy=st, devices=["cpu"] * 8)
    yield
    jtopo.set_current_mesh(None)
    jfleet._state.initialized = False
    jfleet._state.hcg = jfleet._state.strategy = None
    jtopo._CURRENT_HCG = None
    topology.set_hybrid_communicate_group(None)
    fleet._state.hcg = fleet._state.strategy = fleet._state.device = None


def _pushes(n_push=5, n=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_push):
        ids = np.minimum(rng.zipf(1.3, n) - 1, ROWS - 1).astype(np.int32)
        out.append((ids, rng.randn(n, DIM).astype(np.float32)))
    return out


def test_table_is_sharded():
    t = ShardedSparseTable(100, 16)
    assert t.axis == "sharding" and t.nshard == 8
    assert t._rows_padded % 8 == 0
    assert len(t.table) == 8
    assert t.table[0].shape == (t._rows_padded // 8, 16)


def test_pull_push_adagrad_exact():
    t = ShardedSparseTable(64, 8, optimizer="adagrad", lr=0.1)
    ids = np.array([3, 7, 3, 60], np.int32)
    rows0 = t.pull_sparse(ids).numpy()
    t.push_sparse(ids, np.ones((4, 8), np.float32))
    rows1 = t.pull_sparse(ids).numpy()
    exp3 = 0.1 / math.sqrt(8 * 4.0 / 8 + 1e-10) * 2.0
    exp7 = 0.1 / math.sqrt(8 * 1.0 / 8 + 1e-10) * 1.0
    np.testing.assert_allclose(rows0[0] - rows1[0], exp3, rtol=1e-5)
    np.testing.assert_allclose(rows0[1] - rows1[1], exp7, rtol=1e-5)


def test_segment_sum_in_order_equals_jax():
    rng = np.random.RandomState(4)
    inv = rng.randint(0, 9, 300)
    vals = rng.randn(300, 5).astype(np.float32)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(inv),
                               num_segments=12)
    got = segment_sum_in_order(torch.from_numpy(vals),
                               torch.from_numpy(inv), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_pull_push_match_jax(opt):
    jt = JTable(ROWS, DIM, optimizer=opt, lr=0.05, seed=3)
    tt = ShardedSparseTable(ROWS, DIM, optimizer=opt, lr=0.05, seed=3)
    tt.set_state_dict(jt.state_dict())
    probe = np.arange(ROWS, dtype=np.int32)
    np.testing.assert_array_equal(tt.pull_sparse(probe).numpy(),
                                  np.asarray(jt.pull_sparse(probe)))
    def same(a, b, msg=""):
        if opt == "sgd":
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=2e-8,
                                       err_msg=msg)

    for ids, g in _pushes():
        assert len(np.unique(ids)) < len(ids)      # duplicates abound
        jt.push_sparse(ids, g)
        tt.push_sparse(ids, g)
        same(tt.pull_sparse(ids.reshape(8, 8)).numpy(),
             np.asarray(jt.pull_sparse(ids.reshape(8, 8))))
    js, ts = jt.state_dict(), tt.state_dict()
    assert js.keys() == ts.keys()
    for k in js:
        same(ts[k], js[k], k)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_sharded_equals_one_shard_and_runs_repeat(opt):
    def run(axis):
        t = ShardedSparseTable(ROWS, DIM, optimizer=opt, lr=0.05, seed=3,
                               axis=axis)
        for ids, g in _pushes(seed=1):
            t.push_sparse(ids, g)
        return t.state_dict()

    a, b, one = run(None), run(None), run(False)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], one[k])


def test_sparse_embedding_backward_queues_rows():
    emb = SparseEmbedding(ROWS, DIM, optimizer="sgd", lr=0.1)
    before = emb.table.state_dict()["table"].copy()
    ids = torch.tensor([[1, 2], [2, 5]])
    out = emb(ids)
    assert out.shape == (2, 2, DIM)
    (out * 2.0).sum().backward()
    assert len(emb.table._pending) == 1
    emb.table.apply_pending()
    after = emb.table.state_dict()["table"]
    np.testing.assert_allclose(before[2] - after[2], 0.1 * 4.0, rtol=1e-6)
    np.testing.assert_allclose(before[5] - after[5], 0.1 * 2.0, rtol=1e-6)
    np.testing.assert_array_equal(before[3], after[3])
