"""Port parity: ``paddle_infer_tpu_torch/metric`` against
``paddle_infer_tpu/metric`` on the same numpy-seeded inputs.

Every metric's ``compute`` / ``update`` / ``accumulate`` equals the
reference's on untied scores (``Accuracy`` ranks with ``torch.topk``,
which orders untied scores as ``np.argsort(-pred)``); ``Auc``'s bincount
update gives the reference's per-sample counts exactly.
"""
import numpy as np
import pytest
import torch

from paddle_infer_tpu import metric as jmetric
from paddle_infer_tpu_torch import metric as tmetric


def _scores(n=48, c=7, seed=0):
    rng = np.random.RandomState(seed)
    pred = rng.rand(n, c).astype(np.float32)
    assert all(len(set(r)) == c for r in pred.tolist())     # untied
    return pred, rng.randint(0, c, (n, 1)).astype(np.int64)


@pytest.mark.parametrize("topk", [(1,), (1, 3), (2, 5)])
def test_accuracy_compute_update_accumulate(topk):
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _scores(seed=seed)
        jc = jm.compute(pred, label)
        tc = tm.compute(torch.tensor(pred), torch.tensor(label))
        assert isinstance(tc, torch.Tensor) and tc.dtype == torch.bool
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(np.asarray(tm.update(tc)),
                                      np.asarray(jm.update(jc)))
        assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name() == "acc"
    tm.reset()
    assert tm.accumulate() == (0.0 if len(topk) == 1 else [0.0] * len(topk))


def test_accuracy_takes_numpy_too():
    pred, label = _scores(seed=4)
    np.testing.assert_array_equal(
        tmetric.Accuracy(topk=(1, 2)).compute(pred, label).numpy(),
        jmetric.Accuracy(topk=(1, 2)).compute(pred, label))


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy(k):
    pred, label = _scores(seed=5)
    want = float(np.asarray(jmetric.accuracy(pred, label, k=k).numpy()))
    got = tmetric.accuracy(torch.tensor(pred), torch.tensor(label), k=k)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, abs=1e-7)


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall(cls):
    jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
    rng = np.random.RandomState(1)
    assert tm.accumulate() == jm.accumulate() == 0.0
    for _ in range(3):
        preds = rng.rand(40, 1).astype(np.float32)
        labels = rng.randint(0, 2, (40, 1)).astype(np.int64)
        jm.update(preds, labels)
        tm.update(torch.tensor(preds), torch.tensor(labels))
        assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name() == cls.lower()


@pytest.mark.parametrize("shape,thresholds", [((64,), 4095), ((64, 2), 4095),
                                              ((64,), 7)])
def test_auc_counts_and_value(shape, thresholds):
    jm = jmetric.Auc(num_thresholds=thresholds)
    tm = tmetric.Auc(num_thresholds=thresholds)
    assert tm.accumulate() == jm.accumulate() == 0.0
    rng = np.random.RandomState(2)
    for _ in range(3):
        preds = rng.rand(*shape).astype(np.float32)
        labels = rng.randint(0, 2, (shape[0], 1)).astype(np.int64)
        jm.update(preds, labels)
        tm.update(torch.tensor(preds), torch.tensor(labels))
        np.testing.assert_array_equal(tm._stat_pos, jm._stat_pos)
        np.testing.assert_array_equal(tm._stat_neg, jm._stat_neg)
        assert tm.accumulate() == jm.accumulate()
    assert tm.name() == "auc"


def test_metric_base_raises():
    m = tmetric.Metric()
    for call in (m.reset, m.update, m.accumulate):
        with pytest.raises(NotImplementedError):
            call()
    assert m.name() == "metric"
