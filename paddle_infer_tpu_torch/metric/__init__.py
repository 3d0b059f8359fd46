"""Metrics: ``Metric``, ``Accuracy`` (top-k), ``Precision``, ``Recall``,
``Auc`` and the functional ``accuracy``.

Port of ``paddle_infer_tpu/metric/__init__.py``.  ``Accuracy.compute``
and ``accuracy`` rank the scores on their device with ``torch.topk``,
whose order is the reference's ``np.argsort(-pred)`` wherever the scores
are not tied; everything a metric accumulates stays on the host in
numpy, as in the reference, so ``update`` reads its inputs back once.
``Auc.update`` counts each threshold bucket with one ``np.bincount``
where the reference loops per sample; the counts are the same.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """A torch tensor or array-like as a numpy array (read back to the
    host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()


def _topk_hits(pred, label, k):
    """``[N, k]`` bool on the scores' device: whether each of a row's
    ``k`` best classes (best first) is its label."""
    pred = _torch(pred)
    label = _torch(label).to(pred.device).reshape(-1)
    top = torch.topk(pred, k, dim=-1, largest=True, sorted=True).indices
    return top == label[:, None].to(top.dtype)


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        """``[N, max(topk)]`` bool tensor on the scores' device."""
        return _topk_hits(pred, label, max(self.topk))

    def update(self, correct):
        correct = _np(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].sum()
            self.count[i] += correct.shape[0]
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        accs = self.total / np.maximum(self.count, 1)
        return float(accs[0]) if len(self.topk) == 1 else accs.tolist()

    def name(self):
        return self._name


def _binary(preds, labels):
    return (_np(preds) > 0.5).astype(np.int64).reshape(-1), \
        _np(labels).reshape(-1)


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2:
            preds = preds[:, -1]
        labels = _np(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        n = self.num_thresholds + 1
        pos = labels.astype(bool)
        self._stat_pos += np.bincount(idx[pos], minlength=n)
        self._stat_neg += np.bincount(idx[~pos], minlength=n)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds, descending
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        return float(np.trapezoid(tp / tot_pos, fp / tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Functional accuracy (``paddle.metric.accuracy``): the share of rows
    whose label is among their ``k`` best scores, a float32 scalar on the
    scores' device."""
    hits = _topk_hits(input, label, k)
    return hits.any(dim=-1).to(torch.float32).mean()


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
