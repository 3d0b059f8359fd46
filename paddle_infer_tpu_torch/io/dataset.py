"""Datasets: ``Dataset``, ``IterableDataset``, ``TensorDataset``,
``Subset``, ``ComposeDataset``, ``ChainDataset``, ``ConcatDataset`` and
``random_split``.

Port of ``paddle_infer_tpu/io/dataset.py``.  Samples stay numpy (a
``TensorDataset`` over torch tensors reads them as arrays), so worker
processes never touch a device.  ``random_split`` draws from numpy's
global stream with the reference's call, so under one
``np.random.seed`` the split is the reference's.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch


def as_array(t):
    """A torch tensor (read back to the host) or array-like as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = [as_array(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self.cum, idx)
        prev = 0 if ds_idx == 0 else self.cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths over one
    ``np.random.permutation`` (``generator`` is accepted and ignored, as
    in the reference)."""
    idx = np.random.permutation(len(dataset))
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, idx[start:start + ln].tolist()))
        start += ln
    return out
