"""Data pipeline: datasets, samplers, the ``DataLoader`` and its worker
processes (port of ``paddle_infer_tpu/io/``).

Batches are assembled as numpy on the host, in worker processes or
threads when asked, and handed out as CPU tensors; the consumer moves
each batch to its device once.
"""
from .dataset import (ChainDataset, ComposeDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn
from .worker import WorkerInfo, get_worker_info

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "Subset", "ComposeDataset",
    "ChainDataset", "random_split", "Sampler", "SequenceSampler",
    "RandomSampler", "BatchSampler", "DistributedBatchSampler",
    "WeightedRandomSampler", "DataLoader", "default_collate_fn",
    "WorkerInfo", "get_worker_info",
]
