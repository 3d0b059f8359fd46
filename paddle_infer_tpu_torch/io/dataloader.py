"""DataLoader: single-process, worker-process and worker-thread modes.

Port of ``paddle_infer_tpu/io/dataloader.py``.  ``num_workers > 0``
starts worker processes (``io/worker.py``) by default, or threads with
``worker_mode="thread"``; batches come out in the batch sampler's order
in every mode.  Batches are assembled as numpy; with ``to_tensor`` (the
default) each array becomes a CPU ``torch.Tensor`` over the same memory
(``torch.from_numpy``), and the consumer moves it to its device (the
hapi ``Model`` does, once per batch).  ``last_worker_pids`` holds the
pids that built the last epoch's batches in process mode.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from .dataset import Dataset, IterableDataset, as_array
from .sampler import BatchSampler


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays (``paddle``'s
    ``default_collate_fn``): tuples, lists and dicts recurse, Python ints
    become int64 and floats float32."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return np.stack([as_array(s) for s in batch])


def _tensors(x):
    """numpy arrays of a batch as CPU tensors over the same memory."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_tensors(v) for v in x)
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    return x


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False,
                 collate_fn: Optional[Callable] = None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 to_tensor=True, worker_mode="process"):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.to_tensor = to_tensor
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout  # 0 / None: no deadline
        if worker_mode not in ("process", "thread"):
            raise ValueError(f"worker_mode {worker_mode!r}: process or "
                             "thread")
        self.worker_mode = worker_mode
        self.last_worker_pids = set()
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if not self._iterable_mode:
            if batch_sampler is not None:
                self.batch_sampler = batch_sampler
            else:
                self.batch_sampler = BatchSampler(
                    dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    def _wrap(self, batch):
        return _tensors(batch) if self.to_tensor else batch

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
        elif self.num_workers == 0:
            yield from self._iter_single()
        elif self.worker_mode == "process":
            yield from self._iter_multiprocess()
        else:
            yield from self._iter_threaded()

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._wrap(self.collate_fn(batch))
                batch = []
        if batch and not self.drop_last:
            yield self._wrap(self.collate_fn(batch))

    def _iter_single(self):
        for indices in self.batch_sampler:
            batch = [self.dataset[i] for i in indices]
            yield self._wrap(self.collate_fn(batch))

    def _iter_multiprocess(self):
        from .worker import MultiprocessIter

        it = MultiprocessIter(
            self.dataset, self.collate_fn, list(self.batch_sampler),
            num_workers=self.num_workers,
            prefetch_factor=self.prefetch_factor,
            use_shared_memory=self.use_shared_memory,
            worker_init_fn=self.worker_init_fn, timeout=self.timeout)
        try:
            for batch in it:
                yield self._wrap(batch)
        finally:
            # keep the pids, not the iterator (dataset and reorder
            # buffers), after the epoch
            self.last_worker_pids = set(it.worker_pids)

    def _iter_threaded(self):
        """Worker threads over an index queue; in-order delivery through
        per-batch slots, at most ``num_workers * prefetch_factor`` batches
        built ahead."""
        index_queue: "queue.Queue" = queue.Queue()
        capacity = self.num_workers * self.prefetch_factor
        results = {}
        results_ready = threading.Condition(threading.Lock())
        stop = threading.Event()
        batches = list(self.batch_sampler)
        for i, indices in enumerate(batches):
            index_queue.put((i, indices))
        inflight = threading.Semaphore(capacity)

        def worker():
            while not stop.is_set():
                try:
                    i, indices = index_queue.get(timeout=0.05)
                except queue.Empty:
                    return
                inflight.acquire()
                try:
                    batch = self.collate_fn(
                        [self.dataset[j] for j in indices])
                    err = None
                except Exception as e:  # propagate to consumer
                    batch, err = None, e
                with results_ready:
                    results[i] = (batch, err)
                    results_ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with results_ready:
                    while i not in results:
                        results_ready.wait(timeout=10.0)
                    batch, err = results.pop(i)
                inflight.release()
                if err is not None:
                    raise err
                yield self._wrap(batch)
        finally:
            stop.set()
            for _ in threads:       # wake workers blocked on the window
                inflight.release()
            for t in threads:
                t.join(timeout=1.0)
