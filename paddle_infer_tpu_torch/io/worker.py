"""DataLoader worker processes.

Port of ``paddle_infer_tpu/io/worker.py``: N OS processes each pull
``(batch_idx, indices)`` from an index queue, collate the samples with
the loader's ``collate_fn`` and send the batch back through a result
queue; the consumer delivers the batches in order through a bounded
reorder window.  With ``use_shared_memory`` the numpy arrays of a batch
travel through ``multiprocessing.shared_memory`` segments (one copy in
the worker, one copy out in the consumer, which unlinks the segment),
everything else through the queue's pickle.  ``get_worker_info()``
inside a worker gives its ``WorkerInfo``; each worker seeds numpy with
``(seed + worker_id) % 2**31`` before ``worker_init_fn``; an exception
in a worker is raised in the consumer.

Payloads stay numpy inside the workers, which never touch CUDA.  Workers
start by ``fork`` (the reference's default) while the loader's process
has no CUDA context, and by ``forkserver`` once it has one: a CUDA
process runs the CUDA runtime's and PyTorch's threads, and a child forked
from a multi-threaded process may inherit a lock some other thread held
(Python warns on every such fork).  The fork server is a fresh
single-threaded process that imports this module once; each worker is
forked from it, and the dataset and ``collate_fn`` reach it by pickle,
so they must be picklable there (module-level classes and functions).
``start_method`` or ``FLAGS_loader_start_method`` overrides the choice.

Segments are named ``pitdl<loader pid>_<worker pid>_<n>``, so the
segments of one loader can be told apart.  When an epoch ends early (a
``break``, ``EarlyStopping``, an error in a worker), ``shutdown`` takes
the unsent indices back, stops the workers and unlinks every segment
still in the reorder window or the result queue.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue as pyqueue
import time
from dataclasses import dataclass
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

import numpy as np

_WORKER_INFO = None
SHM_PREFIX = "pitdl"


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: int
    dataset: object = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker process: this worker's id, worker count, seed and
    dataset; None in the loader's own process."""
    return _WORKER_INFO


# ------------------------------------------------------- shm tree codec

def _encode(obj, segments, names):
    """numpy arrays -> ('__shm__', name, shape, dtype); containers recurse;
    everything else passes through pickle."""
    if isinstance(obj, np.ndarray) and obj.nbytes > 0:
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes,
                                         name=next(names))
        view = np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
        view[...] = obj
        segments.append(shm)
        return ("__shm__", shm.name, obj.shape, str(obj.dtype))
    if isinstance(obj, tuple):
        return tuple(_encode(o, segments, names) for o in obj)
    if isinstance(obj, list):
        return [_encode(o, segments, names) for o in obj]
    if isinstance(obj, dict):
        return {k: _encode(v, segments, names) for k, v in obj.items()}
    return obj


def _decode(obj):
    """The payload with every segment copied out and unlinked."""
    if isinstance(obj, tuple):
        if len(obj) == 4 and obj[0] == "__shm__":
            _, name, shape, dtype = obj
            shm = shared_memory.SharedMemory(name=name)
            try:
                out = np.ndarray(shape, np.dtype(dtype),
                                 buffer=shm.buf).copy()
            finally:
                shm.close()
                try:
                    shm.unlink()
                except FileNotFoundError:  # pragma: no cover
                    pass
            return out
        return tuple(_decode(o) for o in obj)
    if isinstance(obj, list):
        return [_decode(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    return obj


# ------------------------------------------------------------ worker loop

def default_start_method() -> str:
    """``forkserver`` once this process holds a CUDA context, else
    ``fork``."""
    import torch

    return "forkserver" if torch.cuda.is_initialized() else "fork"


def _worker_loop(dataset, collate_fn, index_queue, result_queue,
                 worker_id, num_workers, seed, use_shared_memory,
                 worker_init_fn, owner):
    global _WORKER_INFO
    _WORKER_INFO = WorkerInfo(worker_id, num_workers, seed, dataset)
    np.random.seed((seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    names = (f"{SHM_PREFIX}{owner}_{os.getpid()}_{n}"
             for n in itertools.count())
    while True:
        item = index_queue.get()
        if item is None:                         # shutdown sentinel
            return
        i, indices = item
        try:
            batch = collate_fn([dataset[j] for j in indices])
            if use_shared_memory:
                segments = []
                payload = _encode(batch, segments, names)
                # the consumer owns them now: it unlinks each after
                # copying out, so this process's tracker must not
                for s in segments:
                    s.close()
                    resource_tracker.unregister(s._name, "shared_memory")
            else:
                payload = batch
            result_queue.put((i, payload, None, os.getpid()))
        except Exception as e:                   # propagate to consumer
            result_queue.put((i, None, e, os.getpid()))


class MultiprocessIter:
    """In-order multiprocess iterator with a bounded reorder window."""

    def __init__(self, dataset, collate_fn, batches, num_workers,
                 prefetch_factor, use_shared_memory=True,
                 worker_init_fn=None, timeout=120.0, seed=0,
                 start_method=None):
        method = (start_method or os.environ.get("FLAGS_loader_start_method")
                  or default_start_method())
        ctx = mp.get_context(method)
        if method == "forkserver":
            ctx.set_forkserver_preload(["__main__", __name__])
        self._batches = batches
        self._capacity = max(2, num_workers * prefetch_factor)
        self._index_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._timeout = timeout
        self._results = {}
        self._received = 0
        self.worker_pids = set()
        self._workers = [
            ctx.Process(
                target=_worker_loop,
                args=(dataset, collate_fn, self._index_q, self._result_q,
                      w, num_workers, seed, use_shared_memory,
                      worker_init_fn, os.getpid()),
                daemon=True)
            for w in range(num_workers)]
        for p in self._workers:
            p.start()
        self._sent = 0

    def _feed(self):
        while self._sent < len(self._batches) and \
                self._sent < self._received + self._capacity:
            self._index_q.put((self._sent, self._batches[self._sent]))
            self._sent += 1

    def _next_result(self):
        """One ``(batch_idx, payload, error, pid)`` from the workers;
        raises when a worker died or a positive timeout passed."""
        waited = 0.0
        poll = min(self._timeout or 5.0, 5.0)
        while True:
            try:
                return self._result_q.get(timeout=poll)
            except pyqueue.Empty:
                waited += poll
                dead = [w.pid for w in self._workers if not w.is_alive()]
                if dead:
                    # its in-flight batch is lost: in-order delivery
                    # cannot continue
                    raise RuntimeError(
                        f"DataLoader worker(s) died (pids {dead}): killed "
                        "(OOM?) or crashed without a picklable "
                        "error") from None
                # timeout 0 / None blocks while the workers live
                if self._timeout and waited >= self._timeout:
                    raise RuntimeError(
                        f"DataLoader worker timeout after {waited:.0f}s"
                    ) from None

    def __iter__(self):
        self._feed()
        try:
            for i in range(len(self._batches)):
                while i not in self._results:
                    j, payload, err, pid = self._next_result()
                    self.worker_pids.add(pid)
                    if err is not None:
                        raise err
                    self._results[j] = payload
                    self._received += 1
                    self._feed()
                yield _decode(self._results.pop(i))
        finally:
            self.shutdown()

    def _drain(self, wait):
        """Unlink one queued payload's segments; False when none came
        within ``wait`` seconds."""
        try:
            _, payload, _, _ = self._result_q.get(timeout=wait) if wait \
                else self._result_q.get_nowait()
        except (pyqueue.Empty, OSError, ValueError):
            return False
        if payload is not None:
            _decode(payload)
        return True

    def shutdown(self):
        """Stop the workers and unlink every segment not yet delivered."""
        while True:                  # indices no worker has taken yet
            try:
                self._index_q.get_nowait()
            except (pyqueue.Empty, OSError, ValueError):
                break
        for _ in self._workers:
            try:
                self._index_q.put(None)
            except (OSError, ValueError):   # pragma: no cover
                pass
        # a worker finishes the batch in hand, sends it and exits once
        # its queue's feeder has flushed: keep draining meanwhile, so a
        # large pickled batch cannot hold it
        deadline = time.monotonic() + 10.0
        while any(p.is_alive() for p in self._workers) and \
                time.monotonic() < deadline:
            self._drain(0.05)
        for p in self._workers:
            if p.is_alive():        # pragma: no cover
                p.terminate()
            p.join(timeout=1.0)
        for payload in self._results.values():
            _decode(payload)
        self._results = {}
        while self._drain(0.0):
            pass
        self._index_q.close()
        self._result_q.close()
