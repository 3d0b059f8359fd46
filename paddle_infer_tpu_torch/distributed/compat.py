"""The rest of the ``paddle.distributed`` surface.

Port of ``paddle_infer_tpu/distributed/compat.py``: group state,
``alltoall_single``, the task handles of ``isend`` / ``irecv``,
``all_gather_object`` and the ``gloo_*`` shims (through
``torch.distributed``, where the reference goes through
``multihost_utils``), ``split``, the sparse-table entry markers and
the parameter server's slot datasets over the native
``MultiSlotDataFeed``.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


# ---------------------------------------------------------- group state
def is_initialized():
    """Whether ``init_parallel_env`` has run."""
    from . import env

    return env.is_initialized()


def destroy_process_group(group=None):
    """Leave the job's process group (mesh groups need no teardown)."""
    from . import env

    env.shutdown()


def get_group(id=0):
    """The group registered under ``id`` (0: the default group)."""
    from ..parallel.collective import get_group as _get

    return _get(id)


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


# -------------------------------------------------------- collectives
def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """All-to-all of one sharded value in equal splits over the group's
    axis; returns the exchanged value (``out_tensor``, a list, is filled
    with it when given)."""
    from ..parallel.collective import alltoall

    if in_split_sizes is not None or out_split_sizes is not None:
        sizes = set(in_split_sizes or []) | set(out_split_sizes or [])
        if len(sizes) > 1:
            raise NotImplementedError(
                "unequal alltoall_single splits are not supported; the "
                "mesh all-to-all exchanges equal shards")
    out = alltoall(in_tensor, group=group)
    if out_tensor is not None:
        out_tensor[:] = list(out)
        return out_tensor
    return out


class _CompletedTask:
    """The task handle of the "async" point-to-point calls: one
    controller ran the transfer before the handle exists, so it is
    complete; ``wait`` blocks the host until the card is done."""

    def __init__(self, tensor):
        self._tensor = tensor

    def is_completed(self):
        return True

    def wait(self):
        from .collective import wait

        wait(self._tensor)
        return True


def isend(tensor, dst, group=None):
    from .collective import send

    out = send(tensor, dst, group=group)
    return _CompletedTask(out if out is not None else tensor)


def irecv(tensor, src=None, group=None):
    from .collective import recv

    out = recv(tensor, src, group=group)
    if out is not None and isinstance(tensor, list):
        tensor[:] = list(out)
    return _CompletedTask(tensor)


def all_gather_object(object_list, obj, group=None):
    """Append every process's ``obj`` to ``object_list`` in rank order
    (pickled, padded to the longest, one all-gather); a one-process job
    appends its own."""
    import torch.distributed as dist

    from . import env

    if env.process_count() == 1:
        object_list.append(obj)
        return
    payload = np.frombuffer(pickle.dumps(obj), np.uint8)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    world = dist.get_world_size()
    n = torch.tensor([payload.size], dtype=torch.int64, device=dev)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(t.item()) for t in lens]
    padded = torch.zeros(max(lens), dtype=torch.uint8, device=dev)
    padded[:payload.size] = torch.from_numpy(payload.copy()).to(dev)
    blobs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(blobs, padded)
    for blob, ln in zip(blobs, lens):
        object_list.append(pickle.loads(blob[:ln].cpu().numpy().tobytes()))


# ------------------------------------------------------------ gloo shims
def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The reference's gloo bootstrap: join the job over gloo with the
    given rank, size and rendezvous."""
    from . import env

    env.init_parallel_env(coordinator_address=server_endpoint,
                          num_processes=int(rank_num),
                          process_id=int(rank_id), backend="gloo")


def gloo_barrier():
    """A barrier over the job's processes (none for one process)."""
    import torch.distributed as dist

    from . import env

    if env.process_count() > 1:
        dist.barrier()


def gloo_release():
    """Nothing to release: ``destroy_process_group`` leaves the group."""


# ------------------------------------------------- TP split convenience
def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """One-call tensor-parallel layer: builds the layer on ``x``'s device
    (Xavier-initialised, the reference's default) and applies it.
    ``operation="linear"`` with ``axis=1`` is column-parallel, else
    row-parallel; ``"embedding"`` is vocabulary-parallel."""
    from ..parallel import mp_layers

    dev = x.device
    if operation == "linear":
        in_f, out_f = size
        cls = (mp_layers.ColumnParallelLinear if axis == 1
               else mp_layers.RowParallelLinear)
        layer = cls(in_f, out_f, has_bias=bias_attr is not False,
                    device=dev)
    elif operation == "embedding":
        num_emb, emb_dim = size
        layer = mp_layers.VocabParallelEmbedding(num_emb, emb_dim,
                                                 device=dev)
    else:
        raise ValueError(f"unsupported split operation {operation!r}")
    with torch.no_grad():
        layer.reset_parameters()
    return layer(x)


# --------------------------------------------------- sparse-table entries
class _Entry:
    """Accessor-entry markers for sparse tables (the reference's
    ``entry_attr.py``)."""

    def __repr__(self):
        return self._str

    def _to_attr(self):
        return self._str


class ProbabilityEntry(_Entry):
    def __init__(self, probability):
        if not 0 < probability <= 1:
            raise ValueError("probability must be in (0, 1]")
        self.probability = probability
        self._str = f"probability_entry:{probability}"


class CountFilterEntry(_Entry):
    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self.count_filter = count_filter
        self._str = f"count_filter_entry:{count_filter}"


class ShowClickEntry(_Entry):
    def __init__(self, show_name, click_name):
        if not isinstance(show_name, str) or \
                not isinstance(click_name, str):
            raise ValueError("show/click must be var names")
        self.show_name, self.click_name = show_name, click_name
        self._str = f"show_click_entry:{show_name}:{click_name}"


# --------------------------------------------------------- PS datasets
class InMemoryDataset:
    """A slot dataset held in memory (the reference's
    ``InMemoryDataset``): multi-slot text files parsed by the native
    ``MultiSlotDataFeed``, loaded whole, shuffled on the host with
    ``RandomState(0)`` and replayed in batches, each slot merged into
    ``(values, lod)``."""

    def __init__(self):
        self._slots = []
        self._filelist = []
        self._batch_size = 1
        self._records = []
        self._rng = np.random.RandomState(0)

    def init(self, batch_size=1, use_var=None, **kwargs):
        self._batch_size = int(batch_size)
        if use_var:
            self._slots = [
                (getattr(v, "name", str(v)),
                 "float" if "float" in str(getattr(v, "dtype", "int"))
                 else "int")
                for v in use_var]
        return self

    _init_distributed_settings = staticmethod(lambda *a, **k: None)

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def load_into_memory(self):
        from ..native import MultiSlotDataFeed

        feed = MultiSlotDataFeed(self._filelist, self._slots,
                                 batch_size=1, num_threads=2)
        self._records = list(feed)

    def local_shuffle(self):
        self._rng.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=12):
        # every process holds the whole record set, so the seeded local
        # shuffle is the global one
        self.local_shuffle()

    def get_memory_data_size(self, fleet=None):
        return len(self._records)

    def release_memory(self):
        self._records = []

    def __iter__(self):
        batch = []
        for rec in self._records:
            batch.append(rec)
            if len(batch) == self._batch_size:
                yield self._merge(batch)
                batch = []
        if batch:
            yield self._merge(batch)

    def _merge(self, batch):
        out = {}
        for name, _kind in self._slots:
            vals = np.concatenate([b[name][0] for b in batch])
            lods = [0]
            for b in batch:
                lod = b[name][1]
                base = lods[-1]
                lods.extend(base + lod[1:])
            out[name] = (vals, np.asarray(lods, np.int64))
        return out


class QueueDataset(InMemoryDataset):
    """The streaming dataset: batches straight off the threaded feed."""

    def load_into_memory(self):
        raise RuntimeError(
            "QueueDataset streams from files; use set_filelist + iterate "
            "(the reference's QueueDataset has no load_into_memory either)")

    def __iter__(self):
        from ..native import MultiSlotDataFeed

        feed = MultiSlotDataFeed(self._filelist, self._slots,
                                 batch_size=self._batch_size,
                                 num_threads=2)
        return iter(feed)
