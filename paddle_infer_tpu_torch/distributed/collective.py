"""The ``paddle.distributed`` collective names over the port's mesh
collectives (``parallel/collective.py``).

Port of ``paddle_infer_tpu/distributed/collective.py``.  A collective
takes a sharded value (the list of per-shard tensors, rank order) and
returns one; one controller drives every shard, so ``send`` and
``recv`` are the two halves of one ``p2p_transfer``.
"""
from __future__ import annotations

import torch

from ..parallel.collective import (Group, ReduceOp, all_gather, all_reduce,
                                   alltoall, barrier, broadcast, new_group,
                                   ppermute, reduce, reduce_scatter)

ProcessGroup = Group

__all__ = ["Group", "ProcessGroup", "ReduceOp", "all_gather", "all_reduce",
           "alltoall", "barrier", "broadcast", "new_group", "ppermute",
           "reduce", "reduce_scatter", "scatter", "send", "recv", "wait"]


def scatter(tensor, src: int = 0, group=None):
    """Rank ``src``'s value on every rank, each then keeping its dim-0
    chunk (the layout is the scatter, as in the reference): a
    broadcast."""
    return broadcast(tensor, src=src, group=group)


def _current_group_rank(group):
    from ..parallel import topology

    hcg = topology.get_hybrid_communicate_group()
    if hcg is None:
        return 0
    axis = group.axis[0] if group is not None else "dp"
    getters = {"dp": hcg.get_data_parallel_rank,
               "mp": hcg.get_model_parallel_rank,
               "pp": hcg.get_stage_id,
               "sharding": hcg.get_sharding_parallel_rank,
               "sep": hcg.get_sep_parallel_rank}
    return getters.get(axis, lambda: 0)()


def send(tensor, dst: int, group=None, src: int = None):
    """The ``src`` half of one ``src`` -> ``dst`` transfer; ``src``
    defaults to this process's rank on the group's axis."""
    from ..parallel.collective import _default_group, p2p_transfer

    g = group or _default_group()
    src = _current_group_rank(g) if src is None else src
    return p2p_transfer(tensor, src=src, dst=dst, group=g)


def recv(tensor, src: int, group=None, dst: int = None):
    """The ``dst`` half of the same transfer."""
    from ..parallel.collective import _default_group, p2p_transfer

    g = group or _default_group()
    dst = _current_group_rank(g) if dst is None else dst
    return p2p_transfer(tensor, src=src, dst=dst, group=g)


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until the tensor's (or shards') work is done."""
    parts = tensor if isinstance(tensor, (list, tuple)) else [tensor]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in parts):
        torch.cuda.synchronize()
    return tensor
