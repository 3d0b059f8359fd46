"""The distributed layer: process groups and launch, the collective and
fleet facades, ``DataParallel``, distributed checkpoints, elastic
relaunch, auto-parallel with its cost model, and the parameter
server's sparse table.

Port of ``paddle_infer_tpu/distributed/``: the same module paths and
names, over ``torch.distributed`` for processes and the port's
one-controller mesh (``parallel/``) for shards.
"""
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env)

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "init_parallel_env"]


def __getattr__(name):
    # lazy names.  importlib.import_module, not ``from . import x``: the
    # relative form re-enters this __getattr__ through the import
    # system's hasattr probe and recurses while the submodule's own
    # import is in progress (``from ...distributed import fleet``)
    import importlib

    if name in ("new_group", "all_reduce", "all_gather", "broadcast",
                "reduce", "scatter", "alltoall", "reduce_scatter", "send",
                "recv", "barrier", "ReduceOp", "ProcessGroup", "wait"):
        collective = importlib.import_module(".collective", __name__)
        return getattr(collective, name)
    if name == "fleet":
        return importlib.import_module(".fleet", __name__)
    if name == "DataParallel":
        return importlib.import_module(".data_parallel",
                                       __name__).DataParallel
    if name in ("DeviceMesh", "ProcessMesh", "get_mesh", "set_mesh"):
        mesh = importlib.import_module(".mesh", __name__)
        return getattr(mesh, name)
    if name == "launch":
        return importlib.import_module(".launch", __name__)
    if name == "spawn":
        return importlib.import_module(".launch", __name__).spawn
    if name == "auto_parallel":
        return importlib.import_module(".auto_parallel", __name__)
    if name in ("shard_tensor", "shard_op", "Engine"):
        ap = importlib.import_module(".auto_parallel", __name__)
        return getattr(ap, name)
    if name in ("ShardedSparseTable", "SparseEmbedding"):
        st = importlib.import_module("..parallel.sparse_table", __name__)
        return getattr(st, name)
    if name in ("is_initialized", "destroy_process_group", "get_group",
                "ParallelMode", "alltoall_single", "isend", "irecv",
                "all_gather_object", "gloo_init_parallel_env",
                "gloo_barrier", "gloo_release", "split",
                "ProbabilityEntry", "CountFilterEntry", "ShowClickEntry",
                "InMemoryDataset", "QueueDataset"):
        compat = importlib.import_module(".compat", __name__)
        return getattr(compat, name)
    raise AttributeError(f"module 'paddle_infer_tpu_torch.distributed' has "
                         f"no attribute '{name}'")
