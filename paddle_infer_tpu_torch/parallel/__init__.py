"""The hybrid-parallel layer of the port: topology and groups, the
collectives on sharded values, the tensor-parallel layers, fleet and
its train step, ZeRO, pipeline and sequence parallelism, MoE and the
named RNG states (the reference's ``parallel/__init__.py`` names, less
the ``distributed/`` meta-optimizers of ROADMAP.md step 5)."""
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       create_hybrid_mesh, get_current_mesh,
                       get_hybrid_communicate_group, set_current_mesh,
                       set_hybrid_communicate_group)
from .collective import (Group, ReduceOp, all_gather, all_reduce, alltoall,
                         barrier, broadcast, new_group, ppermute, reduce,
                         reduce_scatter)
from . import fleet
from .fleet import DistributedStrategy, FleetTrainStep
from .sharding import (DygraphShardingOptimizer, GroupShardedOptimizerStage2,
                       GroupShardedStage2, GroupShardedStage3,
                       group_sharded_parallel)
from .sequence_parallel import ring_attention, ulysses_attention
from .moe import MoELayer, gshard_gate, naive_gate, switch_gate
from .pipeline import LayerDesc, PipelineStack
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)


_MP_LAYERS = ("ColumnParallelLinear", "RowParallelLinear",
              "VocabParallelEmbedding", "ParallelCrossEntropy")


def __getattr__(name):
    # the tensor-parallel layers live in nn/layers.py, which imports this
    # package: bind them on first use
    if name in _MP_LAYERS:
        from . import mp_layers

        return getattr(mp_layers, name)
    raise AttributeError(name)


def named_sharding(*spec):
    """The current mesh and ``spec`` (the reference returns a
    ``NamedSharding``; here the pair a placement reads), or None off a
    mesh."""
    mesh = get_current_mesh()
    return None if mesh is None else (mesh, tuple(spec))


__all__ = [
    "CommunicateTopology", "HybridCommunicateGroup", "create_hybrid_mesh",
    "get_current_mesh", "set_current_mesh", "named_sharding",
    "get_hybrid_communicate_group", "set_hybrid_communicate_group",
    "Group", "ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
    "broadcast", "reduce", "alltoall", "ppermute", "barrier", "new_group",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "fleet", "DistributedStrategy", "FleetTrainStep",
    "group_sharded_parallel", "get_rng_state_tracker", "RNGStatesTracker",
    "model_parallel_random_seed", "ring_attention", "ulysses_attention",
    "LayerDesc", "PipelineStack",
    "MoELayer", "switch_gate", "gshard_gate", "naive_gate",
    "GroupShardedStage2", "GroupShardedStage3",
    "GroupShardedOptimizerStage2", "DygraphShardingOptimizer",
]
