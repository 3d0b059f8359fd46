"""The ``paddle.distributed.fleet`` facade.

Port of ``paddle_infer_tpu/distributed/fleet.py``: the fleet of
``parallel/fleet.py`` plus the meta-parallel layers, so user code
reads as the reference's::

    from paddle_infer_tpu_torch.distributed import fleet
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)

``worker_num`` / ``worker_index`` are the process group's.
"""
from __future__ import annotations

from ..parallel.fleet import (DistributedStrategy, FleetTrainStep,
                              distributed_model, distributed_optimizer,
                              fleet_strategy, get_hybrid_communicate_group,
                              init)
from ..parallel.mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                                  RowParallelLinear, VocabParallelEmbedding)
from ..parallel.random import get_rng_state_tracker
from ..parallel.topology import (CommunicateTopology,
                                 HybridCommunicateGroup)
from . import env


class meta_parallel:
    """The reference's ``fleet.meta_parallel`` namespace."""
    ColumnParallelLinear = ColumnParallelLinear
    RowParallelLinear = RowParallelLinear
    VocabParallelEmbedding = VocabParallelEmbedding
    ParallelCrossEntropy = ParallelCrossEntropy

    @staticmethod
    def get_rng_state_tracker():
        return get_rng_state_tracker()


def worker_num():
    return env.process_count()


def worker_index():
    return env.process_index()


__all__ = ["DistributedStrategy", "FleetTrainStep", "distributed_model",
           "distributed_optimizer", "fleet_strategy",
           "get_hybrid_communicate_group", "init", "CommunicateTopology",
           "HybridCommunicateGroup", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "get_rng_state_tracker", "meta_parallel",
           "worker_num", "worker_index"]
