"""Group-sharded (ZeRO) public API.

Port of ``paddle_infer_tpu/parallel/sharding.py``: the levels are a
placement policy that ``FleetTrainStep`` consumes, not wrappers that
hook the backward.  ``group_sharded_parallel(model, optimizer, level)``
marks the strategy ``os`` -> stage 1 (optimizer slots split over
``sharding``), ``os_g`` -> stage 2 (and the gradients' layout), ``p_g_os``
-> stage 3 (and the parameters'); ``GroupShardedStage2`` / ``3``,
``GroupShardedOptimizerStage2`` and ``DygraphShardingOptimizer`` are the
reference's wrapper classes over the same marks, usable as the layer or
optimizer they wrap.  ``offload=True`` is recorded; the step reports it
as a no-op (``FleetTrainStep.offload``), as the reference's CPU meshes
do: there is no host-offload path.
"""
from __future__ import annotations

from .fleet import DistributedStrategy, _state

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def _mark(strategy, stage, offload):
    strategy.sharding = True
    strategy.sharding_configs = dict(strategy.sharding_configs or {},
                                     stage=stage, offload=offload)
    return strategy


def group_sharded_parallel(model, optimizer, level: str = "os",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False, buffer_max_size=None,
                           segment_size=None, sync_comm: bool = False):
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {sorted(_LEVELS)}; got "
                         f"{level}")
    strategy = getattr(optimizer, "_fleet_strategy", None) \
        or _state.strategy or DistributedStrategy()
    _mark(strategy, _LEVELS[level], offload)
    model._fleet_distributed = True
    optimizer._fleet_strategy = strategy
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


class _GroupShardedStage:
    """The reference's wrapper-class surface: it records the stage on
    the strategy and forwards to the inner layer."""

    _stage = 2

    def __init__(self, layer, optimizer=None, group=None, offload=False,
                 **kwargs):
        self._layer = layer
        self._optimizer = optimizer
        strategy = _mark(_state.strategy or DistributedStrategy(),
                         self._stage, offload)
        layer._fleet_distributed = True
        if optimizer is not None:
            optimizer._fleet_strategy = strategy
        self._strategy = strategy

    def __call__(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def __getattr__(self, name):
        if name == "_layer":
            raise AttributeError(name)
        return getattr(self._layer, name)


class GroupShardedStage2(_GroupShardedStage):
    """ZeRO-2: gradients and optimizer slots split."""

    _stage = 2


class GroupShardedStage3(_GroupShardedStage):
    """ZeRO-3: parameters, gradients and optimizer slots split."""

    _stage = 3


class GroupShardedOptimizerStage2:
    """Optimizer-slot sharding wrapper (stage >= 2), delegating to the
    inner optimizer."""

    def __init__(self, params=None, optim=None, group=None, offload=False,
                 **kwargs):
        self._inner = optim
        strategy = getattr(optim, "_fleet_strategy", None) \
            or _state.strategy or DistributedStrategy()
        _mark(strategy, max(2, int(strategy.sharding_configs.get("stage",
                                                                 2))),
              offload)
        optim._fleet_strategy = strategy

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)


class DygraphShardingOptimizer(GroupShardedOptimizerStage2):
    """Stage 1 (optimizer slots only)."""

    def __init__(self, hcg=None, user_defined_strategy=None, params=None,
                 inner_optimizer_class=None, optim=None, **kw):
        inner = optim
        if inner is None and inner_optimizer_class is not None:
            inner = inner_optimizer_class(parameters=params, **kw)
        self._inner = inner
        strategy = user_defined_strategy or _state.strategy \
            or DistributedStrategy()
        strategy.sharding = True
        strategy.sharding_configs = dict(strategy.sharding_configs or {},
                                         stage=1)
        inner._fleet_strategy = strategy
