"""Fleet on one device: the strategy, ``init`` and the train step.

Port of the one-device subset of ``paddle_infer_tpu/parallel/fleet.py``:
``DistributedStrategy`` with ``amp``, ``amp_configs`` and
``hybrid_configs`` (every degree 1), ``init`` binding one device, and
``FleetTrainStep``, whose step is the reference's ``step`` /
``step_fn``: draw the step key from the ``KeyStream``, run the loss
under ``trace_key_scope(key)`` and the AMP rule, backward, then the
optimizer's ``functional_update`` at ``step = step_count``.  PyTorch runs
it eagerly: there is no compiled program to cache.

Parameters are those of ``model.named_parameters()`` that require grad,
deduplicated as that call deduplicates them, so a tied weight appears
once and its gradient is the sum over its uses.  Everything distributed
(dp/mp/pp/sharding degrees, ZeRO, recompute, gradient merge, LocalSGD,
DGC) raises ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import amp, resolve_device

_DEGREES = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
            "sep_degree", "ep_degree")
_OFF = ("sharding", "recompute", "gradient_merge", "localsgd", "dgc")


class DistributedStrategy:
    """Strategy knobs the one-device step consumes: ``amp`` and
    ``amp_configs`` (level O2, dtype bfloat16/float16) and
    ``hybrid_configs`` (every degree 1).  The reference's other switches
    exist and must stay off."""

    def __init__(self, **kw):
        self.hybrid_configs: Dict[str, int] = {k: 1 for k in _DEGREES}
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"level": "O1",
                                            "dtype": "bfloat16"}
        for name in _OFF:
            setattr(self, name, False)
        for k, v in kw.items():
            if not hasattr(self, k):
                raise NotImplementedError(
                    f"DistributedStrategy.{k} is not ported; see ROADMAP.md")
            setattr(self, k, v)


def _check(strategy: DistributedStrategy):
    bad = {k: v for k, v in strategy.hybrid_configs.items()
           if k not in _DEGREES or int(v) != 1}
    if bad:
        raise NotImplementedError(
            f"hybrid degrees {bad}: only one device is ported (dp/mp/pp/"
            "sharding wait; see ROADMAP.md)")
    on = [n for n in _OFF if getattr(strategy, n, False)]
    if on:
        raise NotImplementedError(
            f"strategy {on} not ported yet; see ROADMAP.md")
    if strategy.amp and strategy.amp_configs.get("level", "O1") != "O2":
        raise NotImplementedError(
            "AMP level O1 is not ported (O2 is); see ROADMAP.md")


class _FleetState:
    def __init__(self):
        self.strategy: Optional[DistributedStrategy] = None
        self.device: Optional[torch.device] = None


_state = _FleetState()


def init(strategy: Optional[DistributedStrategy] = None, devices=None):
    """Bind one device (``devices[0]``, default the card) and the
    strategy; returns the device."""
    strategy = strategy or DistributedStrategy()
    _check(strategy)
    if devices is not None and len(devices) != 1:
        raise NotImplementedError(
            f"{len(devices)} devices: only one is ported; see ROADMAP.md")
    _state.strategy = strategy
    _state.device = resolve_device(devices[0] if devices else None)
    return _state.device


def _amp_dtype(strategy):
    name = str(strategy.amp_configs.get("dtype", "bfloat16"))
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}[name]


class FleetTrainStep:
    """One training step per call: ``loss_fn(model, *batch)`` → scalar.

    ``keys`` is the ``KeyStream`` the step key is drawn from (default
    the model's ``keys``); the model's dropouts draw theirs from the same
    stream inside the step's ``trace_key_scope``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 strategy: Optional[DistributedStrategy] = None, keys=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy or _state.strategy or DistributedStrategy()
        _check(self.strategy)
        if _state.device is None:
            raise RuntimeError("fleet.init(...) must run before "
                               "FleetTrainStep")
        self.keys = keys if keys is not None else model.keys
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.device = next(iter(self.params.values())).device
        self.opt_state = None
        self._step_count = 0

    def __call__(self, *batch):
        return self.step(*batch)

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def step(self, *batch):
        """Run one step; returns the float32 loss (a 0-d tensor on the
        model's device) and leaves the parameters updated in place."""
        if self.opt_state is None:
            self.opt_state = self.optimizer.functional_init(self.params)
        tensors = [self._to_device(b) for b in batch]
        self._step_count += 1
        key = self.keys.next_key()
        for p in self.params.values():
            p.grad = None
        with self.keys.trace_key_scope(key), \
                amp.amp_scope(bool(self.strategy.amp),
                              _amp_dtype(self.strategy)):
            loss = self.loss_fn(self.model, *tensors).float()
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        self.optimizer.functional_update(self.params, grads, self.opt_state,
                                         lr=self.optimizer.get_lr(),
                                         step=self._step_count)
        return loss.detach()
