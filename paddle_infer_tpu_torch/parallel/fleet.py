"""Fleet on one device: the strategy, ``init`` and the train step.

Port of the one-device subset of ``paddle_infer_tpu/parallel/fleet.py``:
``DistributedStrategy`` with ``amp``, ``amp_configs`` and
``hybrid_configs`` (every degree 1), ``init`` binding one device, and
``FleetTrainStep``, whose step is the reference's ``step`` /
``step_fn``: draw the step key from the ``KeyStream``, run the loss
under ``trace_key_scope(key)`` and the AMP rule, backward, then the
optimizer's ``functional_update`` at ``step = step_count``.  Where the
reference compiles that whole step into one program, the port runs it
on the card as one CUDA graph per batch signature (``core/graphs.py``,
site ``train-step``): the key, the learning rate and the step count
reach it through staged device buffers written before each replay, the
batch through the graph's own input buffers (each replay copies the
call's batch in; the caller's tensors are never written), and the loss
comes out of a static output.  The CPU, and the card inside ``disable_graphs()``, run it
eagerly.

Parameters are those of ``model.named_parameters()`` that require grad,
deduplicated as that call deduplicates them, so a tied weight appears
once and its gradient is the sum over its uses.  Everything distributed
(dp/mp/pp/sharding degrees, ZeRO, recompute, gradient merge, LocalSGD,
DGC) raises ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import amp, resolve_device
from ..core.graphs import ProgramCache, StagedInputs
from ..observability.compilelog import get_compile_log

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
# each FleetTrainStep is its own program: its compile-log key holds its
# number, so a second model's capture is not a recompile of the first's
_step_ids = itertools.count()


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
        self._programs = ProgramCache()
        self._key = ("train-step", next(_step_ids))
        self._warm = False
        self._grad_sets = None
        self._scalars = StagedInputs(
            [("key", (2,), np.int64), ("lr", (), np.float32),
             ("step", (), np.int32)], self.device)

    def __call__(self, *batch):
        return self.step(*batch)

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def _body(self, key, lr, step, *batch):
        """The whole step on device tensors: grads from None, the loss
        under the step key's scope and the AMP rule, backward, AdamW."""
        for p in self.params.values():
            p.grad = None
        with self.keys.trace_key_scope(key), \
                amp.amp_scope(bool(self.strategy.amp),
                              _amp_dtype(self.strategy)):
            loss = self.loss_fn(self.model, *batch).float()
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        self._grad_sets.append(grads)
        self.optimizer.functional_update(self.params, grads, self.opt_state,
                                         lr=lr, step=step)
        return loss.detach()

    def step(self, *batch):
        """Run one step; returns the float32 loss (a 0-d tensor on the
        model's device; on the card a graph's static output, so read it
        before the next step) and leaves the parameters updated in
        place."""
        if self.opt_state is None:
            self.opt_state = self.optimizer.functional_init(self.params)
        tensors = [self._to_device(b) for b in batch]
        self._step_count += 1
        h = self._scalars.begin()
        h["key"][:] = self.keys.next_key().numpy()
        h["lr"][()] = self.optimizer.get_lr()
        h["step"][()] = self._step_count
        d = self._scalars.upload()
        self._grad_sets = []
        loss = self._programs.run(
            "train-step", self._key, lambda: self._body,
            (d["key"], d["lr"], d["step"], *tensors), self.device)
        if len(self._grad_sets) == 2:
            # this call ran eagerly, then captured: the parameters' grads
            # are now the graph's, so give them this call's values
            warm, captured = self._grad_sets
            for n, g in warm.items():
                if g is not None:
                    captured[n].copy_(g)
        self._grad_sets = None
        if not self._warm:
            # one graph per batch signature: a later capture at this
            # site is a recompile
            get_compile_log().mark_warm("train-step", self._key)
            self._warm = True
        return loss

    def release_graphs(self):
        """Free the step's graph (its private memory pool)."""
        self._programs = ProgramCache()
