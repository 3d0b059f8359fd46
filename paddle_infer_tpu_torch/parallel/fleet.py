"""Fleet on one device: the strategy, ``init`` and the train step.

Port of the one-device subset of ``paddle_infer_tpu/parallel/fleet.py``:
``DistributedStrategy`` with ``amp`` / ``amp_configs`` (O1 or O2,
bfloat16 or float16), ``recompute`` / ``recompute_configs``,
``gradient_merge`` / ``gradient_merge_configs`` and ``hybrid_configs``
(every degree 1); ``init`` binding one device, ``distributed_model``,
``distributed_optimizer``, ``fleet_strategy`` and ``FleetTrainStep``,
whose step is the reference's ``step`` / ``step_fn``: draw the step key
from the ``KeyStream``, run the loss under ``trace_key_scope(key)`` and
the AMP rule, backward, then the optimizer's ``functional_update`` at
``step = step_count``, then tick the optimizer's LR scheduler.

Recompute wraps the whole loss, as the reference's ``jax.checkpoint``
of its pure loss, in ``torch.utils.checkpoint`` (non-reentrant, no RNG
state: the port draws every dropout from the step key); the key scope
and the AMP rule open inside the checkpointed function, so the backward's
recomputed forward draws the same dropout masks at the same dtypes.
Gradient merge splits dim 0 of every batch tensor into ``k_steps``
micro-batches, runs micro-batch ``i`` under ``fold_in(key, i)``, sums
the gradients in order and divides by ``k_steps``; the loss is the mean
of the micro-batch losses.

Where the reference compiles the whole step into one program, the port
runs it on the card as one CUDA graph per batch signature
(``core/graphs.py``, site ``train-step``), micro-batches and recompute
included: the key, the learning rate and the step count reach it
through staged device buffers written before each replay (so a schedule
captures nothing new), the batch through the graph's own input buffers
(each replay copies the call's batch in; the caller's tensors are never
written), and the loss comes out of a static output.  The CPU, and the
card inside ``disable_graphs()``, run it eagerly.

Parameters are those of ``model.named_parameters()`` that require grad,
deduplicated as that call deduplicates them, so a tied weight appears
once and its gradient is the sum over its uses; the step updates them in
place, so the model always holds them.  The distributed rest raises
``NotImplementedError`` naming its ROADMAP.md item: dp/mp/pp/sharding
degrees and ``sharding`` (item 13, the mesh training), ``localsgd`` and
``dgc`` (item 13, ``distributed/``), models with buffers (item 13, the
buffers carried through the step).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import amp, resolve_device
from ..core.graphs import ProgramCache, StagedInputs
from ..core.random import fold_in
from ..observability.compilelog import get_compile_log

_DEGREES = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
            "sep_degree", "ep_degree")
# switches that stay off, and the ROADMAP.md item that ports each
_OFF = {"sharding": "item 13 (the mesh training, ZeRO)",
        "localsgd": "item 13 (distributed/)",
        "dgc": "item 13 (distributed/)"}


class DistributedStrategy:
    """Strategy knobs the one-device step consumes: ``amp`` and
    ``amp_configs`` (level O1/O2, dtype bfloat16/float16),
    ``recompute`` / ``recompute_configs``, ``gradient_merge`` /
    ``gradient_merge_configs`` (``k_steps``) and ``hybrid_configs``
    (every degree 1).  The reference's other switches exist and must
    stay off; an unknown knob raises."""

    def __init__(self, **kw):
        self.hybrid_configs: Dict[str, int] = {k: 1 for k in _DEGREES}
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"level": "O1",
                                            "dtype": "bfloat16"}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1}
        for name in _OFF:
            setattr(self, name, False)
        for k, v in kw.items():
            if not hasattr(self, k):
                raise NotImplementedError(
                    f"DistributedStrategy.{k} is not ported; see ROADMAP.md "
                    "item 13")
            setattr(self, k, v)


def _check(strategy: DistributedStrategy):
    bad = {k: v for k, v in strategy.hybrid_configs.items()
           if k not in _DEGREES or int(v) != 1}
    if bad:
        raise NotImplementedError(
            f"hybrid degrees {bad}: only one device is ported (dp/mp/pp/"
            "sharding wait for ROADMAP.md item 13, the mesh training)")
    on = [n for n in _OFF if getattr(strategy, n, False)]
    if on:
        raise NotImplementedError(
            f"strategy {on} not ported yet; see ROADMAP.md "
            + "; ".join(_OFF[n] for n in on))
    level = strategy.amp_configs.get("level", "O1")
    if strategy.amp and level not in ("O1", "O2"):
        raise ValueError(f"AMP level {level!r}: O1 or O2")
    if _k_steps(strategy) < 1:
        raise ValueError("gradient_merge_configs['k_steps'] must be >= 1")


def _k_steps(strategy) -> int:
    return int(strategy.gradient_merge_configs.get("k_steps", 1)) \
        if strategy.gradient_merge else 1


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
            f"{len(devices)} devices: only one is ported; see ROADMAP.md "
            "item 13 (the mesh training)")
    _state.strategy = strategy
    _state.device = resolve_device(devices[0] if devices else None)
    return _state.device


def fleet_strategy() -> Optional[DistributedStrategy]:
    return _state.strategy


def distributed_model(model: torch.nn.Module) -> torch.nn.Module:
    """Mark a model for fleet execution; on one device the model itself
    (the reference's wrap is a no-op under its mesh too)."""
    if _state.device is None:
        raise RuntimeError("call fleet.init(...) before distributed_model")
    model._fleet_distributed = True
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer, bound to the strategy the step consumes."""
    optimizer._fleet_strategy = strategy or _state.strategy
    return optimizer


def lr_scheduler_tick(optimizer):
    """Advance the optimizer's LR scheduler by one step if it has one."""
    if hasattr(optimizer._lr, "step"):
        try:
            optimizer._lr.step()
        except TypeError:
            pass


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
        buffers = [n for n, _ in model.named_buffers()]
        if buffers:
            raise NotImplementedError(
                f"model buffers {buffers[:4]}: carrying buffers through the "
                "step is not ported (ROADMAP.md item 13, with BatchNorm)")
        self.keys = keys if keys is not None else model.keys
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.device = next(iter(self.params.values())).device
        self.k_steps = _k_steps(self.strategy)
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

    def _loss(self, key, *batch):
        """The pure loss: ``loss_fn`` under the key's scope and the AMP
        rule, both opened here so a recomputation reopens them."""
        st = self.strategy
        with self.keys.trace_key_scope(key), \
                amp.amp_scope(bool(st.amp), _amp_dtype(st),
                              st.amp_configs.get("level", "O1")):
            return self.loss_fn(self.model, *batch).float()

    def _backward(self, key, batch):
        """Forward and backward of one (micro-)batch; the gradients
        accumulate into the parameters' ``grad``."""
        if self.strategy.recompute:
            loss = checkpoint(self._loss, key, *batch, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            loss = self._loss(key, *batch)
        loss.backward()
        return loss.detach()

    def _body(self, key, lr, step, *batch):
        """The whole step on device tensors: grads from None, the
        (micro-)batches' forward and backward, the update."""
        for p in self.params.values():
            p.grad = None
        k = self.k_steps
        if k == 1:
            loss = self._backward(key, batch)
        else:
            micro = [b.reshape((k, b.shape[0] // k) + tuple(b.shape[1:]))
                     if isinstance(b, torch.Tensor) else b for b in batch]
            losses = [self._backward(fold_in(key, i), [
                m[i] if isinstance(m, torch.Tensor) else m for m in micro])
                for i in range(k)]
            loss = torch.stack(losses).mean()
            with torch.no_grad():
                for p in self.params.values():
                    if p.grad is not None:
                        p.grad.div_(k)
        grads = {n: p.grad for n, p in self.params.items()}
        self._grad_sets.append(grads)
        self.optimizer.functional_update(self.params, grads, self.opt_state,
                                         lr=lr, step=step)
        return loss

    def step(self, *batch):
        """Run one step; returns the float32 loss (a 0-d tensor on the
        model's device; on the card a graph's static output, so read it
        before the next step) and leaves the parameters updated in
        place."""
        if self.opt_state is None:
            self.opt_state = self.optimizer.functional_init(self.params)
        tensors = [self._to_device(b) for b in batch]
        k = self.k_steps
        bad = [tuple(t.shape) for t in tensors
               if isinstance(t, torch.Tensor) and (t.dim() == 0
                                                   or t.shape[0] % k)]
        if bad:
            raise ValueError(f"gradient merge k_steps={k}: batch dim 0 of "
                             f"{bad} is not a multiple of it")
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
        lr_scheduler_tick(self.optimizer)
        return loss

    def sync_params_to_model(self):
        """The model (its parameters are the step's, updated in place)."""
        return self.model

    def state_dict(self):
        return self.sync_params_to_model().state_dict()

    def release_graphs(self):
        """Free the step's graph (its private memory pool)."""
        self._programs = ProgramCache()
