"""Fleet: the strategy, ``init`` and the hybrid-parallel train step.

Port of ``paddle_infer_tpu/parallel/fleet.py``.  ``DistributedStrategy``
carries ``hybrid_configs`` (dp / mp / pp / sharding / sep / ep degrees,
``dp_degree=-1`` inferred from the device count), ``sharding`` /
``sharding_configs`` (ZeRO ``stage`` 1-3, ``offload``), ``amp`` /
``amp_configs`` (O1 or O2, bfloat16 or float16), ``recompute``,
``gradient_merge`` (``k_steps``) and ``pipeline_configs``.  ``init``
builds the ``HybridCommunicateGroup`` over ``devices`` (one card
repeated for a mesh on one card: ``[cuda:0] * n``; ``[cpu] * n`` on the
host) and makes it current.

``FleetTrainStep``'s step is the reference's ``step`` / ``step_fn``:
draw the step key from the ``KeyStream``, run the loss under
``trace_key_scope(key)`` and the AMP rule, backward, then the
optimizer's ``functional_update`` at ``step = step_count``, then tick
the optimizer's LR scheduler.  Recompute wraps the whole loss in
``torch.utils.checkpoint`` (non-reentrant; the key scope, the AMP rule
and the mesh open inside it, so the recomputed forward draws the same
masks).  Gradient merge splits dim 0 of every batch tensor into
``k_steps`` micro-batches under ``fold_in(key, i)``, sums the gradients
in order and divides by ``k_steps``.

On a mesh (any degree above 1) the forward runs under the mesh and a
live ``inference.generation.Placement``: tensor-parallel layers run per
mp shard on live slices of their parameters, each dp replica group its
rows, attention per (dp, mp) shard through the flash kernels with the
reference's per-shard dropout seeds (``ops.attention.shard_seed``),
expert stacks per ep shard, ``PipelineStack`` its fill-drain schedule
over pp and ``seq_parallel`` layers ring or Ulysses attention over sep.
Activations between layers are gathered on the mesh's controller, so
``loss_fn`` sees whole tensors: the loss is the global batch's (a
masked-LM mean over every masked token of the batch, not a mean of
per-shard means), as GSPMD computes it.  Autograd sums each
parameter's contributions from every shard and group: the gradient
all-reduce.

The step records the placement the reference's shardings give, as
tuples of axis names (a ``PartitionSpec``'s entries):
``param_specs`` (the ``dist_attr`` spec, plus dim 0 on ``sharding`` at
stage 3 for rank >= 2), ``opt_specs`` (each slot's: the parameter's,
plus dim 0 on ``sharding`` at stages 1-2), ``grad_specs`` (stage 2's
pin of rank >= 2 gradients onto ``sharding``) and ``batch_spec``, the
split the step computes with: dim 0 over ``dp`` where it divides, each
replica group's rows (``nn.layers.row_groups``), or the caller's
``batch_spec``.  The reference splits the batch over ``dp`` and
``sharding`` together; here the ``sharding`` ranks of a replica group
share its rows.  On one device that is the same arithmetic, and
attention's dropout stays keyed by the dp coordinate, as the
reference's is.
``shard_shape(spec, shape)`` is one shard's shape under a spec.  Every
shard of a mesh over one device shares that device's memory, so each
tensor is held whole there; the specs say which block of it each shard
owns.  ``offload=True`` is recorded as a no-op (``offload``): there is
no host-offload path, as on the reference's CPU meshes.

On the card the step, mesh or not, is one CUDA graph per batch
signature (``core/graphs.py``, site ``train-step``), micro-batches and
recompute included: the key, the learning rate and the step count reach
it through staged device buffers written before each replay, the batch
through the graph's own input buffers, and the loss comes out of a
static output.  The CPU, and the card inside ``disable_graphs()``, run
it eagerly.

Parameters are those of ``model.named_parameters()`` that require grad,
deduplicated as that call deduplicates them, so a tied weight appears
once and its gradient is the sum over its uses; the step updates them in
place, so the model always holds them.  Still refused, naming their
ROADMAP.md step: ``localsgd`` and ``dgc`` (step 5, ``distributed/``) and
models with buffers (step 6, BatchNorm's buffers carried through the
step).
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
from . import topology

_DEGREES = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
            "sep_degree", "ep_degree")
# switches that stay off, and the ROADMAP.md step that ports each
_OFF = {"localsgd": "step 5 (distributed/: LocalSGD)",
        "dgc": "step 5 (distributed/: DGC)"}


class DistributedStrategy:
    """Strategy knobs the step consumes (see the module docstring).  The
    reference's ``localsgd`` / ``dgc`` exist and must stay off; an
    unknown knob raises."""

    def __init__(self, **kw):
        self.hybrid_configs: Dict[str, int] = {k: 1 for k in _DEGREES}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {"stage": 1}
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"level": "O1",
                                            "dtype": "bfloat16"}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1}
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1}
        for name in _OFF:
            setattr(self, name, False)
        self.localsgd_configs: Dict[str, Any] = {"k_steps": 4}
        self.dgc_configs: Dict[str, Any] = {"rampup_begin_step": 0,
                                            "sparsity": 0.75}
        for k, v in kw.items():
            if not hasattr(self, k):
                raise NotImplementedError(
                    f"DistributedStrategy.{k} is not a knob of the port's "
                    "fleet")
            setattr(self, k, v)

    @property
    def sharding_stage(self) -> int:
        return int(self.sharding_configs.get("stage", 1)) if self.sharding \
            else 0


def _check(strategy: DistributedStrategy):
    bad = {k: v for k, v in strategy.hybrid_configs.items()
           if k not in _DEGREES or (int(v) < 1 and
                                    not (k == "dp_degree" and int(v) == -1))}
    if bad:
        raise ValueError(f"hybrid degrees {bad}: each is >= 1 "
                         "(dp_degree may be -1, inferred)")
    on = [n for n in _OFF if getattr(strategy, n, False)]
    if on:
        raise NotImplementedError(
            f"strategy {on} not ported yet; see ROADMAP.md "
            + "; ".join(_OFF[n] for n in on))
    if strategy.sharding and strategy.sharding_stage not in (1, 2, 3):
        raise ValueError(f"sharding stage {strategy.sharding_stage}: "
                         "1, 2 or 3")
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
        self.hcg = None
        self.device: Optional[torch.device] = None


_state = _FleetState()
# each FleetTrainStep is its own program: its compile-log key holds its
# number, so a second model's capture is not a recompile of the first's
_step_ids = itertools.count()


def init(strategy: Optional[DistributedStrategy] = None, devices=None,
         role_maker=None, is_collective: bool = True):
    """Build the hybrid mesh from ``strategy.hybrid_configs`` over
    ``devices`` (default: the card) and make it current; returns the
    ``HybridCommunicateGroup``.  ``dp_degree=-1``, or a dp of 1 that
    leaves devices over, takes dp from the device count, as in the
    reference."""
    strategy = strategy or DistributedStrategy()
    _check(strategy)
    devices = (list(devices) if devices is not None
               else [resolve_device(None)])
    n_dev = len(devices)
    hc = strategy.hybrid_configs
    deg = {k: int(hc.get(k, 1)) for k in _DEGREES}
    others = 1
    for k, v in deg.items():
        if k != "dp_degree":
            others *= v
    if deg["dp_degree"] <= 0:
        deg["dp_degree"] = max(n_dev // others, 1)
    prod = deg["dp_degree"] * others
    if prod != n_dev and deg["dp_degree"] == 1 and prod < n_dev \
            and n_dev % prod == 0:
        deg["dp_degree"] = n_dev // prod
    hcg = topology.HybridCommunicateGroup(
        dp_degree=deg["dp_degree"], mp_degree=deg["mp_degree"],
        pp_degree=deg["pp_degree"], sharding_degree=deg["sharding_degree"],
        sep_degree=deg["sep_degree"], ep_degree=deg["ep_degree"],
        devices=[resolve_device(d) for d in devices])
    _state.strategy = strategy
    _state.hcg = hcg
    _state.device = hcg.mesh.controller
    topology.set_hybrid_communicate_group(hcg)
    return hcg


def get_hybrid_communicate_group():
    return topology.get_hybrid_communicate_group()


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


# ----------------------------------------------------------- spec records

def _pad_spec(spec, ndim):
    spec = tuple(spec) if spec else ()
    return spec + (None,) * (ndim - len(spec))


def param_partition_spec(name, arr, dist_attr, strategy, mesh) -> tuple:
    """One parameter's spec: its ``dist_attr`` padded to its rank, plus
    dim 0 on ``sharding`` at stage 3 for a rank >= 2 parameter whose
    dim 0 the axis divides (rank-1 parameters stay replicated, as the
    reference keeps them)."""
    spec = list(_pad_spec(dist_attr, arr.dim()))
    if strategy and strategy.sharding_stage >= 3 and arr.dim() >= 2:
        size = mesh.shape.get("sharding", 1)
        if size > 1 and spec[0] is None and arr.shape[0] % size == 0:
            spec[0] = "sharding"
    return tuple(spec)


def slot_spec(pspec, slot, param, stage, shard_size) -> tuple:
    """An optimizer slot's spec: a slot shaped as its parameter takes the
    parameter's spec, plus dim 0 on ``sharding`` at stages 1-2 (rank >= 2,
    dim 0 divisible); other slots are replicated."""
    if slot.dim() == 0 or slot.shape != param.shape:
        return ()
    spec = list(_pad_spec(pspec, slot.dim()))
    if 1 <= stage < 3 and shard_size > 1 and slot.dim() >= 2 \
            and spec[0] is None and slot.shape[0] % shard_size == 0:
        spec[0] = "sharding"
    return tuple(spec)


def grad_spec(pspec, param, stage, shard_size) -> tuple:
    """A gradient's spec: stage 2 pins a rank >= 2 gradient's dim 0 onto
    ``sharding`` (the reduce-scatter), else the parameter's."""
    spec = list(_pad_spec(pspec, param.dim()))
    if stage < 2 or shard_size <= 1 or "sharding" in spec \
            or param.dim() < 2 or spec[0] is not None \
            or param.shape[0] % shard_size:
        return tuple(spec)
    spec[0] = "sharding"
    return tuple(spec)


def shard_shape(mesh, spec, shape) -> tuple:
    """One shard's shape of a ``shape`` tensor under ``spec`` (an entry
    is an axis name, a tuple of names or None)."""
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            n //= mesh.shape[a]
        out.append(n)
    return tuple(out)


def _amp_dtype(strategy):
    name = str(strategy.amp_configs.get("dtype", "bfloat16"))
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}[name]


class FleetTrainStep:
    """One training step per call: ``loss_fn(model, *batch)`` → scalar.

    ``keys`` is the ``KeyStream`` the step key is drawn from (default
    the model's ``keys``); the model's dropouts draw theirs from the same
    stream inside the step's ``trace_key_scope``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 strategy: Optional[DistributedStrategy] = None, keys=None,
                 hcg=None, batch_spec=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy or _state.strategy or DistributedStrategy()
        _check(self.strategy)
        self.hcg = hcg or _state.hcg
        if self.hcg is None:
            raise RuntimeError("fleet.init(...) must run before "
                               "FleetTrainStep")
        buffers = [n for n, _ in model.named_buffers()]
        if buffers:
            raise NotImplementedError(
                f"model buffers {buffers[:4]}: carrying buffers through the "
                "step is not ported yet; see ROADMAP.md step 6 (BatchNorm)")
        self.keys = keys if keys is not None else model.keys
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.device = next(iter(self.params.values())).device
        mesh = self.hcg.mesh
        self.mesh = mesh if mesh.size > 1 else None
        self._placement = None
        if self.mesh is not None:
            from ..inference.generation import Placement

            self._placement = Placement(model, mesh, live=True)
        stage = self.strategy.sharding_stage
        size = mesh.shape["sharding"]
        self.param_specs = {
            n: param_partition_spec(n, p, getattr(p, "dist_attr", None),
                                    self.strategy, mesh)
            for n, p in self.params.items()}
        self.grad_specs = {n: grad_spec(self.param_specs[n], p, stage, size)
                           for n, p in self.params.items()}
        self.opt_specs = None
        self.batch_spec = batch_spec
        self.offload = None
        if self.strategy.sharding and \
                self.strategy.sharding_configs.get("offload"):
            self.offload = ("no-op: the port has no host-offload path; the "
                            "optimizer slots stay on the device")
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
                              st.amp_configs.get("level", "O1")), \
                topology.mesh_scope(self.mesh, self._placement):
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
            self._record_slot_specs()
        tensors = [self._to_device(b) for b in batch]
        if self.batch_spec is None:
            mesh = self.hcg.mesh
            self.batch_spec = tuple(
                (topology.axis_if_divides(mesh, "dp", t.shape[0])
                 if isinstance(t, torch.Tensor) and t.dim() else None,)
                for t in tensors)
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

    def _record_slot_specs(self):
        stage = self.strategy.sharding_stage
        size = self.hcg.mesh.shape["sharding"]
        self.opt_specs = {
            n: {k: slot_spec(self.param_specs[n], a, self.params[n], stage,
                             size)
                for k, a in slots.items()}
            for n, slots in self.opt_state.items()}

    def shard_shape(self, spec, shape) -> tuple:
        """One shard's shape of a ``shape`` tensor under ``spec`` on the
        step's mesh."""
        return shard_shape(self.hcg.mesh, spec, shape)

    def sync_params_to_model(self):
        """The model (its parameters are the step's, whole, updated in
        place)."""
        return self.model

    def state_dict(self):
        return self.sync_params_to_model().state_dict()

    def release_graphs(self):
        """Free the step's graph (its private memory pool)."""
        self._programs = ProgramCache()
