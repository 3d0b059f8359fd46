"""The data-parallel meta-optimizers: LocalSGD and Deep Gradient
Compression.

Port of ``paddle_infer_tpu/parallel/meta_optimizers.py``.  The reference
runs each as one ``shard_map`` program manual over the ``dp`` axis; here
one controller steps the ``dp`` replicas in rank order, each on its
rows of the batch (dim 0 split in ``dp`` equal blocks, the reference's
``P("dp")``) and with its own key ``fold_in(key, rank)``, and reduces in
rank order:

* ``LocalSGDTrainStep``: every replica holds its own copy of the
  parameters and optimizer state (on ``mesh.device(dp=r)``: on one card
  ``dp`` copies on ``cuda:0``), steps on its own gradients, and every
  ``k_steps``-th step the replicas' parameters are replaced by their
  mean (the reference's ``lax.pmean``).  With ``k_steps=1`` that is
  synchronous data-parallel SGD.
* ``DGCTrainStep``: the parameters are the model's own (replicated);
  each replica keeps residuals ``u``, ``v`` (``residuals[...][n]`` has a
  leading ``dp`` axis), compresses its gradient with ``dgc_compress``
  and the mean of the replicas' sent gradients updates the parameters
  (momentum SGD with the velocity in ``u``).  Steps up to
  ``rampup_begin_step`` are plain momentum SGD.

A replica's forward runs the model with the replica's parameters swapped
in (``torch.nn.utils.stateless``), under the step key's scope and the
strategy's AMP rule, and without a mesh: the replica's attention draws
its dropout from the replica's key alone.  That is what the reference's
per-replica step computes off the TPU, where ``_attn_impl_choice`` picks
the XLA attention and no per-shard seed offset applies
(``paddle_infer_tpu/ops/attention.py:104-128`` offsets only the Pallas
path, which the CPU never takes).

On the card each step is one CUDA graph per batch signature
(``core/graphs.py``, site ``train-step``): the key, learning rate and
1-based step count reach it through staged device buffers.  LocalSGD
takes the sync decision inside the graph from the staged step count
(``torch.where(step % k == 0, mean, own)``), so a sync step replays the
same graph as a local one; DGC's rampup gate is the same kind of
device-side select.  The CPU, and the card inside ``disable_graphs()``,
run the body eagerly.

``dgc_compress``'s threshold is ``jnp.quantile(|v|, sparsity)`` as JAX
computes it (method ``linear``): the order statistics at
``floor(q * (n - 1))`` and ``ceil(...)`` of the sorted values, weighted
with float32 weights from ``q * (n - 1)`` formed in float32 (it rounds
once ``n - 1 > 2**24``), as ``low * (1 - w) + high * w``.  The indices
and weights depend only on the shape and ``sparsity``, so they are
formed on the host in numpy float32; the values come from a sort on the
device.  ``torch.quantile`` refuses more than 2**24 elements and
interpolates with ``lerp``; it is not used.  None of this is a Pallas
kernel in the reference, so it stays plain PyTorch.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch
from torch.nn.utils import stateless
from torch.utils.checkpoint import checkpoint

from .. import amp
from ..core.graphs import ProgramCache, StagedInputs
from ..core.random import fold_in
from ..observability.compilelog import get_compile_log
from .fleet import (DistributedStrategy, _amp_dtype, _state,
                    lr_scheduler_tick)
from .topology import HybridCommunicateGroup

_step_ids = itertools.count()


def _dp_mesh(hcg: Optional[HybridCommunicateGroup]):
    hcg = hcg or _state.hcg
    if hcg is None:
        raise RuntimeError("fleet.init(...) must run first")
    mesh = hcg.mesh
    others = [a for a in mesh.shape if a != "dp" and mesh.shape[a] > 1]
    if others:
        raise ValueError(
            "LocalSGD/DGC are data-parallel-only meta-optimizers "
            f"(reference parity); mesh has extra axes {others}")
    return mesh, mesh.shape.get("dp", 1)


class _MetaStepBase:
    """Shared plumbing: the trainable parameters, the staged scalars,
    the per-replica loss and the program cache (``FleetTrainStep``'s
    surface)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 strategy: Optional[DistributedStrategy],
                 hcg: Optional[HybridCommunicateGroup], keys=None):
        self.model = model
        self.loss_fn = loss_fn
        self.strategy = strategy or _state.strategy or DistributedStrategy()
        self.mesh, self.dp = _dp_mesh(hcg)
        self.keys = keys if keys is not None else model.keys
        self._param_info = [(n, p) for n, p in model.named_parameters()
                            if p.requires_grad]
        self.device = self._param_info[0][1].device
        self._step_count = 0
        self._programs = ProgramCache()
        self._key = ("train-step", type(self).__name__, next(_step_ids))
        self._warm = False
        self._scalars = StagedInputs(
            [("key", (2,), np.int64), ("lr", (), np.float32),
             ("step", (), np.int32)], self.device)

    def __call__(self, *batch):
        return self.step(*batch)

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def _rows(self, batch, r):
        """Replica ``r``'s block of dim 0 of every batch tensor."""
        out = []
        for b in batch:
            if isinstance(b, torch.Tensor) and b.dim():
                n = b.shape[0] // self.dp
                out.append(b[r * n:(r + 1) * n])
            else:
                out.append(b)
        return out

    def _loss(self, params, key, *batch):
        st = self.strategy
        with stateless._reparametrize_module(self.model, params,
                                             tie_weights=True), \
                self.keys.trace_key_scope(key), \
                amp.amp_scope(bool(st.amp), _amp_dtype(st),
                              st.amp_configs.get("level", "O1")):
            return self.loss_fn(self.model, *batch).float()

    def _replica_grads(self, params, key, batch):
        """Replica loss and gradients (``None`` for an unused parameter)
        w.r.t. ``params`` (a ``{name: tensor}`` of leaves)."""
        if self.strategy.recompute:
            loss = checkpoint(self._loss, params, key, *batch,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            loss = self._loss(params, key, *batch)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        return loss.detach(), dict(zip(names, grads))

    def _check_batch(self, tensors):
        bad = [tuple(t.shape) for t in tensors
               if isinstance(t, torch.Tensor) and (t.dim() == 0
                                                   or t.shape[0] % self.dp)]
        if bad:
            raise ValueError(f"dp={self.dp}: batch dim 0 of {bad} is not a "
                             "multiple of it")

    def _run(self, body, lr, batch):
        """Stage the step's scalars and run ``body`` (one graph per batch
        signature on the card)."""
        tensors = [self._to_device(b) for b in batch]
        self._check_batch(tensors)
        self._step_count += 1
        h = self._scalars.begin()
        h["key"][:] = self.keys.next_key().numpy()
        h["lr"][()] = lr
        h["step"][()] = self._step_count
        d = self._scalars.upload()
        out = self._programs.run(
            "train-step", self._key, lambda: body,
            (d["key"], d["lr"], d["step"], *tensors), self.device)
        if not self._warm:
            get_compile_log().mark_warm("train-step", self._key)
            self._warm = True
        return out

    def release_graphs(self):
        self._programs = ProgramCache()


class LocalSGDTrainStep(_MetaStepBase):
    """LocalSGD (the reference's ``LocalSGDOptimizer``): ``k_steps``
    unsynchronized local optimizer steps per replica, then the replicas'
    parameters averaged.  ``replica_params[r]`` / ``replica_state[r]``
    hold replica ``r``'s copy; ``params[n]`` stacks them ``[dp, ...]``
    as the reference's per-replica axis.  Returns the mean of the
    replicas' losses."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 strategy: Optional[DistributedStrategy] = None,
                 hcg: Optional[HybridCommunicateGroup] = None,
                 k_steps: Optional[int] = None, keys=None):
        super().__init__(model, loss_fn, strategy, hcg, keys)
        self.optimizer = optimizer
        cfg = dict(self.strategy.localsgd_configs or {})
        self.k_steps = int(k_steps if k_steps is not None
                           else cfg.get("k_steps", 4))
        self.replica_params = []
        self.replica_state = []
        for r in range(self.dp):
            dev = self.mesh.device(dp=r)
            ps = {n: p.detach().clone().to(dev).requires_grad_(True)
                  for n, p in self._param_info}
            self.replica_params.append(ps)
            self.replica_state.append(optimizer.functional_init(ps))

    @property
    def params(self):
        """``{name: [dp, ...]}``: every replica's copy, stacked."""
        return {n: torch.stack([ps[n].detach() for ps in
                                self.replica_params])
                for n, _ in self._param_info}

    def _body(self, key, lr, step, *batch):
        losses = []
        for r, ps in enumerate(self.replica_params):
            loss, grads = self._replica_grads(ps, fold_in(key, r),
                                              self._rows(batch, r))
            losses.append(loss)
            self.optimizer.functional_update(ps, grads,
                                             self.replica_state[r], lr=lr,
                                             step=step)
        with torch.no_grad():
            sync = torch.remainder(step, self.k_steps) == 0
            for n, _ in self._param_info:
                acc = self.replica_params[0][n]
                for ps in self.replica_params[1:]:
                    acc = acc + ps[n].to(acc.device)
                mean = acc / self.dp
                for ps in self.replica_params:
                    p = ps[n]
                    p.copy_(torch.where(sync, mean.to(p.device), p))
            acc = losses[0]
            for x in losses[1:]:
                acc = acc + x
        return acc / self.dp

    def step(self, *batch):
        loss = self._run(self._body, self.optimizer.get_lr(), batch)
        lr_scheduler_tick(self.optimizer)
        return loss

    @torch.no_grad()
    def sync_params_to_model(self):
        """The replicas' mean written into the model (they are equal
        right after a sync step)."""
        for n, p in self._param_info:
            acc = self.replica_params[0][n]
            for ps in self.replica_params[1:]:
                acc = acc + ps[n].to(acc.device)
            p.copy_((acc / self.dp).to(p.dtype))
        return self.model

    def state_dict(self):
        return self.sync_params_to_model().state_dict()


def distributed_train_step(model: torch.nn.Module, loss_fn: Callable,
                           optimizer=None,
                           strategy: Optional[DistributedStrategy] = None,
                           hcg: Optional[HybridCommunicateGroup] = None,
                           **kw):
    """Route a strategy to its train step as the reference's
    meta-optimizer stack does: ``strategy.localsgd`` ->
    ``LocalSGDTrainStep``, ``strategy.dgc`` -> ``DGCTrainStep`` (a
    Momentum or SGD optimizer; its weight decay, ``ClipGradByNorm`` and a
    live learning-rate source carried over), else ``FleetTrainStep``."""
    from .fleet import FleetTrainStep

    strategy = strategy or _state.strategy or DistributedStrategy()
    if getattr(strategy, "localsgd", False) and getattr(strategy, "dgc",
                                                        False):
        raise ValueError("strategy.localsgd and strategy.dgc are exclusive")
    if optimizer is None:
        raise ValueError("distributed_train_step requires an optimizer")
    if getattr(strategy, "localsgd", False):
        return LocalSGDTrainStep(model, loss_fn, optimizer,
                                 strategy=strategy, hcg=hcg, **kw)
    if getattr(strategy, "dgc", False):
        from ..optimizer.clip import ClipGradByNorm
        from ..optimizer.optimizer import SGD, Momentum

        if not isinstance(optimizer, (Momentum, SGD)):
            raise TypeError(
                "strategy.dgc requires a Momentum or SGD optimizer "
                f"(got {type(optimizer).__name__}); DGC's update rule IS "
                "momentum SGD — use FleetTrainStep for adaptive optimizers")
        cfg = dict(strategy.dgc_configs or {})
        clip = None
        if optimizer._grad_clip is not None:
            if not isinstance(optimizer._grad_clip, ClipGradByNorm):
                raise ValueError(
                    "DGC clips gradients per-tensor (ClipGradByNorm); "
                    f"{type(optimizer._grad_clip).__name__} cannot be "
                    "honored on this route")
            clip = optimizer._grad_clip.clip_norm
        lr_src = optimizer._lr if callable(optimizer._lr) \
            else optimizer.get_lr          # live: set_lr stays honoured
        return DGCTrainStep(
            model, loss_fn, learning_rate=lr_src,
            momentum=getattr(optimizer, "_momentum", 0.0),
            sparsity=cfg.get("sparsity"),
            rampup_begin_step=cfg.get("rampup_begin_step"),
            clip_norm=clip,
            weight_decay=float(optimizer._weight_decay or 0.0),
            strategy=strategy, hcg=hcg, **kw)
    return FleetTrainStep(model, loss_fn, optimizer, strategy=strategy,
                          hcg=hcg, **kw)


def quantile_points(n: int, q: float):
    """JAX's ``quantile(x, q)`` (method ``linear``) over ``n`` sorted
    values as ``(low, high, low_weight, high_weight)``: the indices and
    float32 weights, formed in float32 as ``jnp.quantile`` forms them."""
    q32 = np.float32(np.clip(np.float32(q), np.float32(0.0),
                             np.float32(1.0 - 1e-6)))
    nf = np.float32(n)
    qq = np.float32(q32 * np.float32(nf - np.float32(1)))
    low, high = np.floor(qq), np.ceil(qq)
    hw = np.float32(qq - low)
    lw = np.float32(np.float32(1) - hw)
    top = np.float32(nf - np.float32(1))
    low = np.float32(min(max(low, np.float32(0)), top))
    high = np.float32(min(max(high, np.float32(0)), top))
    return int(low), int(high), lw, hw


def dgc_threshold(flat: torch.Tensor, sparsity: float) -> torch.Tensor:
    """``jnp.quantile(flat, clip(sparsity, 0, 1 - 1e-6))`` bit for bit
    (a 0-d float32 tensor on ``flat``'s device); ``flat`` is 1-D,
    float32 and free of NaN."""
    lo, hi, lw, hw = quantile_points(flat.numel(), sparsity)
    s = torch.sort(flat).values
    lw_t = torch.full((), float(lw), dtype=torch.float32, device=flat.device)
    hw_t = torch.full((), float(hw), dtype=torch.float32, device=flat.device)
    return s[lo] * lw_t + s[hi] * hw_t


def dgc_compress(g, u, v, momentum: float, sparsity, clip_norm=None,
                 active=True):
    """One DGC step on one gradient (float32), the reference's:

      u <- m*u + g           momentum correction
      v <- v + u             error feedback
      send |v| >= quantile(|v|, sparsity); u, v zeroed where sent

    ``active`` (bool or a 0-d bool tensor on the device) is the rampup
    gate: when off, the plain momentum update is sent (``u = m*u + g``,
    nothing withheld).  Returns ``(g_send, u_new, v_new,
    sent_fraction)``."""
    if clip_norm is not None:
        norm = torch.sqrt(torch.sum(g * g)) + 1e-12
        g = g * torch.clamp(clip_norm / norm, max=1.0)
    u_c = momentum * u + g
    v_c = v + u_c
    av = torch.abs(v_c)
    thr = dgc_threshold(av.reshape(-1), sparsity)
    mask = av >= thr
    if not isinstance(active, torch.Tensor):
        active = torch.full((), bool(active), device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    g_send = torch.where(active, torch.where(mask, v_c, zero), u_c)
    v_new = torch.where(active, torch.where(mask, zero, v_c), v)
    u_new = torch.where(active, torch.where(mask, zero, u_c), u_c)
    n = torch.full((), float(np.float32(mask.numel())), dtype=torch.float32,
                   device=g.device)
    sent = mask.sum().to(torch.float32) / n
    frac = torch.where(active, sent,
                       torch.ones((), dtype=torch.float32, device=g.device))
    return g_send, u_new, v_new, frac


class DGCTrainStep(_MetaStepBase):
    """Deep Gradient Compression (the reference's
    ``DGCMomentumOptimizer``): replicated parameters, per-replica
    residuals ``u``, ``v`` (float32, ``[dp, ...]``), the replicas' sent
    gradients averaged.  ``last_sent_fraction`` is the element-weighted
    fraction of coordinates sent by the last step (read on access)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 learning_rate=0.001, momentum: float = 0.9,
                 sparsity: Optional[float] = None,
                 rampup_begin_step: Optional[int] = None,
                 clip_norm: Optional[float] = None,
                 weight_decay: float = 0.0,
                 strategy: Optional[DistributedStrategy] = None,
                 hcg: Optional[HybridCommunicateGroup] = None, keys=None):
        super().__init__(model, loss_fn, strategy, hcg, keys)
        cfg = dict(self.strategy.dgc_configs or {})
        # a float, or a callable giving the current rate (an LRScheduler
        # or an optimizer's get_lr)
        self._lr_source = learning_rate
        self.momentum = float(momentum)
        self.sparsity = float(sparsity if sparsity is not None
                              else cfg.get("sparsity", 0.75))
        self.rampup_begin_step = int(
            rampup_begin_step if rampup_begin_step is not None
            else cfg.get("rampup_begin_step", 0))
        self.clip_norm = clip_norm
        self.weight_decay = float(weight_decay)
        self.params = {n: p for n, p in self._param_info}
        self.residuals = {
            k: {n: torch.zeros((self.dp,) + tuple(p.shape),
                               dtype=torch.float32, device=p.device)
                for n, p in self._param_info}
            for k in ("u", "v")}
        self._sent_fraction = None

    @property
    def lr(self) -> float:
        return float(self._lr_source()) if callable(self._lr_source) \
            else float(self._lr_source)

    @property
    def last_sent_fraction(self):
        return None if self._sent_fraction is None \
            else float(self._sent_fraction)

    def _body(self, key, lr, step, *batch):
        # step is 1-based; "> rampup" gives exactly rampup_begin_step
        # uncompressed steps, the reference's 0-based ">="
        active = step > self.rampup_begin_step
        per_replica = []
        losses = []
        for r in range(self.dp):
            loss, grads = self._replica_grads(self.params, fold_in(key, r),
                                              self._rows(batch, r))
            losses.append(loss)
            per_replica.append(grads)
        m, wd, clip = self.momentum, self.weight_decay, self.clip_norm
        with torch.no_grad():
            sent_r = []
            total = 0
            for r in range(self.dp):
                sent = []
                for n, p in self.params.items():
                    g = per_replica[r][n]
                    g = torch.zeros_like(p, dtype=torch.float32) \
                        if g is None else g.float()
                    if wd:
                        g = g + wd * p.float()
                    gs, nu, nv, frac = dgc_compress(
                        g, self.residuals["u"][n][r],
                        self.residuals["v"][n][r], m, self.sparsity,
                        clip_norm=clip, active=active)
                    per_replica[r][n] = gs
                    self.residuals["u"][n][r].copy_(nu)
                    self.residuals["v"][n][r].copy_(nv)
                    sent.append(frac * g.numel())
                    if r == 0:
                        total += g.numel()
                sent_r.append(torch.stack(sent).sum() / total)
            for n, p in self.params.items():
                acc = per_replica[0][n]
                for r in range(1, self.dp):
                    acc = acc + per_replica[r][n]
                g_global = acc / self.dp
                p.copy_((p.float() - lr * g_global).to(p.dtype))
            acc, frac = losses[0], sent_r[0]
            for r in range(1, self.dp):
                acc, frac = acc + losses[r], frac + sent_r[r]
        return acc / self.dp, frac / self.dp

    def step(self, *batch):
        loss, sent = self._run(self._body, self.lr, batch)
        if hasattr(self._lr_source, "step"):
            try:
                self._lr_source.step()
            except TypeError:
                pass
        self._sent_fraction = sent
        return loss

    def sync_params_to_model(self):
        """The model (its parameters are the step's, updated in
        place)."""
        return self.model

    def state_dict(self):
        return self.sync_params_to_model().state_dict()


__all__ = ["LocalSGDTrainStep", "DGCTrainStep", "dgc_compress",
           "dgc_threshold", "distributed_train_step"]
