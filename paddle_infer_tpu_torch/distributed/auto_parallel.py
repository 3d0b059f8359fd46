"""Semi-automatic parallelism: annotations and the ``Engine``.

Port of ``paddle_infer_tpu/distributed/auto_parallel.py``.  The
reference places an annotated array on its mesh with ``device_put`` and
lets GSPMD complete every other layout.  The port's mesh holds each
tensor whole on its device and the mesh-aware layers run each shard's
block (``parallel/``), so an annotation is a record: ``shard_tensor``
stamps ``dist_attr`` on the tensor, as the tensor-parallel layers stamp
their parameters (``nn.layers._stamp``), and ``FleetTrainStep`` reads
it into ``param_specs``.  ``Engine`` drives ``FleetTrainStep`` over the
hybrid mesh (``fit`` / ``evaluate`` / ``predict``), reports the step's
cost (``cost``, ``distributed/cost_model.py``) and searches mesh
factorizations by timing them (``tune``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import ProcessMesh


def _spec_from(shard_spec, mesh: ProcessMesh) -> tuple:
    """``[None, "mp", ...]`` validated against the mesh's dim names."""
    clean = []
    for s in shard_spec:
        if s is None:
            clean.append(None)
        else:
            assert s in mesh.dim_names, (
                f"unknown mesh dim {s!r}; mesh has {mesh.dim_names}")
            clean.append(s)
    return tuple(clean)


def shard_tensor(x, process_mesh: ProcessMesh, shard_spec: Sequence):
    """Annotate ``x`` with its per-dim sharding (``dist_attr``); a
    non-tensor becomes a tensor first.  Returns the tensor."""
    spec = _spec_from(shard_spec, process_mesh)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{t.dim()} dims")
    t.dist_attr = spec
    return t


def shard_op(op_fn, process_mesh: ProcessMesh,
             in_shard_specs: Optional[List] = None,
             out_shard_specs: Optional[List] = None):
    """Annotate one call's operand and result layouts: the specs are
    validated and each tensor result carries its ``dist_attr``."""
    ins = [None if s is None else _spec_from(s, process_mesh)
           for s in (in_shard_specs or [])]
    outs = [None if s is None else _spec_from(s, process_mesh)
            for s in (out_shard_specs or [])]

    def wrapped(*args, **kwargs):
        for a, s in zip(args, ins):
            if s is not None and isinstance(a, torch.Tensor) \
                    and len(s) > a.dim():
                raise ValueError(f"input spec {s} exceeds {a.dim()} dims")
        out = op_fn(*args, **kwargs)
        if outs:
            seq = out if isinstance(out, (tuple, list)) else (out,)
            for o, s in zip(seq, outs):
                if s is not None and isinstance(o, torch.Tensor):
                    o.dist_attr = s
        return out

    return wrapped


class Strategy:
    """Engine knobs (the reference's ``auto_parallel.Strategy``): AMP,
    recompute and sharding, forwarded to the fleet strategy."""

    def __init__(self, amp=False, recompute=False, sharding=False,
                 sharding_stage=1):
        self.amp = amp
        self.recompute = recompute
        self.sharding = sharding
        self.sharding_stage = sharding_stage


class Engine:
    """The high-level entry point (the reference's ``Engine``): one
    ``FleetTrainStep`` over the hybrid mesh per batch signature.
    ``devices`` are the mesh's (default: the model's device, once);
    a ``process_mesh`` with hybrid-axis dim names becomes the mesh."""

    def __init__(self, model, loss_fn=None, optimizer=None, metrics=None,
                 strategy: Optional[Strategy] = None,
                 process_mesh: Optional[ProcessMesh] = None, devices=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy or Strategy()
        self.process_mesh = process_mesh
        self.devices = list(devices) if devices is not None else None
        self._step = None
        self._tuned_degrees = None

    def _device(self):
        return next(self.model.parameters()).device

    def _fleet_strategy(self):
        from ..parallel import DistributedStrategy

        st = DistributedStrategy()
        if self._tuned_degrees:
            st.hybrid_configs = dict(st.hybrid_configs, **{
                f"{a}_degree": d for a, d in self._tuned_degrees.items()})
        elif self.process_mesh is not None:
            st.hybrid_configs = dict(st.hybrid_configs, **{
                f"{a}_degree": d for a, d in zip(self.process_mesh.dim_names,
                                                 self.process_mesh.shape)})
        if self.strategy.amp:
            st.amp = True
        if self.strategy.recompute:
            st.recompute = True
        if self.strategy.sharding:
            st.sharding = True
            st.sharding_configs = {"stage": self.strategy.sharding_stage}
        return st

    def _ensure_step(self):
        if self._step is not None:
            return
        from ..parallel import FleetTrainStep, fleet

        st = self._fleet_strategy()
        if fleet._state.hcg is None:
            devices = self.devices
            if devices is None:
                n = (int(np.prod(self.process_mesh.shape))
                     if self.process_mesh is not None else 1)
                devices = [self._device()] * n
            fleet.init(strategy=st, devices=devices)
        self._step = FleetTrainStep(self.model, self.loss_fn,
                                    self.optimizer, strategy=st)

    def _batch(self, batch):
        dev = self._device()
        ins = batch if isinstance(batch, (tuple, list)) else (batch,)
        return [torch.as_tensor(np.asarray(b)).to(dev)
                if not isinstance(b, torch.Tensor) else b.to(dev)
                for b in ins]

    def fit(self, train_data, epochs=1, verbose=0):
        """``train_data``: an iterable of batch tuples.  Returns
        ``{"loss": [mean loss per epoch]}``."""
        self._ensure_step()
        history = []
        for epoch in range(epochs):
            losses = []
            for batch in train_data:
                losses.append(float(self._step(*batch).item()))
            history.append(float(np.mean(losses)))
            if verbose:
                print(f"epoch {epoch}: loss={history[-1]:.4f}")
        return {"loss": history}

    def predict(self, data):
        self.model.eval()
        outs = []
        try:
            with torch.no_grad():
                for batch in data:
                    out = self.model(*self._batch(batch))
                    outs.append(out.detach().cpu().numpy())
        finally:
            self.model.train()
        return outs

    def evaluate(self, data):
        self._ensure_step()
        losses = []
        with torch.no_grad():
            for batch in data:
                loss = self.loss_fn(self.model, *self._batch(batch))
                losses.append(float(loss.item()))
        return {"loss": float(np.mean(losses))}

    def cost(self, *sample_batch):
        """The step's cost on ``sample_batch`` (``cost_model``)."""
        from .cost_model import estimate_step_cost

        self._ensure_step()
        return estimate_step_cost(self._step, *sample_batch)

    def tune(self, sample_batch, model_fn, axes=("dp", "mp"),
             measure_steps: int = 3, verbose: bool = False,
             optimizer_fn=None):
        """Time each mesh factorization of the engine's devices and
        rebuild the step under the fastest (the reference's
        ``OptimizationTuner``).  ``model_fn`` builds a fresh model per
        trial; ``optimizer_fn(params)`` its optimizer (default: the
        engine optimizer's class at its learning rate, with a warning)."""
        from .cost_model import _reset_fleet, tune_parallelism

        if optimizer_fn is None:
            if self.optimizer is None:
                raise ValueError(
                    "Engine.tune needs an optimizer: construct the "
                    "Engine with one or pass optimizer_fn=")
            import warnings

            template = self.optimizer
            warnings.warn(
                "Engine.tune default optimizer rebuild keeps only the "
                "learning rate — pass optimizer_fn= to carry weight "
                "decay / grad clip / betas into the timed trials",
                UserWarning)

            def optimizer_fn(params):
                return type(template)(learning_rate=template._lr,
                                      parameters=list(params))

        devices = self.devices or [self._device()]
        report = tune_parallelism(model_fn, self.loss_fn, optimizer_fn,
                                  sample_batch, axes=axes,
                                  measure_steps=measure_steps,
                                  verbose=verbose, devices=devices)
        self.tune_report = report
        _reset_fleet()
        self._step = None
        self._tuned_degrees = report.best
        return report


__all__ = ["ProcessMesh", "shard_tensor", "shard_op", "Engine", "Strategy"]
