"""High-level ``Model``: ``prepare``, ``fit`` / ``evaluate`` / ``predict``
with callbacks, ``save`` / ``load`` and ``summary`` over a module.

Port of ``paddle_infer_tpu/hapi/model.py``.  A training batch is the
optimizer's eager loop: forward, ``loss.backward()``, ``Optimizer.step()``,
``clear_grad()``.  Batches (numpy arrays or CPU tensors from an
``io.DataLoader``) go to the network's device, without blocking when
they lie in pinned memory.  Each batch reads the device back once: the
loss and whatever the metrics update from (``Accuracy.compute``'s hits
on the device, or the outputs and labels) come over in one copy, as the
reference's ``float(loss.numpy())`` does for the loss.  Evaluation and
prediction run under ``torch.no_grad``.  ``summary`` tabulates the
modules that own parameters or have none below them, with output shapes
from forward hooks over a dry run when given ``input_size``;
``requires_grad`` stands for the reference's ``not stop_gradient``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..framework.io import load as pit_load
from ..framework.io import save as pit_save
from ..metric import Metric
from ..weights import from_jax_state_dict
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger


def _device(network) -> torch.device:
    p = next(network.parameters(), None)
    return torch.device("cpu") if p is None else p.device


def _to_device(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    if x.device == device:
        return x
    return x.to(device, non_blocking=x.device.type == "cpu"
                and x.is_pinned())


def _as_batch(data, device):
    """A loader item as ``(inputs, labels)`` lists of tensors on
    ``device``: one item is the inputs, two are inputs and labels, more
    are inputs and the last label."""
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            ins, labs = data[0], None
        elif len(data) == 2:
            ins, labs = data
        else:
            ins, labs = data[:-1], data[-1]
    else:
        ins, labs = data, None
    ins = list(ins) if isinstance(ins, (list, tuple)) else [ins]
    if labs is None:
        labs = []
    labs = list(labs) if isinstance(labs, (list, tuple)) else [labs]
    return [_to_device(x, device) for x in ins], \
        [_to_device(y, device) for y in labs]


def _host(tensors):
    """Numpy copies of device tensors, read back in one synchronization."""
    cuda = [t for t in tensors if t.device.type == "cuda"]
    if not cuda:
        return [t.detach().numpy() for t in tensors]
    outs = []
    for t in tensors:
        t = t.detach()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        outs.append(t)
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return [t.numpy() for t in outs]


class Model:
    """Wrap a module, ``prepare`` the optimizer, loss and metrics, then
    ``fit`` / ``evaluate`` / ``predict`` with callbacks."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        else:
            self._metrics = list(metrics) if isinstance(
                metrics, (list, tuple)) else [metrics]
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"not a Metric: {m}")
        return self

    # ------------------------------------------------------------- steps
    def _batch(self, inputs, labels):
        return _as_batch((inputs, labels) if labels is not None else inputs,
                         _device(self.network))

    def train_batch(self, inputs, labels=None):
        """One optimizer step: ``(loss, metric logs)``."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        self.network.train()
        ins, labs = self._batch(inputs, labels)
        out = self.network(*ins)
        loss = self._loss(out, *labs)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        loss_h, logs = self._read_back(loss, out, labs)
        return float(loss_h), logs

    def eval_batch(self, inputs, labels=None):
        """Loss (None without a loss or labels) and metric logs."""
        self.network.eval()
        ins, labs = self._batch(inputs, labels)
        with torch.no_grad():
            out = self.network(*ins)
            loss = self._loss(out, *labs) if self._loss and labs else None
            loss_h, logs = self._read_back(loss, out, labs)
        return (float(loss_h) if loss is not None else None), logs

    def predict_batch(self, inputs):
        """The network's output(s) as numpy."""
        self.network.eval()
        ins, _ = self._batch(inputs, None)
        with torch.no_grad():
            out = self.network(*ins)
        if isinstance(out, torch.Tensor):
            return _host([out])[0]
        return _host(list(out))

    def _read_back(self, loss, out, labs):
        """The loss and every metric's update inputs in one read; then the
        metrics updated: ``(loss as numpy or None, logs)``."""
        args = []
        for m in self._metrics if labs else ():
            got = m.compute(out, labs[0]) if hasattr(m, "compute") \
                else (out, labs[0])
            args.append(list(got) if isinstance(got, (list, tuple))
                        else [got])
        flat = ([loss] if loss is not None else []) + \
            [a for group in args for a in group]
        host = _host([t if isinstance(t, torch.Tensor)
                      else torch.as_tensor(t) for t in flat])
        loss_h = host.pop(0) if loss is not None else None
        logs = {}
        for m, group in zip(self._metrics, args):
            m.update(*[host.pop(0) for _ in group])
            acc = m.accumulate()
            names = m.name() if isinstance(m.name(), (list, tuple)) \
                else [m.name()]
            if isinstance(acc, (list, tuple, np.ndarray)):
                for name, v in zip(names, np.atleast_1d(acc)):
                    logs[name] = float(v)
            else:
                logs[names[0]] = float(acc)
        return loss_h, logs

    # ---------------------------------------------------------------- fit
    def fit(self, train_data=None, eval_data=None, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, callbacks: Optional[Sequence] = None, **kw):
        """Epoch and batch loops with the callback protocol; evaluation
        every ``eval_freq`` epochs; returns ``{"loss": [epoch means]}``."""
        cbs = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.insert(0, ProgBarLogger(log_freq, verbose))
        if save_dir and not any(isinstance(c, ModelCheckpoint)
                                for c in cbs):
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        cblist = CallbackList(cbs, self, {"epochs": epochs,
                                          "verbose": verbose})
        self.stop_training = False
        history = {"loss": []}
        cblist.on_train_begin()
        for epoch in range(epochs):
            cblist.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            losses = []
            mlogs = {}
            for step, batch in enumerate(train_data):
                cblist.on_train_batch_begin(step)
                loss, mlogs = self.train_batch(batch)
                losses.append(loss)
                cblist.on_train_batch_end(step, {"loss": loss, **mlogs})
            logs = {"loss": float(np.mean(losses)) if losses else 0.0}
            logs.update(mlogs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                elogs = self.evaluate(eval_data, verbose=0)
                logs.update({f"eval_{k}": v for k, v in elogs.items()})
            history["loss"].append(logs["loss"])
            cblist.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cblist.on_train_end({"history": history})
        return history

    def evaluate(self, eval_data, verbose=0, **kw):
        for m in self._metrics:
            m.reset()
        losses = []
        mlogs = {}
        for batch in eval_data:
            loss, mlogs = self.eval_batch(batch)
            if loss is not None:
                losses.append(loss)
        logs = dict(mlogs)
        if losses:
            logs["loss"] = float(np.mean(losses))
        if verbose:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, **kw):
        outs = []
        for batch in test_data:
            ins = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch([ins]))
        return outs

    # ---------------------------------------------------------- save/load
    def save(self, path, training=True):
        """``<path>.pdparams`` (and ``.pdopt`` with ``training``)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        pit_save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None and hasattr(
                self._optimizer, "state_dict"):
            pit_save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Parameters from ``<path>.pdparams`` (a pickle of numpy arrays,
        either package's), copied in place in each parameter's dtype
        (``skip_mismatch`` is accepted and unused, as in the reference);
        the optimizer's ``.pdopt`` too, unless ``reset_optimizer``."""
        from_jax_state_dict(self.network, pit_load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path) and hasattr(
                    self._optimizer, "set_state_dict"):
            self._optimizer.set_state_dict(pit_load(opt_path))

    def parameters(self):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype="float32"):
        return summary(self.network, input_size=input_size, dtype=dtype)


def _count(params):
    return sum(int(p.numel()) for p in params if p is not None)


def _tabulated(net):
    """The modules that get a row: the root when it owns parameters
    itself, then every descendant (shared ones at each place) that owns
    parameters or has no children, so the counts sum to the total."""
    out = []
    if _count(net.parameters(recurse=False)):
        out.append(("(root)", net))
    for name, sub in net.named_modules(remove_duplicate=False):
        if sub is net:
            continue
        is_leaf = next(sub.children(), None) is None
        owns = any(True for _ in sub.parameters(recurse=False))
        if is_leaf or owns:
            out.append((name, sub))
    return out


def summary(network, input_size=None, dtype="float32"):
    """Per-module table (``paddle.summary``): name, type, output shape
    (from a dry run on zeros of ``input_size`` when given) and parameter
    count; prints it and returns ``{"total_params", "trainable_params",
    "layers": [(name, type, shape or None, count)]}``."""
    rows = []
    tab = _tabulated(network)
    traced = False
    if input_size is not None:
        def make_hook(name):
            def hook(module, inputs, output):
                out = output[0] if isinstance(output, (tuple, list)) \
                    else output
                shape = tuple(getattr(out, "shape", ()))
                rows.append((name, type(module).__name__, shape,
                             _count(module.parameters(recurse=False))))
            return hook

        sizes = input_size if isinstance(input_size, (list, tuple)) and \
            input_size and isinstance(input_size[0], (list, tuple)) \
            else [input_size]
        handles = [sub.register_forward_hook(make_hook(name))
                   for name, sub in tab]
        try:
            dev = _device(network)
            feeds = [torch.zeros(tuple(s), dtype=getattr(torch, dtype),
                                 device=dev) for s in sizes]
            with torch.no_grad():
                network(*feeds)
            traced = True
        finally:
            for h in handles:
                h.remove()
    if not traced:
        rows = [(name, type(sub).__name__, None,
                 _count(sub.parameters(recurse=False)))
                for name, sub in tab]

    params = list(network.parameters())
    total = _count(params)
    trainable = _count(p for p in params if p.requires_grad)
    widths = (32, 18, 22, 12)
    header = ("Layer (type)", "Type", "Output Shape", "Param #")
    lines = ["-" * sum(widths),
             "".join(h.ljust(w) for h, w in zip(header, widths)),
             "=" * sum(widths)]
    for name, cls, shape, n in rows:
        shp = str(list(shape)) if shape is not None else "-"
        lines.append(name[:31].ljust(widths[0]) + cls[:17].ljust(widths[1])
                     + shp[:21].ljust(widths[2]) + f"{n:,}".rjust(8))
    lines += ["=" * sum(widths), f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * sum(widths)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable,
            "layers": rows}
