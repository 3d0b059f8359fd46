"""Training callbacks: ``Callback``, ``CallbackList``, ``ProgBarLogger``,
``ModelCheckpoint``, ``LRSchedulerCallback`` and ``EarlyStopping``.

Port of ``paddle_infer_tpu/hapi/callbacks.py``, hook for hook.
``LRSchedulerCallback`` ticks the optimizer's ``optimizer/lr.py``
scheduler per epoch, or per batch with ``by_step``.
"""
from __future__ import annotations

import os
import time
from typing import Optional


class Callback:
    """The reference's hook points; each does nothing by default."""

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model, params):
        self.callbacks = list(callbacks)
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)


def _fmt(logs):
    return " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                      else f"{k}: {v}" for k, v in logs.items())


class ProgBarLogger(Callback):
    """Per-epoch progress and metric printing."""

    def __init__(self, log_freq: int = 10, verbose: int = 1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and logs and step % self.log_freq == 0:
            print(f"  step {step}: {_fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose and logs:
            dur = time.time() - self._start
            print(f"  epoch done in {dur:.1f}s - {_fmt(logs)}")


class ModelCheckpoint(Callback):
    """Save parameters and optimizer every ``save_freq`` epochs
    (``<dir>/<epoch>.pdparams`` / ``.pdopt``) and at the end
    (``<dir>/final``)."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRSchedulerCallback(Callback):
    """Tick the optimizer's ``LRScheduler`` once per epoch, or once per
    batch with ``by_step``."""

    def __init__(self, by_step: bool = False):
        self.by_step = by_step

    def _sched(self):
        lr = getattr(self.model._optimizer, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if not self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop when ``monitor`` has not improved by ``min_delta`` for more
    than ``patience`` epochs (``mode`` "min" or "max"; ``baseline`` the
    value to beat first)."""

    def __init__(self, monitor="loss", patience=0, min_delta=0.0,
                 mode="min", baseline=None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: min or max")
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.mode = mode
        self.baseline = baseline
        self.best = None
        self.wait = 0
        self.stopped_epoch = None

    def _better(self, cur, best):
        return (cur < best - self.min_delta) if self.mode == "min" \
            else (cur > best + self.min_delta)

    def on_train_begin(self, logs=None):
        self.best = self.baseline
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait > self.patience:
            self.stopped_epoch = epoch
            self.model.stop_training = True
