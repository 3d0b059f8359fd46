"""High-level API: ``Model`` with its callbacks, and ``summary`` (port of
``paddle_infer_tpu/hapi/``)."""
from .callbacks import (Callback, EarlyStopping, LRSchedulerCallback,
                        ModelCheckpoint, ProgBarLogger)
from .model import Model, summary

__all__ = ["Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
           "LRSchedulerCallback", "EarlyStopping", "summary"]
