"""Optimizers, LR schedulers and gradient clipping of the port."""
from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import (Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Lars, Momentum, Optimizer, RMSProp, SGD)

__all__ = [
    "lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
    "RMSProp", "Lamb", "Lars", "Adadelta", "Adamax",
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
]
