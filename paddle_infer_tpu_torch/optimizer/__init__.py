"""Optimizers of the port (``Adam``, ``AdamW``)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
