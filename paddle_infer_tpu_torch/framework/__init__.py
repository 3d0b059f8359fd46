"""Checkpoint files of the port (``io``: the ``.pits`` tensor store and
the ``.pdparams`` pickle)."""
from .io import load, load_tensors, save, save_tensors

__all__ = ["load", "load_tensors", "save", "save_tensors"]
