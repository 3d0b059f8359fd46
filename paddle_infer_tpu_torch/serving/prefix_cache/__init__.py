"""Automatic prefix caching for the continuous-batching serving engine.

Port of ``paddle_infer_tpu/serving/prefix_cache/``.  ``tree.py`` holds
the radix-tree index and its ownership model; ``EngineCore`` drives it:
match on admit, copy-on-write of a shared partial tail page, retain on
finish, and LRU + watermark eviction.
"""
from .tree import PrefixCache, PrefixMatch

__all__ = ["PrefixCache", "PrefixMatch"]
