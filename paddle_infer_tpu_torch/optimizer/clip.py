"""Gradient clipping: by global norm, by each tensor's norm, by value.

Port of ``paddle_infer_tpu/optimizer/clip.py``.  ``functional_clip``
takes ``{name: gradient}`` (a None gradient is a zero one and stays
None) and returns the clipped gradients; ``__call__`` takes the eager
``[(param, grad)]`` list and leaves a parameter with ``need_clip =
False`` alone.  Norms, scales and the minimum are device tensors: no
value is read back to the host, so a CUDA graph of the train step holds
the clip.  Norms accumulate in float32 and the clipped gradient keeps
its dtype, as in the reference.
"""
from __future__ import annotations

import torch


def _scale(norm, clip_norm):
    """``min(1, clip_norm / max(norm, 1e-6))`` as a float32 device
    scalar."""
    num = torch.full((), clip_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-6), max=1.0)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def _eager(clip, params_grads):
    """``clip.functional_clip`` over the gradients of ``params_grads``
    whose parameter has ``need_clip`` (default True)."""
    grads = {i: g for i, (p, g) in enumerate(params_grads)
             if g is not None and getattr(p, "need_clip", True)}
    if not grads:
        return list(params_grads)
    clipped = clip.functional_clip(grads)
    return [(p, clipped.get(i, g)) for i, (p, g) in enumerate(params_grads)]


class ClipGradBase:
    def __call__(self, params_grads):
        return _eager(self, params_grads)

    def functional_clip(self, grads: dict) -> dict:
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient times ``min(1, clip_norm / max(||g||, 1e-6))``,
    ``||g||`` the norm of all of them together (summed in the order of
    their sorted names, as the reference's pytree leaves)."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def functional_clip(self, grads: dict) -> dict:
        leaves = [grads[n] for n in sorted(grads, key=str)
                  if grads[n] is not None]
        if not leaves:
            return dict(grads)
        sq = torch.stack([torch.sum(torch.square(g.float()))
                          for g in leaves])
        scale = _scale(torch.sqrt(torch.sum(sq)), self.clip_norm)
        return {n: None if g is None else _scaled(g, scale)
                for n, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Each gradient times ``min(1, clip_norm / max(||g||, 1e-6))`` of
    its own norm."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def functional_clip(self, grads: dict) -> dict:
        def clip_one(g):
            norm = torch.linalg.vector_norm(g.float())
            return _scaled(g, _scale(norm, self.clip_norm))

        return {n: None if g is None else clip_one(g)
                for n, g in grads.items()}


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def functional_clip(self, grads: dict) -> dict:
        return {n: None if g is None else torch.clamp(g, self.min, self.max)
                for n, g in grads.items()}
