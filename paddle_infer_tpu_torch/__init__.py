"""PyTorch + CUDA port of ``paddle_infer_tpu`` for NVIDIA Hopper.

The JAX package ``paddle_infer_tpu`` stays the reference; this package
mirrors its module paths and class names so each counterpart is easy to
find (``serving/engine_core.py`` here ports ``serving/engine_core.py``
there).  It imports ``torch`` and numpy only — never ``jax`` and never
the JAX package.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card
they raise instead of moving to the CPU; tests pass ``device="cpu"``
explicitly.  On the CPU every hand-written kernel's wrapper runs the
kernel's plain PyTorch version, because the tensor it was given lies on
the CPU; on a CUDA tensor it launches the kernel or raises.

What is ported so far: the ragged continuous-batching serving path of
``ROADMAP.md`` slice A (``EngineCore`` → ``build_mixed_step`` →
``PagedGenerationEngine`` → LLaMA/GPT → ragged paged attention), with
speculative draft/verify serving; and ERNIE pretraining on one device
(``parallel.FleetTrainStep`` → ``models.ErnieForPretraining`` → the
flash-attention kernels, ``optimizer.AdamW``, ``amp`` O2).
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The card.  Raises when CUDA is absent — the port never picks the
    CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_infer_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' explicitly to run the "
            "plain PyTorch versions")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` and ``"cuda"`` mean the card (raising without one); any
    other value is taken as given."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    return dev
