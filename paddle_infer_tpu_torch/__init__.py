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
speculative draft/verify serving, the prefix cache, int8 KV pages,
exclusive requests, weight-only and int8-activation quantization
(``quantization``) and multi-LoRA adapter tenancy
(``serving.adapters``), the disaggregated fleet, Mixture-of-Experts
serving and sharded serving over tensor-parallel, replica and expert
meshes (``serving.sharded``, ``parallel.topology``,
``parallel.collective``); the engines' own ``generate`` / ``stream`` /
beam search (paged and dense); and ERNIE pretraining and fine-tuning
on one device (``parallel.FleetTrainStep`` with recompute, gradient
merge and AMP O1 / O2, or the eager ``optimizer.step()`` loop with
``amp.auto_cast`` and ``GradScaler`` → ``models.ErnieForPretraining``,
``ErnieForMaskedLM``, ``ErnieForSequenceClassification`` → the
flash-attention kernels in bf16 or f16; the reference's optimizers, LR
schedulers, clips and regularizers).  On the card
both steps run as one CUDA graph per key (``core/graphs.py``), each
capture logged by ``observability/compilelog.py``.
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
