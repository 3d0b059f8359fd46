"""save_pretrained / from_pretrained and ``AutoModel`` for the port's
models.

Port of ``paddle_infer_tpu/models/pretrained.py``, in the same directory
format, so a directory saved by either package loads in the other:

  * ``config.json``: the config's plain fields plus ``architecture``
    (the class name);
  * ``model.pits``: the parameters under the JAX parameter names (the
    port's names are the same) in the ``.pits`` tensor store
    (``framework/io.py``), in the model's own dtype — bfloat16 stays
    bfloat16, bit for bit.  A tied weight is stored once, under the name
    ``named_parameters`` gives it, as the reference stores it.

``from_pretrained`` also reads the reference's ``model.pdparams`` pickle
fallback.  Loading builds the model on ``device`` (the card unless the
caller asks for the CPU) in the stored dtype and copies the weights in
through ``weights.from_jax_state_dict``.
"""
from __future__ import annotations

import importlib
import json
import os
from typing import Dict

import torch

from ..framework import io as fio
from ..weights import from_jax_state_dict

_WEIGHTS_PITS = "model.pits"
_WEIGHTS_PKL = "model.pdparams"
_CONFIG = "config.json"

def _read_config(save_dir: str) -> dict:
    with open(os.path.join(save_dir, _CONFIG)) as f:
        return json.load(f)


class AutoModel:
    """Architecture-dispatching loader: reads ``architecture`` from
    config.json and loads through that class."""

    _REGISTRY = {
        "GPTForCausalLM": ("gpt", "GPTForCausalLM"),
        "GPTMoEForCausalLM": ("gpt_moe", "GPTMoEForCausalLM"),
        "LlamaForCausalLM": ("llama", "LlamaForCausalLM"),
        "ErnieForMaskedLM": ("ernie", "ErnieForMaskedLM"),
        "ErnieForPretraining": ("ernie", "ErnieForPretraining"),
        "ErnieForSequenceClassification": (
            "ernie", "ErnieForSequenceClassification"),
    }

    @classmethod
    def _resolve(cls, save_dir: str):
        """-> (model class, config dict without 'architecture')."""
        cfg = _read_config(save_dir)
        arch = cfg.pop("architecture", None)
        entry = cls._REGISTRY.get(arch)
        if entry is None:
            raise ValueError(
                f"unknown architecture {arch!r} in {save_dir} "
                f"(known: {sorted(cls._REGISTRY)})")
        mod = importlib.import_module(f".{entry[0]}", __package__)
        return getattr(mod, entry[1]), cfg

    @classmethod
    def from_pretrained(cls, save_dir: str, device=None):
        model_cls, _ = cls._resolve(save_dir)
        return model_cls.from_pretrained(save_dir, device=device)


class AutoConfig:
    """Config-only companion to ``AutoModel``."""

    @classmethod
    def from_pretrained(cls, save_dir: str):
        model_cls, cfg = AutoModel._resolve(save_dir)
        return model_cls.config_class(**cfg)


def _stored_dtype(tensors: Dict[str, object]) -> torch.dtype:
    """The floating dtype every stored parameter shares; float32 when
    they differ (or for the pickle's numpy arrays)."""
    kinds = {t.dtype for t in tensors.values()
             if isinstance(t, torch.Tensor) and t.is_floating_point()}
    return kinds.pop() if len(kinds) == 1 else torch.float32


class PretrainedMixin:
    """Mixed into the port's model heads; subclasses set
    ``config_class``."""

    def save_pretrained(self, save_dir: str) -> None:
        os.makedirs(save_dir, exist_ok=True)
        cfg = {k: v for k, v in vars(self.config).items()
               if isinstance(v, (int, float, str, bool, list, tuple,
                                 type(None)))}
        cfg["architecture"] = type(self).__name__
        with open(os.path.join(save_dir, _CONFIG), "w") as f:
            json.dump(cfg, f, indent=1, sort_keys=True)
        fio.save_tensors(os.path.join(save_dir, _WEIGHTS_PITS),
                         dict(self.named_parameters()))

    @classmethod
    def from_pretrained(cls, save_dir: str, device=None):
        cfg = _read_config(save_dir)
        arch = cfg.pop("architecture", cls.__name__)
        if arch != cls.__name__:
            raise ValueError(
                f"{save_dir} holds a {arch}, not a {cls.__name__} — "
                f"load it with {arch}.from_pretrained")
        pits = os.path.join(save_dir, _WEIGHTS_PITS)
        tensors = fio.load(pits if os.path.exists(pits)
                           else os.path.join(save_dir, _WEIGHTS_PKL))
        model = cls(cls.config_class(**cfg), device=device,
                    dtype=_stored_dtype(tensors))
        from_jax_state_dict(model, tensors)
        model.eval()
        return model
