"""Carry a JAX model's weights into its port.

``from_jax_state_dict(model, state)`` takes the JAX model's
``state_dict()`` (``paddle_infer_tpu/nn/layer.py``) as
``{name: numpy array}`` — the port never imports the JAX package, the
caller converts — and copies every tensor into the port model's
parameter of the same name, cast to that parameter's dtype, on its
device.  Any missing, extra or mis-shaped key raises before anything is
copied.  A tied weight (ERNIE's MLM head shares the word embedding) is
listed under each of its names, as the JAX ``state_dict()`` lists it;
the copies given must be equal.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def from_jax_state_dict(model: nn.Module, state: Dict[str, np.ndarray]):
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    bad = [(k, tuple(np.shape(state[k])), tuple(t.shape))
           for k, t in own.items() if tuple(np.shape(state[k])) !=
           tuple(t.shape)]
    if bad:
        raise ValueError(f"shape mismatch (name, given, expected): {bad}")
    first = {}
    for name, t in model.state_dict(keep_vars=True).items():
        other = first.setdefault(id(t), name)
        if other != name and not np.array_equal(np.asarray(state[other]),
                                                np.asarray(state[name])):
            raise ValueError(f"tied weights {other!r} and {name!r} differ "
                             "in the given state")
    with torch.no_grad():
        for name, t in own.items():
            src = torch.tensor(np.asarray(state[name], dtype=np.float32))
            t.copy_(src.to(device=t.device, dtype=t.dtype))
    return model
