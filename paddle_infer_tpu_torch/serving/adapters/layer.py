"""Serving LoRA wrapper layers and the in-place model conversion.

Port of ``paddle_infer_tpu/serving/adapters/layer.py``.
``LoRAServingLinear`` wraps one target projection (a float
``ColumnParallelLinear`` / ``RowParallelLinear`` or a weight-only
``WeightOnlyLinear``) and adds the per-row LoRA delta
``scale[slot] * ((x @ A[slot]) @ B[slot])`` to its output.  The stacked
pools ``lora_a [S, d_in, r]``, ``lora_b [S, r, d_out]`` and
``lora_scale [S]`` (float32) are registered buffers on the model's
device: a captured step graph reads them by address, and the
``AdapterCache`` copies a slot's factors into them in place, so which
adapter a row runs is data and no graph is captured again.

Slot 0 is the identity adapter: its rows stay zero, so rows without an
adapter take the same gather.

On an mp or mp x dp serving mesh the engine's placement slices the
wrapper as its base layer (``nn.layers.LinearShards``): a column
target's shard adds its columns of B's delta, a row target's shard the
delta of its rows of A, which joins the partial sum before the
rank-order reduction (the reference shards the pools with the base
weight, ``dist_attr``).  The shards read the pools at run time, so an
upload reaches every shard's slice in place.

Dtypes.  The reference adds ``y + scale * delta`` under jnp promotion,
which turns a bf16 projection's output into float32.  Here the delta is
computed in float32 (``x`` cast to float32, as jnp promotes it), added
to ``y`` in float32, and the sum is cast back to ``y``'s dtype.  At
float32 this is the reference exactly; at bf16 the projection keeps its
dtype, so the next layer's attention stays on the 16-bit kernels and a
slot-0 row is bitwise the base model (``0 * delta`` adds nothing).

``prepare_lora_serving`` converts a model in place; ``lora_serving_info``
describes a converted model; ``adapter_layer_spec`` gives the
``{path: (d_in, d_out)}`` contract an ``AdapterStore`` validates
checkpoints against, on converted and unconverted models alike.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import slots as lora_slots

# projection attribute names the conversion targets by default: the four
# linears of ParallelTransformerLayer.  LLaMA names its MLP
# gate/up/down_proj, so there only qkv_proj and out_proj are targets, as
# in the reference
DEFAULT_TARGETS = ("qkv_proj", "out_proj", "fc1", "fc2")


def _features_of(layer) -> tuple:
    """(d_in, d_out) of a linear-like target layer."""
    d_in = getattr(layer, "in_features", None)
    d_out = getattr(layer, "out_features", None)
    if d_in is None or d_out is None:
        w = getattr(layer, "weight", None)
        if w is None or w.dim() != 2:
            raise TypeError(
                f"cannot infer (in, out) features of "
                f"{type(layer).__name__}")
        d_in, d_out = int(w.shape[0]), int(w.shape[1])
    return int(d_in), int(d_out)


def _is_linear_like(layer) -> bool:
    if not isinstance(layer, nn.Module) \
            or isinstance(layer, LoRAServingLinear):
        return False
    try:
        _features_of(layer)
    except TypeError:
        return False
    return True


def _device_of(layer):
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return None


class LoRAServingLinear(nn.Module):
    """One target projection bound to a stacked adapter-slot pool.
    ``slots`` and ``rank`` are deployment constants (part of the mixed
    step's program key).  The forward reads the step's per-row slot
    vector from the side-channel and passes through when none is
    active."""

    def __init__(self, inner, slots: int, rank: int):
        super().__init__()
        if isinstance(inner, LoRAServingLinear):
            raise TypeError("LoRAServingLinear cannot wrap itself")
        if not _is_linear_like(inner):
            raise TypeError(
                f"LoRAServingLinear wraps a linear projection, got "
                f"{type(inner).__name__}")
        if int(slots) < 2:
            raise ValueError(
                f"adapter slots must be >= 2 (slot 0 is the reserved "
                f"identity), got {slots}")
        if int(rank) < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.inner = inner
        self.slots = int(slots)
        self.rank = int(rank)
        d_in, d_out = _features_of(inner)
        self.in_features = d_in
        self.out_features = d_out
        dev = _device_of(inner)
        self.register_buffer("lora_a", torch.zeros(
            (self.slots, d_in, self.rank), dtype=torch.float32, device=dev))
        self.register_buffer("lora_b", torch.zeros(
            (self.slots, self.rank, d_out), dtype=torch.float32, device=dev))
        self.register_buffer("lora_scale", torch.zeros(
            (self.slots,), dtype=torch.float32, device=dev))
        # the pools split with their base weight on an mp mesh: a column
        # target's B by its output dim, a row target's A by its input
        # dim (each shard's delta then joins its partial sum)
        kind = (getattr(inner, "_mp_kind", None) if hasattr(inner, "qweight")
                else getattr(inner, "_KIND", None))
        if kind == "column":
            self.lora_b.dist_attr = (None, None, "mp")
        elif kind == "row":
            self.lora_a.dist_attr = (None, "mp", None)

    def forward(self, x):
        y = self.inner(x)
        rows = lora_slots.row_slots()
        if rows is None:
            return y
        sl = rows.long()                              # [b]
        ga = self.lora_a[sl]                          # [b, d_in, r]
        gb = self.lora_b[sl]                          # [b, r, d_out]
        gs = self.lora_scale[sl]                      # [b]
        delta = torch.bmm(x.to(torch.float32), ga)    # [b, s, r]
        delta = torch.bmm(delta, gb)                  # [b, s, d_out]
        return (y.to(torch.float32) + gs[:, None, None] * delta).to(y.dtype)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"slots={self.slots}, rank={self.rank}, "
                f"base={type(self.inner).__name__}")


def lora_layers(model):
    """Yield ``(path, LoRAServingLinear)`` for every converted target
    projection, in traversal order (the key adapter checkpoints address
    factors by)."""
    for path, sub in model.named_modules():
        if isinstance(sub, LoRAServingLinear):
            yield path, sub


def adapter_layer_spec(model, targets=DEFAULT_TARGETS) -> dict:
    """``{path: (d_in, d_out)}`` for every projection the conversion
    targets.  Works on unconverted and converted models (the wrapper
    sits at the target's path)."""
    spec = {}
    for path, sub in model.named_modules():
        name = path.rsplit(".", 1)[-1]
        if isinstance(sub, LoRAServingLinear):
            spec[path] = (sub.in_features, sub.out_features)
        elif name in targets and _is_linear_like(sub) \
                and not path.endswith(".inner"):
            spec[path] = _features_of(sub)
    return spec


def lora_serving_info(model) -> Optional[dict]:
    """``{slots, rank, layers, pool_hbm_bytes}`` of a converted model,
    or None.  Layers disagreeing on ``(slots, rank)`` are rejected: the
    serving plane keys one stacked-pool shape per deployment."""
    layers = [lay for _, lay in lora_layers(model)]
    if not layers:
        return None
    dims = {(lay.slots, lay.rank) for lay in layers}
    if len(dims) != 1:
        from ..sharded import ShardedConfigError

        raise ShardedConfigError(
            f"LoRA layers disagree on (slots, rank) ({sorted(dims)}); "
            "the serving plane keys one stacked-pool shape per "
            "deployment config")
    slots, rank = dims.pop()
    pool_bytes = sum(
        t.numel() * t.element_size() for lay in layers
        for t in (lay.lora_a, lay.lora_b, lay.lora_scale))
    return {"slots": int(slots), "rank": int(rank),
            "layers": len(layers), "pool_hbm_bytes": int(pool_bytes)}


def prepare_lora_serving(model, slots: int, rank: int,
                         targets=DEFAULT_TARGETS) -> int:
    """Wrap every target projection of ``model`` (in place) in a
    :class:`LoRAServingLinear` bound to ``(slots, rank)``.  Idempotent:
    a converted layer is rebound to new dims (its pools reset to the
    identity) instead of wrapped twice.  Returns the number of
    projections serving."""
    n = 0

    def visit(layer):
        nonlocal n
        for name, sub in list(layer.named_children()):
            if isinstance(sub, LoRAServingLinear):
                if sub.slots != int(slots) or sub.rank != int(rank):
                    setattr(layer, name,
                            LoRAServingLinear(sub.inner, slots, rank))
                n += 1
            elif name in targets and _is_linear_like(sub):
                setattr(layer, name, LoRAServingLinear(sub, slots, rank))
                n += 1
            else:
                visit(sub)

    visit(model)
    return n
