"""Functional ops of the training path.

Ports of ``paddle_infer_tpu/nn/functional/__init__.py`` (``dropout``,
``cross_entropy``, ``scaled_dot_product_attention``, ``gelu``,
``tanh``) and the op bodies behind them (``ops/activation.py``
``_dropout``, ``ops/loss.py`` ``_softmax_ce``).  Every op follows the O2
rule of ``amp.py``: its float operands go through ``amp.cast``, or
``amp.black`` for a black-listed op.

Randomness is explicit: a dropping op takes a ``key`` or a
``core.random.KeyStream`` (``keys``) to draw one from.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..core import random as R
from ..ops import attention as A
from ..ops.flash_attention import _mix32, _mul32, keep_threshold


def _draw(key, keys):
    if key is not None:
        return key
    if keys is None:
        raise ValueError("dropout in training needs a key or a KeyStream "
                         "(keys=)")
    return keys.next_key()


def _dropout(x, key, p=0.5, upscale=True):
    """Counter-hash dropout (``ops/activation.py::_dropout``): keep
    element ``i`` (row-major linear index) iff ``mix32(i * 0x9E3779B1 ^
    seed) >= thresh``, ``seed = bits(key)``; kept values scaled by
    ``1 / (1 - p)`` in ``x``'s dtype."""
    seed = R.seed_from_key(key)
    lin = torch.arange(x.numel(), dtype=torch.int64,
                       device=x.device).reshape(x.shape)
    keep = _mix32(_mul32(lin, 0x9E3779B1) ^ seed) >= keep_threshold(p)
    scale = (1.0 / (1.0 - float(p))) if upscale else 1.0
    return torch.where(keep, x * torch.tensor(scale, dtype=x.dtype,
                                              device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, p=0.5, training=True, mode="upscale_in_train", key=None,
            keys=None):
    """Hash-RNG dropout; an identity outside training or at ``p == 0``."""
    if not training or p == 0.0:
        return x
    x = amp.cast(x)
    if p >= 1.0:
        return x * 0.0
    return _dropout(x, _draw(key, keys), p=float(p),
                    upscale=(mode == "upscale_in_train"))


def gelu(x, approximate=False):
    return F.gelu(amp.cast(x), approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(amp.cast(x))


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""
    out = torch.matmul(amp.cast(x), amp.cast(weight))
    return out + amp.cast(bias) if bias is not None else out


def embedding(ids, weight):
    return F.embedding(ids.long(), amp.cast(weight))


def layer_norm(x, normalized_shape, weight, bias, epsilon):
    """float32 statistics, the input's dtype in and out (under O2 the
    operands are cast to the compute dtype first, as the JAX package's
    dispatcher casts them)."""
    x, weight, bias = amp.cast(x), amp.cast(weight), amp.cast(bias)
    return F.layer_norm(x.float(), normalized_shape,
                        None if weight is None else weight.float(),
                        None if bias is None else bias.float(),
                        epsilon).to(x.dtype)


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """``softmax_with_cross_entropy`` semantics: ``loss = lse - logit
    [label]`` with the log-sum-exp in float32, 0 at ``ignore_index``;
    ``reduction`` "mean" (over every element, or over the non-ignored
    ones when ``ignore_index`` is not -100), "sum" or "none"."""
    logits = amp.cast(input)
    if axis not in (-1, logits.dim() - 1):
        logits = logits.movedim(axis, -1)
    lbl = label.long()
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1,
                          torch.where(valid, lbl, 0)[..., None])[..., 0]
    loss = torch.where(valid, lse - picked.float(), 0.0)
    loss = amp.cast(loss)          # the op's squeeze computes under O2
    if reduction == "mean":
        if ignore_index != -100:
            denom = torch.clamp(valid.float().sum(), min=1.0)
            return amp.black(loss).sum() / denom
        return amp.black(loss).mean()
    if reduction == "sum":
        return amp.black(loss).sum()
    return loss


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 q_segment_ids=None, kv_segment_ids=None,
                                 keys=None):
    """``(batch, seq, heads, head_dim)`` attention through
    ``ops.attention.sdpa``; with dropout in training the key is drawn
    from ``keys``.  Padding and packing masks ride as int32
    ``{q,kv}_segment_ids`` (the flash kernels take those); a dense
    ``attn_mask`` goes to the plain path."""
    key = None
    if dropout_p and training:
        key = _draw(None, keys)
    else:
        dropout_p = 0.0
    q, k, v = amp.cast(q), amp.cast(k), amp.cast(v)
    return A.sdpa(q, k, v, attn_mask, key, q_segment_ids, kv_segment_ids,
                  dropout_p=dropout_p, is_causal=is_causal, scale=scale)
