"""Attention ops: rotary embedding and the fused ``sdpa``.

Ports of ``paddle_infer_tpu/ops/attention.py``: ``rope`` (``_rope``),
``sdpa`` with its choice of implementation (``_sdpa``,
``_attn_impl_choice``), the plain attention ``_xla_sdpa`` and
``_seed_from_key``.
"""
from __future__ import annotations

import math

import torch

from ..core import random as R
from . import _build
from . import flash_attention as FA


def rope(x: torch.Tensor, position_ids: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over ``[b, s, h, d]`` in the rotate-half
    convention, angles in float32.  ``position_ids`` holds absolute
    positions, ``[b, s]`` or ``[s]``."""
    d = x.shape[-1]
    half = d // 2
    pos = position_ids.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=x.device), exps)
    ang = pos[:, :, None] * inv[None, None, :]          # [b, s, half]
    cos = torch.cos(ang)[:, :, None, :]                 # [b, s, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _xla_sdpa(q, k, v, mask, seed, dropout_p, is_causal, scale,
              q_segment_ids=None, kv_segment_ids=None):
    """Plain attention over ``(b, s, h, d)``: float32 logits and softmax,
    masked entries at ``NEG_INF`` with the kernels' causal, segment and
    ``dropout_keep`` grids (folded head ``b*h + h``), dead segment rows
    0, probabilities cast to q's dtype before the value product."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        m = mask
        if m.dtype == torch.bool:
            m = torch.where(m, 0.0, FA.NEG_INF)
        logits = logits + m.float()
    seg_ok = None
    if q_segment_ids is not None:
        seg_ok = FA._seg_ok(q_segment_ids.to(torch.int32),
                            kv_segment_ids.to(torch.int32), h) \
            .reshape(b, h, sq, sk)
        logits = torch.where(seg_ok, logits, FA.NEG_INF)
    if is_causal:
        logits = torch.where(FA._causal_ok(sq, sk, q.device), logits,
                             FA.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p and seed is not None:
        keep = FA._keep_grid(seed, b * h, sq, sk, dropout_p, q.device)
        probs = torch.where(keep.reshape(b, h, sq, sk),
                            probs / (1.0 - dropout_p), 0.0)
    if seg_ok is not None:
        # rows whose every key is masked: zero, the kernels' convention
        probs = torch.where(seg_ok.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _attn_impl_choice(q, k, mask):
    """``"xla"`` (the plain path) for a CPU tensor or a dense mask, else
    ``"flash"`` (kernels 4–6); on the card a head_dim the kernels do not
    take raises rather than running plain attention.  The reference's
    ``hybrid`` band (512 <= s < 4096) came from a v5e measurement and is
    not carried over."""
    if q.device.type != "cuda" or mask is not None:
        return "xla"
    if q.shape[-1] not in FA.HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {q.shape[-1]}: the flash kernels take "
            f"{FA.HEAD_DIMS}")
    return "flash"


def sdpa(q, k, v, mask=None, key=None, q_segment_ids=None,
         kv_segment_ids=None, dropout_p=0.0, is_causal=False, scale=None):
    """Fused attention over ``(b, s, h, d)``; ``key`` seeds the dropout
    mask when ``dropout_p`` (its scalar uint32 ``bits``).  A CUDA
    tensor without a card raises."""
    if q.device.type == "cuda":
        _build.require_cuda()
    seed = R.seed_from_key(key) if dropout_p else None
    if _attn_impl_choice(q, k, mask) == "flash":
        return FA.flash_attention(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
            dropout_seed=seed, is_causal=is_causal, scale=scale)
    return _xla_sdpa(q, k, v, mask, seed, dropout_p, is_causal, scale,
                     q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids)
