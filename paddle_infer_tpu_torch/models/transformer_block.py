"""Transformer blocks of the serving and training paths.

Port of ``paddle_infer_tpu/models/transformer_block.py``:

* ``ParallelSelfAttention``: QKV split, RoPE, GQA expansion, and the
  six- and seven-element-cache ragged branch of ``_forward_paged`` that
  ``serving/programs.build_mixed_step`` drives (the seventh element is
  the speculative-verify flag).  With no cache the block calls ``sdpa``
  (``ops/attention.py``) as the JAX block does: on the card the flash
  kernels, causal or not, with padding masks as segment ids and
  attention dropout in training.  The legacy 4- and 5-element paged
  caches of the reference are not ported yet (ROADMAP.md) and raise.
* ``ParallelMLP`` (with its act-dropout) and ``ParallelTransformerLayer``
  in both forms: post-LN (ERNIE/BERT, the default, as in the reference)
  and pre-LN (``normalize_before=True``, GPT).  MoE FFNs raise.
  Parameter names follow the JAX package so
  ``weights.from_jax_state_dict`` maps them.

Dropout keys come from the ``KeyStream`` passed as ``keys``, drawn in
the JAX order: the ``sdpa`` key, ``dropout1``, the MLP's act-dropout,
``dropout2``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import functional as PF
from ..nn.layers import (ColumnParallelLinear, Dropout, LayerNorm,
                         RowParallelLinear)
from ..ops import ragged_paged_attention as RPA
from ..ops.attention import rope


class ParallelSelfAttention(nn.Module):
    """Self-attention with fused QKV ``[hidden, (hq + 2*hkv) * d]``,
    optional causality, RoPE (``rope_theta``), GQA (``num_kv_heads``)
    and attention dropout (``dropout``, in training, keys from
    ``keys``)."""

    def __init__(self, hidden, num_heads, dropout=0.0, causal=False,
                 rope_theta=None, num_kv_heads=None, keys=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        self.hidden = hidden
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        self.head_dim = hidden // num_heads
        self.dropout = dropout
        self.causal = causal
        self.keys = keys
        self.rope_theta = rope_theta
        qkv_out = (num_heads + 2 * self.num_kv_heads) * self.head_dim
        self.qkv_proj = ColumnParallelLinear(hidden, qkv_out,
                                             device=device, dtype=dtype)
        self.out_proj = RowParallelLinear(hidden, hidden, device=device,
                                          dtype=dtype)

    def _split_qkv(self, qkv, b, s):
        """[b, s, (hq+2*hkv)*d] -> q [b,s,hq,d], k/v [b,s,hkv,d]."""
        hq, hkv, d = self.num_heads, self.num_kv_heads, self.head_dim
        qkv = qkv.reshape(b, s, hq + 2 * hkv, d)
        return torch.split(qkv, (hq, hkv, hkv), dim=2)

    def forward(self, x, attn_mask=None, cache=None, segment_ids=None,
                position_ids=None):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._split_qkv(self.qkv_proj(x), b, s)
        if self.rope_theta:
            if position_ids is None:
                position_ids = torch.arange(s, device=x.device)
            q = rope(q, position_ids, theta=self.rope_theta)
            k = rope(k, position_ids, theta=self.rope_theta)
        if self.num_kv_heads != self.num_heads:
            # GQA: expand K/V to the query heads post-RoPE, so pools and
            # kernels see plain multi-head attention
            rep = self.num_heads // self.num_kv_heads
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        if cache is not None:
            return self._forward_paged(q, k, v, cache)
        out = PF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            is_causal=self.causal, q_segment_ids=segment_ids,
            kv_segment_ids=segment_ids, keys=self.keys)
        return self.out_proj(out.reshape(b, s, self.hidden))

    def _forward_paged(self, q, k, v, cache):
        """Ragged mixed-batch paged step.  ``cache`` is the six-tuple
        ``(k_pages [P,h,page,d], v_pages, tables [b,max_pages],
        positions [b], query_lens [b], scratch_page)``: row ``b``'s
        tokens sit at ``positions[b] + i`` for ``i < query_lens[b]``,
        pad positions write to the scratch page.  A seventh element
        ``spec2d [b, W] bool`` (the verify flag broadcast over the draft
        window, whose width is W) routes flagged rows' first W positions
        through the verify kernel.  The pools are updated in place;
        returns ``(out, new_cache)`` with positions advanced."""
        if len(cache) not in (6, 7):
            raise NotImplementedError(
                f"{len(cache)}-element paged caches (legacy prefill and "
                "prefix-cache windowed) are not ported yet; see ROADMAP.md")
        k_pages, v_pages, tables, positions, qlens, scratch = cache[:6]
        verify = cache[6] if len(cache) == 7 else None
        b, s = q.shape[0], q.shape[1]
        RPA.write_ragged_pages(k_pages, tables, k, positions, qlens, scratch)
        RPA.write_ragged_pages(v_pages, tables, v, positions, qlens, scratch)
        out = RPA.ragged_paged_attention(
            q, k_pages, v_pages, tables, positions, qlens,
            verify_rows=None if verify is None else verify[:, 0],
            verify_window=None if verify is None else verify.shape[1])
        out = self.out_proj(out.reshape(b, s, self.hidden))
        return out, (k_pages, v_pages, tables, positions + qlens, qlens,
                     scratch) + tuple(cache[6:])


class ParallelMLP(nn.Module):
    """``fc2(dropout(act(fc1(x))))`` (Megatron column→row split; one
    device here).  ``gelu`` is the exact erf form, the reference's
    default."""

    _ACT = {"gelu": PF.gelu, "silu": F.silu}

    def __init__(self, hidden, ffn_hidden, activation="gelu", dropout=0.0,
                 keys=None, device=None, dtype=torch.float32):
        super().__init__()
        if activation not in self._ACT:
            raise ValueError(f"activation {activation!r} not ported")
        self.fc1 = ColumnParallelLinear(hidden, ffn_hidden, device=device,
                                        dtype=dtype)
        self.fc2 = RowParallelLinear(ffn_hidden, hidden, device=device,
                                     dtype=dtype)
        self.activation = self._ACT[activation]
        self.dropout = Dropout(dropout, keys=keys)

    def forward(self, x):
        return self.fc2(self.dropout(self.activation(self.fc1(x))))


class ParallelTransformerLayer(nn.Module):
    """One encoder/decoder block: post-LN by default (ERNIE/BERT:
    ``norm1(x + dropout1(attn(x)))``, then ``norm2(x +
    dropout2(mlp(x)))``), pre-LN with ``normalize_before`` (GPT).
    Dropout is an identity in eval."""

    def __init__(self, hidden, num_heads, ffn_hidden, dropout=0.1,
                 attn_dropout=None, activation="gelu",
                 normalize_before=False, causal=False,
                 layer_norm_eps=1e-12, num_experts=1, keys=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if int(num_experts) > 1:
            raise NotImplementedError(
                "MoE FFNs are not ported yet; see ROADMAP.md slice B")
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = ParallelSelfAttention(
            hidden, num_heads,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            causal=causal, keys=keys, **kw)
        self.mlp = ParallelMLP(hidden, ffn_hidden, activation, dropout,
                               keys=keys, **kw)
        self.norm1 = LayerNorm(hidden, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(hidden, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, keys=keys)
        self.dropout2 = Dropout(dropout, keys=keys)

    def forward(self, x, attn_mask=None, cache=None, segment_ids=None,
                position_ids=None):
        residual = x
        if self.normalize_before:
            x = self.norm1(x)
        h = self.self_attn(x, attn_mask, cache=cache,
                           segment_ids=segment_ids,
                           position_ids=position_ids)
        if cache is not None:
            h, new_cache = h
        x = residual + self.dropout1(h)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        if self.normalize_before:
            x = self.norm2(x)
        x = residual + self.dropout2(self.mlp(x))
        if not self.normalize_before:
            x = self.norm2(x)
        return (x, new_cache) if cache is not None else x
