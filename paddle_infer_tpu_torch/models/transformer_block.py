"""Transformer blocks of the serving and training paths.

Port of ``paddle_infer_tpu/models/transformer_block.py``:

* ``ParallelSelfAttention``: QKV split, RoPE, GQA expansion and three
  cache forms.  The paged cache of ``_forward_paged``: four elements
  for the engines' own ``generate`` / ``stream`` / beam programs (a
  prompt writes its pages and attends causally through ``sdpa``, a
  token is written and attends through the paged decode kernel), six
  to eight for the ragged step that ``serving/programs.build_mixed_step``
  drives (the seventh element is the speculative-verify flag, the
  eighth the decode-row flag); pools are tensors or int8 ``(payload,
  scales)`` pairs.  The static cache ``(k_buf, v_buf, index)`` of the
  dense ``GenerationEngine``, with the ``kv_cache_mask`` bound and an
  additive ``attn_mask``, on the plain attention path.  With no cache
  the block calls ``sdpa`` (``ops/attention.py``) as the JAX block
  does: on the card the flash kernels, causal or not, with padding
  masks as segment ids and attention dropout in training.  The
  five-element windowed prefill cache of the legacy prefix-cache
  programs (``serving/programs.build_prefix_prefill``) writes a chunk
  at its offset and attends over the row's whole page window (the
  table it is given, scratch columns appended included).  On a
  serving mesh the block runs per
  shard (``_forward_mesh``): each replica group's rows through every mp
  shard's heads (its QKV columns, split by head within each of q, k and
  v, its pool shard, one attention launch), the output projection's
  partials summed in rank order.  A training mesh takes the same path
  with live slices of the parameters, and the layer's one dropout draw
  is offset per shard (``ops.attention.shard_seed``).
* ``ParallelMLP`` (with its act-dropout) and ``ParallelTransformerLayer``
  in both forms: post-LN (ERNIE/BERT, the default, as in the reference)
  and pre-LN (``normalize_before=True``, GPT); with ``num_experts > 1``
  the FFN is a ``parallel.moe.MoELayer`` (``moe_gate``, ``moe_top_k``,
  ``moe_capacity_factor``), as in the reference.
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
                         RowParallelLinear, _to, mesh_shards, mp_block,
                         mp_sum, row_groups)
from ..ops import paged_attention as PA
from ..ops import ragged_paged_attention as RPA
from .. import amp
from ..ops.attention import rope, shard_offset, shard_seed
from ..parallel import topology


class ParallelSelfAttention(nn.Module):
    """Self-attention with fused QKV ``[hidden, (hq + 2*hkv) * d]``,
    optional causality, RoPE (``rope_theta``), GQA (``num_kv_heads``)
    and attention dropout (``dropout``, in training, keys from
    ``keys``)."""

    def __init__(self, hidden, num_heads, dropout=0.0, causal=False,
                 rope_theta=None, num_kv_heads=None, keys=None,
                 seq_parallel=None, device=None, dtype=torch.float32):
        super().__init__()
        if seq_parallel not in (None, "ring", "ulysses"):
            raise ValueError(f"seq_parallel {seq_parallel!r}: None, 'ring' "
                             "or 'ulysses'")
        self.seq_parallel = seq_parallel
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
        # a mesh splits the fused QKV by head within each of q, k and v
        self.qkv_proj._qkv_heads = (num_heads, self.num_kv_heads,
                                    self.head_dim)

    def _project(self, qkv, b, s, hq, hkv, kv_index, position_ids):
        """``[b, s, (hq+2*hkv)*d]`` -> q, k, v ``[b, s, hq, d]``: split,
        RoPE, and GQA's K/V expanded to the query heads post-RoPE (so
        pools and kernels see plain multi-head attention); ``kv_index``
        maps a mesh shard's query heads to its K/V heads."""
        d = self.head_dim
        q, k, v = torch.split(qkv.reshape(b, s, hq + 2 * hkv, d),
                              (hq, hkv, hkv), dim=2)
        if self.rope_theta:
            if position_ids is None:
                position_ids = torch.arange(s, device=qkv.device)
            q = rope(q, position_ids, theta=self.rope_theta)
            k = rope(k, position_ids, theta=self.rope_theta)
        if kv_index is not None:
            k = k.index_select(2, kv_index)
            v = v.index_select(2, kv_index)
        elif hkv != hq:
            k = torch.repeat_interleave(k, hq // hkv, dim=2)
            v = torch.repeat_interleave(v, hq // hkv, dim=2)
        return q, k, v

    def forward(self, x, attn_mask=None, cache=None, segment_ids=None,
                position_ids=None):
        sq = mesh_shards(self.qkv_proj)
        if sq is not None:
            return self._forward_mesh(sq, x, attn_mask, cache, segment_ids,
                                      position_ids)
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._project(self.qkv_proj(x), b, s, self.num_heads,
                                self.num_kv_heads, None, position_ids)
        out, new_cache = self._attend(q, k, v, cache, attn_mask,
                                      segment_ids)
        out = self.out_proj(out)
        return out if cache is None else (out, new_cache)

    def _attend(self, q, k, v, cache, attn_mask, segment_ids, seed=None):
        """Attention over ``q, k, v [b, s, h, d]`` through the cache's
        form: ``(out [b, s, h * d], new cache or None)``.  ``seed`` is a
        mesh shard's dropout seed; without a cache and with
        ``seq_parallel`` on a mesh whose ``sep`` splits, ring or Ulysses
        attention over ``sep``."""
        b, s, h = q.shape[0], q.shape[1], q.shape[2]
        if cache is not None and len(cache) >= 4:
            out, new_cache = self._forward_paged(q, k, v, cache, attn_mask)
        elif cache is not None:
            out, new_cache = self._forward_static(q, k, v, cache, attn_mask)
        elif self.seq_parallel and _sep_mesh() is not None:
            from ..parallel import sequence_parallel as SP

            fn = (SP.ring_attention if self.seq_parallel == "ring"
                  else SP.ulysses_attention)
            out = fn(*(amp.cast(t, "sdpa") for t in (q, k, v)),
                     mesh=_sep_mesh(), is_causal=self.causal)
            new_cache = None
        else:
            out = PF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=self.dropout if self.training else 0.0,
                is_causal=self.causal, q_segment_ids=segment_ids,
                kv_segment_ids=segment_ids, keys=self.keys, seed=seed)
            new_cache = None
        return out.reshape(b, s, h * self.head_dim), new_cache

    def _forward_mesh(self, sq, x, attn_mask, cache, segment_ids,
                      position_ids):
        """The block on a mesh: each replica group's rows through every
        mp shard (its heads' QKV columns, its pool shard, one kernel
        launch over its heads, its rows of the output projection), the
        partial outputs summed in rank order, the bias added once."""
        mesh = sq.mesh
        so = mesh_shards(self.out_proj)
        b = x.shape[0]
        groups = row_groups(mesh, b)
        base = None
        if cache is None and self.training and self.dropout \
                and not self.seq_parallel:
            # one draw for the layer, offset per shard as the reference's
            # _mesh_sharded_attn offsets it
            base = PF._draw_seed(None, self.keys)
        outs = []
        for g, rows in groups:
            per = []
            for r in range(sq.n):
                dev = mesh.device(dp=g, mp=r)
                hq, hkv, kv_index = sq.heads[r] if sq.heads else (
                    self.num_heads, self.num_kv_heads, None)
                xg = _to(x[rows], dev)
                q, k, v = self._project(
                    sq.product(r, xg, rows), xg.shape[0], xg.shape[1], hq, hkv,
                    kv_index, _batch_rows(position_ids, rows, b))
                seed = None if base is None else shard_seed(
                    base, shard_offset(g if len(groups) > 1 else None,
                                       r if sq.n > 1 else None))
                o, _ = self._attend(q, k, v, _shard_cache(cache, r, rows, b),
                                    _batch_rows(attn_mask, rows, b),
                                    _batch_rows(segment_ids, rows, b),
                                    seed=seed)
                per.append(o)
            if so is not None and so.n == sq.n:
                y = so.finish(mp_sum([so.product(r, o, rows)
                                      for r, o in enumerate(per)]))
            else:
                y = self.out_proj(torch.cat(
                    [_to(o, per[0].device) for o in per], dim=-1))
            outs.append(_to(y, mesh.controller))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return out if cache is None else (out, _advance(cache, x.shape[1]))

    def _forward_static(self, q, k, v, cache, attn_mask):
        """Static-cache step of the dense engine: ``cache`` is ``(k_buf
        [b, L, h, d], v_buf, index)``, the chunk lands at slots ``index
        .. index + s - 1`` (the buffers are updated in place) and
        attends to the slots ``<= index + i`` (``kv_cache_mask``, which
        also carries causality within the chunk) plus ``attn_mask``,
        on the plain attention path as the reference's masked call.
        Returns ``(out, (k_buf, v_buf, index + s))``."""
        if len(cache) != 3:
            raise NotImplementedError(
                f"{len(cache)}-element caches are not a cache form of the "
                "port (3: static, 4: paged, 6-8: ragged)")
        k_buf, v_buf, index = cache
        b, s = q.shape[0], q.shape[1]
        slots = index.long() + torch.arange(s, device=q.device)
        k_buf.index_copy_(1, slots, k.to(k_buf.dtype))
        v_buf.index_copy_(1, slots, v.to(v_buf.dtype))
        mask = kv_cache_mask(index, s, k_buf.shape[1])
        if attn_mask is not None:
            mask = attn_mask + mask
        out = PF.scaled_dot_product_attention(q, k_buf, v_buf,
                                              attn_mask=mask, dropout_p=0.0,
                                              is_causal=False)
        return out, (k_buf, v_buf, index + s)

    def _forward_paged(self, q, k, v, cache, attn_mask=None):
        """Paged step.  A four-element ``cache`` ``(k_pages, v_pages,
        tables [b, max_pages], positions [b])`` is the engines' own:
        ``positions`` counts the tokens each row already holds.  A
        prompt (``s > 1``, a multiple of the page size, right-padded)
        writes its pages (``write_prompt_pages``) and attends causally
        over itself through ``sdpa`` — on an int8 pool over the bytes it
        just wrote (``gather_prompt_pages``), so it sees what every later
        reader sees; a token (``s == 1``) is written at its row's
        position (``write_token_page``) and attends through
        ``paged_attention_decode``.  Returns ``(out, cache)`` with
        positions advanced by ``s``.

        A five-element ``cache`` ``(k_pages, v_pages, tables, offsets
        [b], marker [b])`` is the windowed suffix prefill of the legacy
        prefix-cache programs: the chunk's tokens sit at ``offsets[b] +
        i`` (a cached prefix may end mid-page), are written there
        (``write_chunk_pages``) and attend over the row's whole gathered
        page window under an absolute-position causal mask
        (``prefix_prefill_attention``), so the cached prefix takes part.

        Otherwise the ragged mixed-batch step: ``cache`` is the six-tuple
        ``(k_pages [P,h,page,d], v_pages, tables [b,max_pages],
        positions [b], query_lens [b], scratch_page)``: row ``b``'s
        tokens sit at ``positions[b] + i`` for ``i < query_lens[b]``,
        pad positions write to the scratch page.  A pool is a tensor or
        an int8 ``(payload, scales)`` pair.  A seventh element
        ``spec2d [b, W] bool`` (the verify flag broadcast over the draft
        window, whose width is W; None for no verify rows) routes
        flagged rows' first W positions through the verify kernel, and
        an eighth ``decode [b] bool`` marks the rows feeding a generated
        token (without it every one-token row counts as one).  The pools
        are updated in place; returns ``(out, new_cache)`` with
        positions advanced."""
        if len(cache) == 4:
            return self._forward_pages(q, k, v, cache, attn_mask)
        if len(cache) == 5:
            k_pages, v_pages, tables, offsets, marker = cache
            PA.write_chunk_pages(k_pages, tables, k, offsets)
            PA.write_chunk_pages(v_pages, tables, v, offsets)
            out = PA.prefix_prefill_attention(q, k_pages, v_pages, tables,
                                              offsets)
            return out, (k_pages, v_pages, tables, offsets + q.shape[1],
                         marker)
        if len(cache) not in (6, 7, 8):
            raise NotImplementedError(
                f"{len(cache)}-element paged caches are not a cache form "
                "of the port (4: paged, 5: windowed, 6-8: ragged)")
        k_pages, v_pages, tables, positions, qlens, scratch = cache[:6]
        verify = cache[6] if len(cache) > 6 else None
        decode = cache[7] if len(cache) > 7 else None
        b, s = q.shape[0], q.shape[1]
        RPA.write_ragged_pages(k_pages, tables, k, positions, qlens, scratch)
        RPA.write_ragged_pages(v_pages, tables, v, positions, qlens, scratch)
        out = RPA.ragged_paged_attention(
            q, k_pages, v_pages, tables, positions, qlens,
            verify_rows=None if verify is None else verify[:, 0],
            verify_window=None if verify is None else verify.shape[1],
            decode_rows=decode)
        return out, (k_pages, v_pages, tables, positions + qlens, qlens,
                     scratch) + tuple(cache[6:])


    def _forward_pages(self, q, k, v, cache, attn_mask):
        k_pages, v_pages, tables, positions = cache
        b, s = q.shape[0], q.shape[1]
        if s > 1:
            PA.write_prompt_pages(k_pages, tables, k)
            PA.write_prompt_pages(v_pages, tables, v)
            if PA.is_quantized(k_pages):
                # the dequantized float32 bytes, in the queries' dtype:
                # the flash kernel takes one dtype (a no-op at fp32)
                k = PA.gather_prompt_pages(k_pages, tables, s).to(q.dtype)
                v = PA.gather_prompt_pages(v_pages, tables, s).to(q.dtype)
            out = PF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=0.0, is_causal=True)
        else:
            PA.write_token_page(k_pages, tables, k[:, 0], positions)
            PA.write_token_page(v_pages, tables, v[:, 0], positions)
            out = PA.paged_attention_decode(q[:, 0].contiguous(), k_pages,
                                            v_pages, tables,
                                            positions + 1)[:, None]
        return out, (k_pages, v_pages, tables, positions + s)


def _sep_mesh():
    """The current mesh when its ``sep`` axis splits, else None."""
    mesh = topology.get_current_mesh()
    return mesh if mesh is not None and mesh.shape["sep"] > 1 else None


def _batch_rows(t, rows, b):
    """``t``'s rows of a replica group when its dim 0 is the batch."""
    if t is None or not isinstance(t, torch.Tensor) or t.dim() == 0 \
            or t.shape[0] != b:
        return t
    return t[rows]


def _shard_cache(cache, r, rows, b):
    """Mp shard ``r``'s view of a layer's cache for one replica group:
    its pool shard (or static buffers) and the group's rows of every
    per-row element."""
    if cache is None:
        return None
    if len(cache) == 3:
        k_buf, v_buf, index = cache
        return (k_buf[r][rows], v_buf[r][rows], index)
    return (cache[0][r], cache[1][r]) + tuple(
        _batch_rows(t, rows, b) for t in cache[2:])


def _advance(cache, s):
    """A layer's cache after a step of ``s`` tokens (the pools and
    buffers were written in place)."""
    if len(cache) == 3:
        return (cache[0], cache[1], cache[2] + s)
    if len(cache) in (4, 5):
        return cache[:3] + (cache[3] + s,) + tuple(cache[4:])
    return cache[:3] + (cache[3] + cache[4],) + tuple(cache[4:])


def kv_cache_mask(index, q_len, kv_len):
    """Additive mask over a static KV buffer (the reference's
    ``kv_cache_mask`` op): query ``i``, at absolute position ``index +
    i``, sees slot ``j`` iff ``j <= index + i``; 0 there, -1e9 elsewhere,
    float32 ``[q_len, kv_len]``."""
    i = torch.arange(q_len, device=index.device)[:, None]
    j = torch.arange(kv_len, device=index.device)[None, :]
    valid = j <= index.long() + i
    return torch.where(valid, torch.zeros((), device=index.device),
                       torch.full((), -1e9, device=index.device))


class ParallelMLP(nn.Module):
    """``fc2(dropout(act(fc1(x))))`` (the Megatron column -> row split:
    on a mesh each shard runs its columns of ``fc1`` into its rows of
    ``fc2``, the partials summed once).  ``gelu`` is the exact erf form,
    the reference's default."""

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
        pl = topology.get_current_placement()
        # an active act-dropout draws one mask over the whole hidden
        # activation (global indices, as the reference's), so training
        # with dropout gathers fc1's shards first
        if pl is not None and not (self.training and self.dropout.p):
            s1, s2 = pl.get(self.fc1), pl.get(self.fc2)
            if s1 is not None and s2 is not None and s1.n == s2.n > 1:
                return mp_block(x, [s1], lambda h: self.dropout(
                    self.activation(h)), s2)
        return self.fc2(self.dropout(self.activation(self.fc1(x))))


class ParallelTransformerLayer(nn.Module):
    """One encoder/decoder block: post-LN by default (ERNIE/BERT:
    ``norm1(x + dropout1(attn(x)))``, then ``norm2(x +
    dropout2(mlp(x)))``), pre-LN with ``normalize_before`` (GPT).
    Dropout is an identity in eval."""

    def __init__(self, hidden, num_heads, ffn_hidden, dropout=0.1,
                 attn_dropout=None, activation="gelu",
                 normalize_before=False, causal=False,
                 layer_norm_eps=1e-12, num_experts=1, moe_gate="gshard",
                 moe_top_k=2, moe_capacity_factor=2.0, keys=None,
                 seq_parallel=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = ParallelSelfAttention(
            hidden, num_heads,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            causal=causal, keys=keys, seq_parallel=seq_parallel, **kw)
        if int(num_experts) > 1:
            # the reference's fused_multi_transformer_moe FFN: E expert
            # MLPs behind a gate (parallel/moe.py)
            from ..parallel.moe import MoELayer

            self.mlp = MoELayer(hidden, ffn_hidden, int(num_experts),
                                gate=moe_gate, top_k=moe_top_k,
                                capacity_factor=moe_capacity_factor,
                                activation=activation, **kw)
        else:
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
