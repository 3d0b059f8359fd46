"""Ragged mixed-batch paged attention.

Port of ``paddle_infer_tpu/ops/pallas/ragged_paged_attention.py``.  One
call serves a batch where row ``b`` carries ``query_lens[b]`` queries at
absolute positions ``context_lens[b] + i``: decode rows have
``query_len == 1``, prefill rows a prompt chunk, inactive rows 0.

Three compositions share ``ragged_paged_attention``:

* the serving composition (the default) — chunk rows (``query_len > 1``,
  not verify rows within their window; with ``decode_rows``, every
  active row not flagged) through one launch of the ragged kernel with
  the other rows' lengths set to 0; decode rows' position 0 from the
  decode kernel (``paged_attention_decode``);
  speculative verify rows' first ``verify_window`` positions from the
  verify kernel (``paged_attention_verify``), each position at its own
  length, so they equal sequential decode steps bit for bit.  The
  serving step flags its decode rows: a prompt token then always goes
  through the ragged kernel and a generated token through the decode
  kernel, whatever the chunking, which keeps a warm prefix hit bitwise
  equal to a cold prefill.
* ``_ragged_reference`` — the port's copy of the JAX package's
  composition: every position through the plain fp32 window attention
  ``prefix_prefill_attention``, decode and verify rows as above.  The
  tests hold the serving composition to it; on the CPU the two are
  bitwise equal on valid positions.
* ``use_kernel=True`` — one launch of the ragged kernel for every row
  type (no verify rows), as the JAX package's opt-in kernel path.

The ragged kernel's wrapper is ``ragged_kernel``: on a CPU tensor it
runs ``_ragged_plain``, the plain PyTorch version; on a CUDA tensor it
launches ``ragged_paged_attention`` (``csrc/paged_attention.cu``, which
replaces the Pallas ``_ragged_kernel``) or raises.

``write_ragged_pages`` is the matching scatter: valid positions land at
the row's absolute slots, pad positions go to the scratch page no live
row reads.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import (DTYPE_CODES, NEG_INF, _check_kernel_args,
                              _gather_window, _page_size,
                              _quantized_scatter, is_quantized,
                              paged_attention_decode,
                              paged_attention_verify,
                              prefix_prefill_attention)

_c = ctypes
_RAGGED = _build.register(_build.CudaKernel(
    "ragged_paged_attention", "paged_attention.cu",
    "pit_ragged_paged_attention",
    [_c.c_int, _c.c_int] + [_c.c_void_p] * 9
    + [_c.c_int] * 7 + [_c.c_float, _c.c_void_p],
    replaces="paddle_infer_tpu/ops/pallas/ragged_paged_attention.py:132"))


def write_ragged_pages(pages, block_tables, kv, context_lens, query_lens,
                       scratch_page):
    """Scatter a ragged batch's K or V ``[B, C, H, D]`` into the pool in
    place.  Row ``b``'s token ``i`` lands at absolute position
    ``context_lens[b] + i`` when ``i < query_lens[b]``; pad positions
    (including whole inactive rows) go to ``scratch_page``, slot
    ``i % page``.  On an int8 pool, pad tokens landing at the scratch
    page's slot 0 only re-seed the scratch page's scale (a masked max, so
    deterministically), which no live row reads."""
    b, c = kv.shape[:2]
    page = _page_size(pages)
    max_pages = block_tables.shape[1]
    i = torch.arange(c, device=kv.device)[None]               # [1, C]
    pos = context_lens.long()[:, None] + i                    # [B, C]
    valid = i < query_lens.long()[:, None]
    safe_pos = torch.where(valid, pos, torch.zeros_like(pos))
    page_idx = torch.gather(block_tables.long(), 1,
                            torch.clamp(safe_pos // page, 0, max_pages - 1))
    scratch = torch.as_tensor(scratch_page, device=kv.device).long()
    page_idx = torch.where(valid, page_idx, scratch)
    slot = torch.where(valid, safe_pos % page, (i % page).expand(b, c))
    if is_quantized(pages):
        return _quantized_scatter(pages, page_idx, slot, kv)
    pages[page_idx, :, slot] = kv.to(pages.dtype)
    return pages


def _decode_mask(query_lens, decode_rows):
    """Rows whose position 0 comes from the decode kernel: those with
    ``query_lens == 1``, as in the JAX reference, or, given
    ``decode_rows [B] bool``, only the flagged ones among them."""
    one = query_lens == 1
    return one if decode_rows is None else one & decode_rows


def _decode_and_verify_rows(out, q, k_pages, v_pages, block_tables,
                            context_lens, query_lens, scale, verify_rows,
                            verify_window, decode_rows=None):
    """Decode rows' position 0 and verify rows' first ``verify_window``
    positions of ``out``, in place.  The decode kernel runs for ALL rows
    at ``context_lens + 1`` and the rows of ``_decode_mask`` keep it.

    ``verify_rows [B] bool`` marks speculative verify rows (``query_lens
    = k + 1``: last emitted token + ``k`` drafts).  The verify kernel
    runs for ALL rows over the first ``verify_window`` positions, lane
    ``j`` at ``min(ctx + j + 1, ctx + max(qlen, 1))`` (the clamp keeps
    short and non-verify rows inside their valid KV; their lanes are
    discarded), and flagged rows take those lanes."""
    dec = paged_attention_decode(q[:, 0].contiguous(), k_pages, v_pages,
                                 block_tables, (context_lens + 1).int(),
                                 scale=scale)
    is_decode = _decode_mask(query_lens, decode_rows)[:, None, None]
    out[:, 0] = torch.where(is_decode, dec, out[:, 0])
    if verify_rows is None:
        return out
    w = int(verify_window)
    j = torch.arange(w, dtype=torch.int32, device=q.device)[None]   # [1, W]
    ctxv = context_lens[:, None] + j + 1                            # [B, W]
    ctxv = torch.minimum(ctxv, (context_lens + torch.clamp(
        query_lens, min=1))[:, None]).int().contiguous()
    decv = paged_attention_verify(q[:, :w].contiguous(), k_pages, v_pages,
                                  block_tables, ctxv, scale=scale)
    sel = verify_rows[:, None, None, None]
    out[:, :w] = torch.where(sel, decv, out[:, :w])
    return out


def _ragged_reference(q, k_pages, v_pages, block_tables, context_lens,
                      query_lens, scale=None, verify_rows=None,
                      verify_window=None):
    """The JAX package's composition: every position through the plain
    fp32 window attention, then decode and verify rows
    (``_decode_and_verify_rows``).  Positions ``i >= query_lens`` hold
    garbage the caller never reads."""
    out = prefix_prefill_attention(q, k_pages, v_pages, block_tables,
                                   context_lens, scale=scale)
    return _decode_and_verify_rows(out, q, k_pages, v_pages, block_tables,
                                   context_lens, query_lens, scale,
                                   verify_rows, verify_window)


def _ragged_serving(q, k_pages, v_pages, block_tables, context_lens,
                    query_lens, scale=None, verify_rows=None,
                    verify_window=None, decode_rows=None):
    """The serving composition: chunk rows (active rows outside
    ``_decode_mask``) through one ragged-kernel launch (every other row
    at length 0, so its positions are zeros), then decode and verify
    rows as in ``_ragged_reference``.  Pad positions of chunk rows are
    zeros.  A verify row whose length exceeds ``verify_window`` counts
    as a chunk row too: its positions past the window come from the
    ragged kernel, as they come from the window attention in
    ``_ragged_reference``."""
    chunk = (query_lens > 0) & ~_decode_mask(query_lens, decode_rows)
    if verify_rows is not None:
        chunk = chunk & ~(verify_rows & (query_lens <= int(verify_window)))
    out = ragged_kernel(q.contiguous(), k_pages, v_pages, block_tables,
                        context_lens,
                        torch.where(chunk, query_lens,
                                    torch.zeros_like(query_lens)),
                        scale=scale)
    return _decode_and_verify_rows(out, q, k_pages, v_pages, block_tables,
                                   context_lens, query_lens, scale,
                                   verify_rows, verify_window, decode_rows)


def _ragged_plain(q, k_pages, v_pages, block_tables, context_lens,
                  query_lens, scale=None):
    """Plain PyTorch version of the ragged kernel: query ``i`` of row
    ``b`` attends slots ``<= context_lens[b] + i`` in float32; positions
    ``i >= query_lens[b]`` (and inactive rows) are zero, as the kernel
    writes them."""
    b, c, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kw = _gather_window(k_pages, block_tables)
    vw = _gather_window(v_pages, block_tables)
    w = kw.shape[1]
    i = torch.arange(c, device=q.device)
    pos = context_lens.long()[:, None] + i[None]                 # [B, C]
    mask = torch.arange(w, device=q.device)[None, None, :] <= pos[:, :, None]
    s = torch.einsum("bchd,bwhd->bhcw", q.to(torch.float32), kw) * scale
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bhcw,bwhd->bchd", torch.softmax(s, dim=-1), vw)
    valid = i[None] < query_lens.long()[:, None]
    out = torch.where(valid[:, :, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _ragged_cuda(q, k_pages, v_pages, block_tables, context_lens,
                 query_lens, scale=None):
    _build.require_cuda()
    kvdt, k, v, ks, vs = _check_kernel_args(
        q, k_pages, v_pages, block_tables, (context_lens, query_lens))
    b, c, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    p = _build.ptr
    _RAGGED(DTYPE_CODES[q.dtype], kvdt, p(q), p(k), p(v),
            p(ks) if ks is not None else None,
            p(vs) if vs is not None else None,
            p(block_tables), p(context_lens), p(query_lens), p(out),
            b, k.shape[0], c, h, d, k.shape[2], block_tables.shape[1],
            float(scale), _build.stream_ptr())
    return out


def ragged_kernel(q, k_pages, v_pages, block_tables, context_lens,
                  query_lens, scale=None):
    """The ragged kernel's wrapper: plain version on a CPU ``q``, the
    ``ragged_paged_attention`` CUDA kernel on a CUDA ``q`` (contiguous
    int32 tables and lengths required), otherwise raise."""
    if q.device.type == "cpu":
        return _ragged_plain(q, k_pages, v_pages, block_tables,
                             context_lens, query_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _ragged_cuda(q, k_pages, v_pages, block_tables, context_lens,
                        query_lens, scale)


def ragged_paged_attention(q, k_pages, v_pages, block_tables,
                           context_lens, query_lens, scale=None,
                           use_kernel=False, verify_rows=None,
                           verify_window=None, decode_rows=None):
    """Mixed-batch ragged attention over paged KV.

    q            [B, C, H, D]    — per-row query chunk
    k_pages      [P, H, page, D] — shared head-major pool
    v_pages      [P, H, page, D]
    block_tables [B, max_pages] int32
    context_lens [B] int32       — tokens already cached per row
    query_lens   [B] int32       — 1 decode, >1 prefill chunk, 0 inactive

    verify_rows  [B] bool       — optional: speculative verify rows
                                  whose first ``verify_window`` (int)
                                  positions take per-position
                                  decode-kernel math
    decode_rows  [B] bool       — optional: the rows feeding a generated
                                  token; only they (at query_len 1) take
                                  the decode kernel, so a prompt chunk of
                                  one token still goes through the ragged
                                  kernel.  Default: every query_len-1 row
                                  is a decode row, as in the reference
    → [B, C, H, D]; positions past ``query_lens`` are zeros, except a
      verify row's first ``verify_window`` (finite lanes, never read).

    ``use_kernel=False`` (default) runs the serving composition
    (``_ragged_serving``: chunk rows through the ragged kernel, decode
    and verify rows through their kernels); ``use_kernel=True`` one
    launch of the ragged kernel for every row, which takes no verify
    rows."""
    if use_kernel:
        if verify_rows is not None or decode_rows is not None:
            raise NotImplementedError(
                "speculative verify rows require the per-row-type "
                "composition (per-position decode-kernel parity)")
        return ragged_kernel(q, k_pages, v_pages, block_tables,
                             context_lens, query_lens, scale=scale)
    return _ragged_serving(q, k_pages, v_pages, block_tables, context_lens,
                           query_lens, scale=scale, verify_rows=verify_rows,
                           verify_window=verify_window,
                           decode_rows=decode_rows)
