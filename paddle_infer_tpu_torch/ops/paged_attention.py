"""Paged-attention decode and the paged-KV page utilities.

Port of ``paddle_infer_tpu/ops/pallas/paged_attention.py``.  KV lives in
a head-major page pool ``[num_pages, H, page, D]`` indexed by per-row
page tables from the native allocator (``native.py``).

The page writers (``write_prompt_pages``, ``write_chunk_pages``,
``write_token_page``) and the prompt-page reader
(``gather_prompt_pages``) are plain PyTorch, as the JAX package computes
them outside Pallas.

``paged_attention_decode`` is the wrapper of the hand-written CUDA
kernel ``paged_decode_kernel`` (``csrc/paged_attention.cu``), which
replaces the Pallas ``_decode_kernel``; ``paged_attention_verify`` wraps
``paged_verify_kernel``, which replaces ``_verify_kernel`` (W query
lanes per row, lane ``w`` bit for bit the decode kernel at its own
length).  Each kernel splits a row's pages over blocks of
``split_pages()`` pages and merges the splits in a fixed order through
a float32 workspace the wrapper allocates.  On a CPU tensor a wrapper
runs the kernel's plain PyTorch version (``_decode_plain``,
``_verify_plain``); on a CUDA tensor it launches the kernel or raises.

Quantized pools are ``(int8 payload [P, H, page, D], float32 scales
[P, H])`` pairs, one scale per (page, head).  Scale protocol (the
reference's): a page's scale is set ONLY by the write landing in slot 0
(the page's lowest position) — amax over that token's D, divided by
127, floored at ``KV_SCALE_EPS``.  Every later write into the page
quantizes with the inherited scale (clipping at ±127).  Slot 0 is the
lowest position, so a slot-0 rewrite happens only when no earlier token
of the page is live: the (scales, payload) bits are a pure function of
the token stream, whatever the chunking of the writes.  That is what
keeps warm prefix hits and speculative re-writes bitwise equal in the
quantized domain.  ``quantize_pages`` builds such pools offline; the
page writers below (``_quantized_scatter``) build them incrementally,
in plain PyTorch as the JAX package computes them outside Pallas.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
KV_SCALE_EPS = 1e-8
_QMAX = 127.0

# the C side's dtype codes (csrc/paged_attention.cu ``DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}

_c = ctypes
_DECODE = _build.register(_build.CudaKernel(
    "paged_decode", "paged_attention.cu", "pit_paged_decode",
    [_c.c_int, _c.c_int] + [_c.c_void_p] * 9
    + [_c.c_int] * 6 + [_c.c_float, _c.c_void_p],
    replaces="paddle_infer_tpu/ops/pallas/paged_attention.py:140"))
_VERIFY = _build.register(_build.CudaKernel(
    "paged_verify", "paged_attention.cu", "pit_paged_verify",
    [_c.c_int, _c.c_int] + [_c.c_void_p] * 9
    + [_c.c_int] * 7 + [_c.c_float, _c.c_void_p],
    replaces="paddle_infer_tpu/ops/pallas/paged_attention.py:317"))
_split_pages = None


def split_pages() -> int:
    """Pages of a row per decode / verify block (the kernels' one
    ``kSplitPages``), read once from the built source."""
    global _split_pages
    if _split_pages is None:
        fn = _build.load(_DECODE.source).pit_paged_split_pages
        fn.restype = _c.c_int
        _split_pages = int(fn())
    return _split_pages


def _workspace(rows, max_pages, d, device):
    """The splits' (m, l, acc[D]) in float32: ``[*rows, splits, D + 2]``
    with ``rows`` the leading dims (``(B, H)`` or ``(B, W, H)``)."""
    splits = -(-max_pages // split_pages())
    return torch.empty(*rows, splits, d + 2, dtype=torch.float32,
                       device=device)


def is_quantized(pages) -> bool:
    """True when ``pages`` is an (int8 payload, float32 scales) pair."""
    return isinstance(pages, (tuple, list)) and len(pages) == 2


def quantize_pages(pages):
    """fp pool ``[P, H, page, D]`` → (int8 payload, ``[P, H]`` scales)
    under the slot-0 scale protocol: each (page, head) scale is the
    slot-0 token's amax / 127, floored at ``KV_SCALE_EPS``."""
    f = pages.to(torch.float32)
    tok0 = f[:, :, 0, :].abs()
    scales = torch.clamp(tok0.amax(dim=-1) / _QMAX, min=KV_SCALE_EPS)
    payload = torch.clamp(torch.round(f / scales[:, :, None, None]),
                          -_QMAX, _QMAX).to(torch.int8)
    return payload, scales


def dequantize_pages(pages):
    """(payload, scales) → float32 pool; fp pools pass through."""
    if not is_quantized(pages):
        return pages
    payload, scales = pages
    return payload.to(torch.float32) * scales[:, :, None, None]


def _page_size(pages) -> int:
    return (pages[0] if is_quantized(pages) else pages).shape[2]


def kv_dequant_error_bound(fp_pages, scales) -> float:
    """Worst-case elementwise ``|dequantize(quantize(x)) - x|`` over a
    pool, from the realized per-(page, head) scales of the slot-0
    protocol: ``scale / 2`` for rounding plus the clipping excess
    wherever a later token exceeds ``_QMAX * scale``.  Host numpy in
    (``[P, H, page, D]`` fp values, ``[P, H]`` scales), exact given the
    data."""
    fp = np.asarray(fp_pages, np.float32)
    sc = np.asarray(scales, np.float32)[:, :, None, None]
    clip = np.maximum(np.abs(fp) - _QMAX * sc, 0.0)
    return float(np.max(sc / 2.0 + clip)) if fp.size else 0.0


def _quantized_scatter(pages, page_idx, slot, kv):
    """The int8 token scatter, in place: slot-0 landings re-seed their
    page's scale from the landing token, then every token quantizes with
    the updated scales and writes the payload.  ``page_idx`` / ``slot``
    are ``[B]`` or ``[B, S]`` and ``kv`` has matching leading dims +
    ``[H, D]``.  Returns the pair.

    The scale update is a masked max, not an assignment: pad tokens land
    on the scratch page at duplicate indices, and the order of duplicate
    writes is unspecified on the card.  Candidates are -1 except at
    slot-0 landings; a max over a -1 buffer does not depend on that
    order, and scales are > 0 by the eps floor, so a surviving -1 keeps
    the old scale.  Every constant is made on the device (the step runs
    as a CUDA graph)."""
    payload, scales = pages
    h = scales.shape[1]
    kvf = kv.to(torch.float32)
    tok = torch.clamp(kvf.abs().amax(dim=-1) / _QMAX,
                      min=KV_SCALE_EPS)                     # [..., H]
    cand = torch.where((slot == 0)[..., None], tok,
                       torch.full_like(tok, -1.0))
    fresh = torch.full(scales.shape, -1.0, dtype=torch.float32,
                       device=scales.device)
    idx = page_idx.long()
    fresh.scatter_reduce_(0, idx.reshape(-1, 1).expand(-1, h),
                          cand.reshape(-1, h), "amax")
    scales.copy_(torch.where(fresh > 0, fresh, scales))
    sc = scales[idx]                                        # [..., H]
    q = torch.clamp(torch.round(kvf / sc[..., None]), -_QMAX, _QMAX)
    payload[idx, :, slot.long()] = q.to(torch.int8)
    return payload, scales


def _gather_window(pages, block_tables):
    """Each row's whole page window as float32 ``[B, W, H, D]``
    (``W = max_pages * page``), int8 pools dequantized."""
    b, max_pages = block_tables.shape
    idx = block_tables.long()
    if is_quantized(pages):
        payload, scales = pages
        g = payload[idx].to(torch.float32) * scales[idx][..., None, None]
    else:
        g = pages[idx].to(torch.float32)
    _, _, h, page, d = g.shape
    return g.permute(0, 1, 3, 2, 4).reshape(b, max_pages * page, h, d)


# ------------------------------------------------------------------ decode

def _decode_plain(q, k_pages, v_pages, block_tables, lengths, scale=None):
    """Plain PyTorch version of the decode kernel: softmax over each
    row's slots ``< lengths[b]`` in float32; rows with no slot give 0."""
    b, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kw = _gather_window(k_pages, block_tables)          # [B, W, H, D]
    vw = _gather_window(v_pages, block_tables)
    w = kw.shape[1]
    lengths = lengths.to(torch.int64)
    s = torch.einsum("bhd,bwhd->bhw", q.to(torch.float32), kw) * scale
    valid = torch.arange(w, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhw,bwhd->bhd", p, vw)
    out = torch.where((lengths > 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def _check_kernel_args(q, k_pages, v_pages, block_tables, int_vecs,
                       int_shape=None):
    """Device, dtype, shape, contiguity and alignment checks shared by
    the kernels' wrappers; the int32 length arrays must have
    ``int_shape`` (default ``[B]``).  Returns ``(kv_dtype_code, k, v,
    ks, vs)``."""
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"q dtype {q.dtype} not supported by the kernel")
    if is_quantized(k_pages) != is_quantized(v_pages):
        raise TypeError("k_pages and v_pages must both be quantized or not")
    if is_quantized(k_pages):
        (k, ks), (v, vs) = k_pages, v_pages
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError("quantized payloads must be int8")
        for sc in (ks, vs):
            if sc.dtype != torch.float32 or tuple(sc.shape) != \
                    tuple(k.shape[:2]) or not sc.is_contiguous() \
                    or sc.device != dev:
                raise ValueError("scales must be contiguous float32 "
                                 f"[P, H] on {dev}, got {tuple(sc.shape)}")
    else:
        k, v, ks, vs = k_pages, v_pages, None, None
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"page dtype {k.dtype} must match q {q.dtype}")
    if tuple(k.shape) != tuple(v.shape) or k.dim() != 4:
        raise ValueError(f"pools must be [P, H, page, D], got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    h, d = k.shape[1], k.shape[3]
    if q.shape[-2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)} does not match pool heads/dim "
                         f"{(h, d)}")
    vec = 16 // k.element_size()
    nvec = d // vec
    if d % vec or d > 256 or nvec < 1 or 128 % nvec:
        raise ValueError(f"head_dim {d} unsupported: needs D % {vec} == 0, "
                         f"D <= 256 and D/{vec} a power of two")
    for t in (k, v):
        if t.data_ptr() % 16:
            raise ValueError("page pools must be 16-byte aligned")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2:
        raise TypeError("block_tables must be int32 [B, max_pages]")
    int_shape = tuple(int_shape or (q.shape[0],))
    for t in int_vecs:
        if t.dtype != torch.int32 or tuple(t.shape) != int_shape:
            raise TypeError(f"lengths must be int32 {list(int_shape)}, got "
                            f"{t.dtype} {list(t.shape)}")
    for t in (q, k, v, block_tables, *int_vecs):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return DTYPE_CODES[k.dtype], k, v, ks, vs


def _decode_cuda(q, k_pages, v_pages, block_tables, lengths, scale=None):
    _build.require_cuda()
    kvdt, k, v, ks, vs = _check_kernel_args(q, k_pages, v_pages,
                                            block_tables, (lengths,))
    b, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    ws = _workspace((b, h), block_tables.shape[1], d, q.device)
    p = _build.ptr
    _DECODE(DTYPE_CODES[q.dtype], kvdt, p(q), p(k), p(v),
            p(ks) if ks is not None else None,
            p(vs) if vs is not None else None,
            p(block_tables), p(lengths), p(out), p(ws),
            b, k.shape[0], h, d, k.shape[2], block_tables.shape[1],
            float(scale), _build.stream_ptr())
    return out


def paged_attention_decode(q, k_pages, v_pages, block_tables, lengths,
                           scale=None):
    """One decode step of attention over paged KV.

    q            [B, H, D]       — the new token's queries
    k_pages      [P, H, page, D] — the shared physical pool (head-major),
                                   or an (int8 payload, [P, H] scales) pair
    v_pages      [P, H, page, D]
    block_tables [B, max_pages] int32 — per-row page ids
    lengths      [B] int32       — tokens in cache (incl. current)
    → [B, H, D] in q's dtype

    A CPU ``q`` runs the plain version; a CUDA ``q`` launches the
    ``paged_decode`` kernel (contiguous int32 tables/lengths required)
    or raises."""
    if q.device.type == "cpu":
        return _decode_plain(q, k_pages, v_pages, block_tables, lengths,
                             scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _decode_cuda(q, k_pages, v_pages, block_tables, lengths, scale)


# ------------------------------------------------------------------ verify

def _verify_plain(q, k_pages, v_pages, block_tables, lengths, scale=None):
    """Plain PyTorch version of the verify kernel: lane ``w`` is
    ``_decode_plain(q[:, w], ..., lengths[:, w])``, so each lane is the
    plain decode exactly."""
    return torch.stack([
        _decode_plain(q[:, w], k_pages, v_pages, block_tables,
                      lengths[:, w], scale) for w in range(q.shape[1])],
        dim=1)


def _verify_cuda(q, k_pages, v_pages, block_tables, lengths, scale=None):
    _build.require_cuda()
    b, w, h, d = q.shape
    kvdt, k, v, ks, vs = _check_kernel_args(q, k_pages, v_pages,
                                            block_tables, (lengths,),
                                            int_shape=(b, w))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    ws = _workspace((b, w, h), block_tables.shape[1], d, q.device)
    p = _build.ptr
    _VERIFY(DTYPE_CODES[q.dtype], kvdt, p(q), p(k), p(v),
            p(ks) if ks is not None else None,
            p(vs) if vs is not None else None,
            p(block_tables), p(lengths), p(out), p(ws),
            b, w, k.shape[0], h, d, k.shape[2], block_tables.shape[1],
            float(scale), _build.stream_ptr())
    return out


def paged_attention_verify(q, k_pages, v_pages, block_tables, lengths,
                           scale=None):
    """Batched draft/verify decode attention over paged KV.

    q            [B, W, H, D]   — W query positions per row (last
                                  emitted token + W-1 drafts)
    k_pages      [P, H, page, D] (or an int8 (payload, scales) pair)
    v_pages      [P, H, page, D]
    block_tables [B, max_pages] int32
    lengths      [B, W] int32   — per-position window, nondecreasing
                                  over W (position j sees ctx + j + 1)
    → [B, W, H, D] in q's dtype

    Lane ``(b, w)`` is ``paged_attention_decode(q[:, w], ...,
    lengths[:, w])[b]`` bit for bit; a block reads its split's pages
    once for all its lanes.  A CPU
    ``q`` runs the plain version; a CUDA ``q`` launches the
    ``paged_verify`` kernel (contiguous int32 tables/lengths required)
    or raises."""
    if q.device.type == "cpu":
        return _verify_plain(q, k_pages, v_pages, block_tables, lengths,
                             scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _verify_cuda(q, k_pages, v_pages, block_tables, lengths, scale)


# --------------------------------------------------------- page utilities
# Plain PyTorch writes (the JAX package left them to XLA).  Pools, and a
# quantized pool's payload and scales, are updated IN PLACE — JAX donates
# the pools into the serving executable; here the same buffers simply
# stay put — and returned for symmetry.

def write_prompt_pages(pages, block_tables, kv):
    """Scatter an aligned prompt's K or V ``[B, S, H, D]`` into its
    rows' first ``S / page`` pages (``S`` a multiple of the page size);
    slots past a row's true length hold whatever the pad tokens gave,
    which every reader masks by length.  An int8 pool goes through
    ``_quantized_scatter``, token by token, so its bits are those of
    the chunk, token and ragged writers for the same tokens."""
    b, s, h, d = kv.shape
    page = _page_size(pages)
    if s % page:
        raise ValueError(f"prompt length {s} is not a multiple of the "
                         f"page size {page}")
    if is_quantized(pages):
        pos = torch.arange(s, device=kv.device)[None].expand(b, s)
        page_idx = torch.gather(block_tables.long(), 1, pos // page)
        return _quantized_scatter(pages, page_idx, pos % page, kv)
    n = s // page
    chunks = kv.reshape(b, n, page, h, d).permute(0, 1, 3, 2, 4)
    idx = block_tables[:, :n].reshape(-1).long()
    pages.index_copy_(0, idx, chunks.reshape(b * n, h, page, d)
                      .to(pages.dtype))
    return pages


def gather_prompt_pages(pages, block_tables, s):
    """An aligned prompt's K or V read back out of its rows' pages as
    ``[B, S, H, D]``: the companion of ``write_prompt_pages``.  An int8
    pool dequantizes to float32, so a prefill that attends over it sees
    exactly what every later reader of the pages sees."""
    page = _page_size(pages)
    if s % page:
        raise ValueError(f"prompt length {s} is not a multiple of the "
                         f"page size {page}")
    n = s // page
    idx = block_tables[:, :n].long()                        # [B, n]
    if is_quantized(pages):
        payload, scales = pages
        g = payload[idx].to(torch.float32) * scales[idx][..., None, None]
    else:
        g = pages[idx]
    # [B, n, H, page, D] -> [B, n, page, H, D] -> [B, S, H, D]
    return g.permute(0, 1, 3, 2, 4).reshape(idx.shape[0], n * page,
                                            g.shape[2], g.shape[4])


def write_chunk_pages(pages, block_tables, kv, offsets):
    """Scatter a chunk's K or V ``[B, S, H, D]`` at absolute positions
    ``offsets[b] + i`` (the chunk may start mid-page)."""
    b, s = kv.shape[:2]
    page = _page_size(pages)
    pos = offsets.long()[:, None] + torch.arange(s, device=kv.device)[None]
    page_idx = torch.gather(block_tables.long(), 1, pos // page)
    if is_quantized(pages):
        return _quantized_scatter(pages, page_idx, pos % page, kv)
    pages[page_idx, :, pos % page] = kv.to(pages.dtype)
    return pages


def write_token_page(pages, block_tables, kv, positions):
    """Write one new token's K or V ``[B, H, D]`` at its (page, slot):
    ``positions [B]`` is the 0-based token index in each row."""
    page = _page_size(pages)
    positions = positions.long()
    page_idx = torch.gather(block_tables.long(), 1,
                            (positions // page)[:, None])[:, 0]
    if is_quantized(pages):
        return _quantized_scatter(pages, page_idx, positions % page, kv)
    pages[page_idx, :, positions % page] = kv.to(pages.dtype)
    return pages


def prefix_prefill_attention(q, k_pages, v_pages, block_tables, offsets,
                             scale=None):
    """Queries at absolute positions ``offsets[b] + i`` attend over the
    row's whole gathered page window under an absolute-position causal
    mask (plain PyTorch, float32; the JAX package runs it as XLA).

    q [B, S, H, D], pools [P, H, page, D] (or int8 pairs),
    block_tables [B, max_pages], offsets [B] → [B, S, H, D]."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kw = _gather_window(k_pages, block_tables)
    vw = _gather_window(v_pages, block_tables)
    w = kw.shape[1]
    pos = offsets.long()[:, None] + torch.arange(s, device=q.device)[None]
    mask = torch.arange(w, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = torch.einsum("bshd,bwhd->bhsw", q.to(torch.float32), kw) * scale
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhsw,bwhd->bshd", weights, vw)
    return out.to(q.dtype)
