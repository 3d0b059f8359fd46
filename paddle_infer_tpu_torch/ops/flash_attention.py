"""Flash attention: forward, dK/dV and dQ, with segment-id masks, hash
dropout and a varlen entry point.

Port of ``paddle_infer_tpu/ops/pallas/flash_attention.py``.  Three
hand-written CUDA kernels (``csrc/flash_attention.cu``) replace its
three Pallas kernels: ``flash_fwd`` (``_fwd_kernel``), ``flash_dkdv``
(``_dkdv_kernel``) and ``flash_dq`` (``_dq_kernel``).  Each wrapper runs
the kernel's plain PyTorch version (``_fwd_reference``,
``_grads_reference``) on a CPU tensor and launches the kernel, or
raises, on a CUDA tensor.

Layout: the public functions take ``(batch, seq, heads, head_dim)``;
the kernels see the folded ``(batch*heads, seq, head_dim)``, per-row
``lse``/``delta`` as ``[BH, Sq]`` float32 and segment ids as ``[B, S]``
int32 (the TPU's lane/sublane broadcast layouts and block fitting are
not carried over: the kernels guard their own tile tails).

Dropout is the counter-hash keep mask ``dropout_keep(seed, bh, row,
col)`` over absolute coordinates, so the forward, both backward
kernels, the plain versions and the JAX package all draw the same mask
bit for bit.  uint32 arithmetic runs in int64 tensors (as
``core/random.py`` does), every product masked back to 32 bits.  The
seed is a 0-d int64 tensor on q's device (an int is accepted and put
there): the kernels read it from device memory, so a CUDA graph replays
them with each step's seed.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_M = 0xFFFFFFFF

# the C side's dtype codes (csrc/flash_attention.cu ``DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)

_c = ctypes
_COMMON = [_c.c_int] * 4 + [_c.c_float, _c.c_int, _c.c_int, _c.c_void_p,
                            _c.c_uint32, _c.c_float, _c.c_void_p]
_FWD = _build.register(_build.CudaKernel(
    "flash_fwd", "flash_attention.cu", "pit_flash_fwd",
    [_c.c_int, _c.c_int] + [_c.c_void_p] * 7 + _COMMON,
    replaces="paddle_infer_tpu/ops/pallas/flash_attention.py:109"))
_DKDV = _build.register(_build.CudaKernel(
    "flash_dkdv", "flash_attention.cu", "pit_flash_dkdv",
    [_c.c_int, _c.c_int] + [_c.c_void_p] * 10 + _COMMON,
    replaces="paddle_infer_tpu/ops/pallas/flash_attention.py:276"))
_DQ = _build.register(_build.CudaKernel(
    "flash_dq", "flash_attention.cu", "pit_flash_dq",
    [_c.c_int, _c.c_int] + [_c.c_void_p] * 9 + _COMMON,
    replaces="paddle_infer_tpu/ops/pallas/flash_attention.py:346"))


# ------------------------------------------------------------ hash dropout

def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M


def _mul32(x, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): split into
    16-bit halves of ``c`` so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M


def _mix32(x) -> torch.Tensor:
    """splitmix32 finalizer over uint32 values held in int64."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(dropout_p: float) -> int:
    """The uint32 threshold: keep where the hash is >= it."""
    return min(int(round(float(dropout_p) * 4294967296.0)), 4294967295)


def dropout_keep(seed, bh, rows, cols, dropout_p):
    """Deterministic keep mask for attention-probability dropout: a pure
    hash of ``(seed, bh, row, col)`` (broadcastable ints or tensors;
    absolute folded-head index and q/k coordinates; the seed an int or a
    0-d tensor).  P(keep) = 1 - dropout_p."""
    x = (_mul32(_u32(rows), 0x9E3779B1) + _mul32(_u32(cols), 0x85EBCA77)
         + _mul32(_u32(bh), 0xC2B2AE3D)) & _M
    return _mix32(x ^ (seed & _M)) >= keep_threshold(dropout_p)


def _keep_grid(seed, bh, sq, sk, dropout_p, device):
    """``dropout_keep`` over a whole ``[bh, sq, sk]`` grid."""
    ar = lambda n: torch.arange(n, device=device)
    return dropout_keep(seed, ar(bh)[:, None, None], ar(sq)[None, :, None],
                        ar(sk)[None, None, :], dropout_p)


# ---------------------------------------------------------- plain versions

def _seg_ok(qseg, kseg, h):
    """``[B, Sq]``, ``[B, Sk]`` ids → ``[B*h, Sq, Sk]`` attend-iff-equal."""
    ok = qseg[:, :, None] == kseg[:, None, :]
    b, sq, sk = ok.shape
    return ok[:, None].expand(b, h, sq, sk).reshape(b * h, sq, sk)


def _causal_ok(sq, sk, device):
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return rows + (sk - sq) >= cols


def _fwd_reference(q, k, v, qseg, kseg, seed, causal, scale, dropout_p, h):
    """Plain version of ``flash_fwd`` in float32 (the JAX package's
    ``_xla_fwd_with_lse``): folded ``q [BH, Sq, D]``, ``k/v [BH, Sk,
    D]`` → ``(o in q's dtype, lse [BH, Sq] float32)``."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_ok(sq, sk, q.device), s, NEG_INF)
    if qseg is not None:
        s = torch.where(_seg_ok(qseg, kseg, h), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p:
        keep = _keep_grid(seed, bh, sq, sk, dropout_p, q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_p))
    o = torch.einsum("nqk,nkd->nqd", p / l, v.float())
    if qseg is not None:
        o = torch.where(m <= NEG_INF * 0.5, 0.0, o)    # dead rows -> 0
    lse = (m + torch.log(torch.where(l == 0.0, 1.0, l)))[..., 0]
    return o.to(q.dtype), lse


def _grads_reference(q, k, v, do, lse, delta, qseg, kseg, seed, causal,
                     scale, dropout_p, h):
    """Plain version of ``flash_dkdv`` and ``flash_dq`` in float32:
    ``p = exp(s - lse)`` re-zeroed where masked (``_masked_p``), ``pd``
    and ``dp`` dropped and rescaled, ``ds = p (dp - delta) scale`` →
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("nqd,nkd->nqk", qf, kf) * scale
    if causal:
        cm = _causal_ok(sq, sk, q.device)
        s = torch.where(cm, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(cm, p, 0.0)
    if qseg is not None:
        p = torch.where(_seg_ok(qseg, kseg, h), p, 0.0)
    dp = torch.einsum("nqd,nkd->nqk", dof, vf)
    pd = p
    if dropout_p:
        keep = _keep_grid(seed, bh, sq, sk, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        pd = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("nqk,nqd->nkd", pd, dof)
    dk = torch.einsum("nqk,nqd->nkd", ds, qf)
    dq = torch.einsum("nqk,nkd->nqd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(do, o):
    """``delta = sum(do * o)`` per row, float32 ``[BH, Sq]``."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_reference(q, k, v, o, lse, do, qseg, kseg, seed, causal, scale,
                   dropout_p, h):
    """``(dq, dk, dv)`` from ``q, k, v, o, lse, do`` (plain)."""
    return _grads_reference(q, k, v, do, lse, _delta(do, o), qseg, kseg,
                            seed, causal, scale, dropout_p, h)


# ---------------------------------------------------------------- wrappers

def _check(q, k, v, extra, qseg, kseg, h):
    """Device, dtype, shape, contiguity and alignment checks of the
    kernels' wrappers; returns the dtype code."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported by the flash "
                        "kernels (float32, bfloat16, float16)")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the flash kernels "
                         f"{HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bh % h or bh > 65535:
        raise ValueError(f"{bh} folded heads: must be a multiple of {h} and "
                         "at most 65535")
    for t in (q, k, v) + tuple(extra):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on "
                             f"{q.device}")
    # the 16-bit kernels (forward and backward) read q, k, v (and dO)
    # by TMA (16-byte aligned base addresses)
    mats = (q, k, v) + tuple(extra[:1])
    if extra and extra[0].shape != q.shape:
        raise ValueError(f"dO {tuple(extra[0].shape)} does not match q "
                         f"{tuple(q.shape)}")
    for t in mats:
        if t.dtype != q.dtype or t.data_ptr() % 16:
            raise ValueError("q, k, v (and dO) must share a dtype and be "
                             "16-byte aligned")
    if qseg is not None:
        b = bh // h
        for t, s in ((qseg, sq), (kseg, k.shape[1])):
            if t.dtype != torch.int32 or tuple(t.shape) != (b, s) \
                    or t.device != q.device or not t.is_contiguous():
                raise ValueError(f"segment ids must be contiguous int32 "
                                 f"[{b}, {s}] on {q.device}")
    return DTYPE_CODES[q.dtype]


def _common(q, k, h, scale, causal, dropout_p, seed):
    """The kernels' trailing arguments; ``seed`` is ``_prep_seed``'s
    tensor, whose low 32 bits (little-endian: its first word) the
    kernels read from device memory."""
    bh, sq, d = q.shape
    p = float(dropout_p)
    return (bh, sq, k.shape[1], h, float(scale), int(bool(causal)),
            int(p > 0), _build.ptr(seed) if p else None,
            keep_threshold(p) if p else 0,
            float(1.0 / (1.0 - p)) if p else 1.0, _build.stream_ptr())


def _opt(t):
    return _build.ptr(t) if t is not None else None


def _on_card(q):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _build.require_cuda()


def flash_fwd(q, k, v, qseg, kseg, seed, causal, scale, dropout_p, h):
    """Kernel 4 (``_fwd_kernel``): folded ``(o, lse)``."""
    if q.device.type == "cpu":
        return _fwd_reference(q, k, v, qseg, kseg, seed, causal, scale,
                              dropout_p, h)
    _on_card(q)
    code = _check(q, k, v, (), qseg, kseg, h)
    seed = _prep_seed(dropout_p, seed, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    p = _build.ptr
    _FWD(code, q.shape[2], p(q), p(k), p(v), _opt(qseg), _opt(kseg), p(o),
         p(lse), *_common(q, k, h, scale, causal, dropout_p, seed))
    return o, lse


def flash_dkdv(q, k, v, do, lse, delta, qseg, kseg, seed, causal, scale,
               dropout_p, h):
    """Kernel 5 (``_dkdv_kernel``): ``(dk, dv)``."""
    if q.device.type == "cpu":
        return _grads_reference(q, k, v, do, lse, delta, qseg, kseg, seed,
                                causal, scale, dropout_p, h)[1:]
    _on_card(q)
    code = _check(q, k, v, (do, lse, delta), qseg, kseg, h)
    seed = _prep_seed(dropout_p, seed, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    p = _build.ptr
    _DKDV(code, q.shape[2], p(q), p(k), p(v), p(do), p(lse), p(delta),
          _opt(qseg), _opt(kseg), p(dk), p(dv),
          *_common(q, k, h, scale, causal, dropout_p, seed))
    return dk, dv


def flash_dq(q, k, v, do, lse, delta, qseg, kseg, seed, causal, scale,
             dropout_p, h):
    """Kernel 6 (``_dq_kernel``): ``dq``."""
    if q.device.type == "cpu":
        return _grads_reference(q, k, v, do, lse, delta, qseg, kseg, seed,
                                causal, scale, dropout_p, h)[0]
    _on_card(q)
    code = _check(q, k, v, (do, lse, delta), qseg, kseg, h)
    seed = _prep_seed(dropout_p, seed, q.device)
    dq = torch.empty_like(q)
    p = _build.ptr
    _DQ(code, q.shape[2], p(q), p(k), p(v), p(do), p(lse), p(delta),
        _opt(qseg), _opt(kseg), p(dq),
        *_common(q, k, h, scale, causal, dropout_p, seed))
    return dq


class _FlashFunction(torch.autograd.Function):
    """Folded attention whose backward is kernels 5 and 6; the forward is
    kernel 4 (``flash_attention``) or the plain forward
    (``hybrid_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, seed, causal, scale, dropout_p,
                h, hybrid):
        fwd = _fwd_reference if hybrid else flash_fwd
        o, lse = fwd(q, k, v, qseg, kseg, seed, causal, scale, dropout_p, h)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.cfg = (seed, causal, scale, dropout_p, h)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        seed, causal, scale, dropout_p, h = ctx.cfg
        do = do.contiguous()
        delta = _delta(do, o)
        args = (lse, delta, qseg, kseg, seed, causal, scale, dropout_p, h)
        dk, dv = flash_dkdv(q, k, v, do, *args)
        dq = flash_dq(q, k, v, do, *args)
        return (dq, dk, dv) + (None,) * 8


def _prep_segments(q_segment_ids, kv_segment_ids, b, sq, sk, device):
    if q_segment_ids is None and kv_segment_ids is None:
        return None, None
    if q_segment_ids is None or kv_segment_ids is None:
        raise ValueError("segment ids must be given for both q and kv")
    qseg = torch.as_tensor(q_segment_ids, device=device).to(torch.int32)
    kseg = torch.as_tensor(kv_segment_ids, device=device).to(torch.int32)
    if tuple(qseg.shape) != (b, sq) or tuple(kseg.shape) != (b, sk):
        raise ValueError(
            f"segment ids must be (batch, seq): got {tuple(qseg.shape)} for "
            f"q (want {(b, sq)}), {tuple(kseg.shape)} for kv (want "
            f"{(b, sk)})")
    return qseg.contiguous(), kseg.contiguous()


def _prep_seed(dropout_p, dropout_seed, device):
    """The seed as a 0-d int64 tensor on ``device`` whose low 32 bits are
    the uint32 seed (a tensor is never read back to the host)."""
    if not dropout_p:
        return None
    if dropout_seed is None:
        raise ValueError("dropout_p > 0 requires a dropout_seed")
    if isinstance(dropout_seed, torch.Tensor):
        return dropout_seed.to(device=device,
                               dtype=torch.int64).reshape(()).contiguous()
    return torch.full((), int(dropout_seed) & _M, dtype=torch.int64,
                      device=device)


def _attention(q, k, v, q_segment_ids, kv_segment_ids, dropout_p,
               dropout_seed, is_causal, scale, hybrid):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qseg, kseg = _prep_segments(q_segment_ids, kv_segment_ids, b, sq, sk,
                                q.device)
    seed = _prep_seed(dropout_p, dropout_seed, q.device)

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d) \
            .contiguous()

    o = _FlashFunction.apply(fold(q), fold(k), fold(v), qseg, kseg, seed,
                             bool(is_causal), float(scale), float(dropout_p),
                             h, hybrid)
    return o.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def flash_attention(q, k, v, mask=None, q_segment_ids=None,
                    kv_segment_ids=None, dropout_p=0.0, dropout_seed=None,
                    is_causal=False, scale=None):
    """Flash attention in ``(batch, seq, heads, head_dim)`` layout:
    kernel 4 forward, kernels 5 and 6 backward.

    Masking is by int32 ``{q,kv}_segment_ids`` ``[B, S]`` (attend iff
    equal) plus ``is_causal`` (offset ``Sk - Sq``); a dense ``mask`` is
    not supported (``ops.attention.sdpa`` takes those to the plain
    path).  ``dropout_p`` drops probabilities with ``dropout_keep``
    seeded by the uint32 ``dropout_seed`` (an int or a 0-d tensor)."""
    if mask is not None:
        raise NotImplementedError("flash kernel: dense mask unsupported — "
                                  "use segment ids")
    return _attention(q, k, v, q_segment_ids, kv_segment_ids, dropout_p,
                      dropout_seed, is_causal, scale, hybrid=False)


def hybrid_attention(q, k, v, q_segment_ids=None, kv_segment_ids=None,
                     dropout_p=0.0, dropout_seed=None, is_causal=False,
                     scale=None):
    """The plain forward (``_fwd_reference``, the JAX package's XLA
    forward) with kernels 5 and 6 as its backward; ``(b, s, h, d)``."""
    return _attention(q, k, v, q_segment_ids, kv_segment_ids, dropout_p,
                      dropout_seed, is_causal, scale, hybrid=True)


def _varlen_segment_ids(total, cu_seqlens):
    """Token ``t`` belongs to sequence ``j`` iff ``cu[j] <= t < cu[j+1]``
    (tokens at or past ``cu[-1]`` land in segment ``n_seqs``)."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    return torch.searchsorted(cu[1:].contiguous(), pos, right=True) \
        .to(torch.int32)


def flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k=None,
                      dropout_p=0.0, dropout_seed=None, is_causal=False,
                      scale=None):
    """Unpadded attention over packed sequences: ``q/k/v [total, heads,
    head_dim]``, ``cu_seqlens_* [n_seqs + 1]`` int32 prefix sums; the
    packing rides as segment ids through ``flash_attention``.
    ``is_causal`` needs q and k packed alike."""
    if cu_seqlens_k is None:
        cu_seqlens_k = cu_seqlens_q
    if is_causal and (tuple(cu_seqlens_k.shape)
                      != tuple(cu_seqlens_q.shape)):
        raise NotImplementedError(
            "varlen causal requires identically packed q and k")
    qseg = _varlen_segment_ids(q.shape[0], cu_seqlens_q.to(q.device))[None]
    kseg = _varlen_segment_ids(k.shape[0], cu_seqlens_k.to(q.device))[None]
    out = flash_attention(q[None], k[None], v[None], q_segment_ids=qseg,
                          kv_segment_ids=kseg, dropout_p=dropout_p,
                          dropout_seed=dropout_seed, is_causal=is_causal,
                          scale=scale)
    return out[0]
