"""Sequence parallelism over the ``sep`` mesh axis: ring attention and
Ulysses.

Port of ``paddle_infer_tpu/parallel/sequence_parallel.py``.  Both take
whole ``(b, s, h, d)`` tensors (the reference's global view), split the
sequence into ``sep`` shards, one per coordinate of the axis on its
device, and return the whole output on the mesh's controller.

* ``ring_attention``: each shard keeps its queries; the key / value
  shards go round the ring (``collective.ppermute``, sep - 1 hops) and
  each shard folds every block it holds into a float32 online softmax
  (running max, normaliser, accumulator), causal by global position.
  The reference writes it in plain ``jnp`` outside any Pallas kernel,
  so this is plain PyTorch too.
* ``ulysses_attention``: an all-to-all (``collective.alltoall``) takes
  every shard from (its sequence, all heads) to (the whole sequence,
  its heads), each shard runs ``ops.attention.sdpa`` on its heads (on
  the card the flash kernels 4-6, one launch per shard), and a second
  all-to-all takes the outputs back.  Heads must divide the degree.

Gradients are autograd's through the collectives' transposes (the
reference differentiates its scan / ppermute graph the same way).
Other mesh axes (batch over ``dp``, heads over ``mp``) do not change
the arithmetic and are not split here; ``spec`` is accepted for the
reference's signature.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import collective as C
from . import topology

NEG_INF = -1e30


def _sep(mesh, axis_name):
    mesh = topology.active_mesh(mesh)
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(f"mesh with a '{axis_name}' axis is required "
                         "(fleet.init with sep_degree, or pass mesh=)")
    return mesh, mesh.shape[axis_name]


def _shards(x, mesh, axis_name, n):
    return [c.to(mesh.device(**{axis_name: i}))
            for i, c in enumerate(torch.chunk(x, n, dim=1))]


def _dense(q, k, v, causal, scale):
    from ..ops.attention import sdpa

    return sdpa(q, k, v, None, None, dropout_p=0.0, is_causal=causal,
                scale=scale)


def _ring(qs, ks, vs, group, causal, scale):
    """Per-shard ring attention over the sharded values ``qs, ks, vs``
    (each ``(b, s_loc, h, d)``); returns the per-shard outputs."""
    n = len(qs)
    b, sl, h, d = qs[0].shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = [q.device for q in qs]
    m = [torch.full((b, h, sl, 1), NEG_INF, device=x) for x in dev]
    lsum = [torch.zeros((b, h, sl, 1), device=x) for x in dev]
    acc = [torch.zeros((b, h, sl, d), device=x) for x in dev]
    iota = torch.arange(sl, device=dev[0])
    perm = [(j, (j + 1) % n) for j in range(n)]
    kc, vc = ks, vs
    for i in range(n):
        for idx in range(n):
            src = (idx - i) % n
            logits = torch.einsum("bqhd,bkhd->bhqk", qs[idx].float(),
                                  kc[idx].float()) * scale
            if causal:
                ok = (idx * sl + iota)[:, None] >= (src * sl + iota)[None, :]
                logits = torch.where(ok.to(logits.device), logits, NEG_INF)
            m_new = torch.maximum(m[idx], logits.amax(dim=-1, keepdim=True))
            corr = torch.exp(m[idx] - m_new)
            p = torch.exp(logits - m_new)
            lsum[idx] = corr * lsum[idx] + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhqk,bkhd->bhqd",
                              p.to(vc[idx].dtype).float(), vc[idx].float())
            acc[idx] = acc[idx] * corr + pv
            m[idx] = m_new
        if i + 1 < n:
            kc = C.ppermute(kc, perm, group)
            vc = C.ppermute(vc, perm, group)
    outs = []
    for idx in range(n):
        safe = torch.where(lsum[idx] == 0.0, torch.ones_like(lsum[idx]),
                           lsum[idx])
        outs.append((acc[idx] / safe).to(qs[idx].dtype).transpose(1, 2))
    return outs


def _to_heads(parts, group):
    """(b, s_loc, h, d) per shard -> (b, s, h / n, d) per shard."""
    n = len(parts)
    b, sl, h, d = parts[0].shape
    hn = h // n
    xs = [p.reshape(b, sl, n, hn, d).permute(2, 0, 1, 3, 4)
          .reshape(n * b, sl, hn, d) for p in parts]
    return [y.reshape(n, b, sl, hn, d).permute(1, 0, 2, 3, 4)
            .reshape(b, n * sl, hn, d) for y in C.alltoall(xs, group)]


def _to_seq(parts, group):
    """(b, s, h / n, d) per shard -> (b, s_loc, h, d) per shard."""
    n = len(parts)
    b, s, hn, d = parts[0].shape
    sl = s // n
    xs = [p.reshape(b, n, sl, hn, d).permute(1, 0, 2, 3, 4)
          .reshape(n * b, sl, hn, d) for p in parts]
    return [y.reshape(n, b, sl, hn, d).permute(1, 2, 0, 3, 4)
            .reshape(b, sl, n * hn, d) for y in C.alltoall(xs, group)]


def _ulysses(qs, ks, vs, group, causal, scale):
    heads = [_to_heads(t, group) for t in (qs, ks, vs)]
    outs = [_dense(q, k, v, causal, scale) for q, k, v in zip(*heads)]
    return _to_seq(outs, group)


def _call(local, q, k, v, mesh, axis_name, causal, scale):
    mesh, n = _sep(mesh, axis_name)
    if n == 1:
        return _dense(q, k, v, causal, scale)
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by "
                         f"{axis_name} degree {n}")
    group = C.Group(mesh, axis_name)
    outs = local(*(_shards(t, mesh, axis_name, n) for t in (q, k, v)),
                 group, causal, scale)
    return C.gather_in_order([o.to(mesh.controller) for o in outs], dim=1)


def ring_attention(q, k, v, mesh=None, axis_name: str = "sep",
                   is_causal: bool = False, scale: Optional[float] = None,
                   spec=None):
    """Ring (context-parallel) attention over ``axis_name``; ``(b, s, h,
    d)`` in and out."""
    return _call(_ring, q, k, v, mesh, axis_name, bool(is_causal), scale)


def ulysses_attention(q, k, v, mesh=None, axis_name: str = "sep",
                      is_causal: bool = False,
                      scale: Optional[float] = None, spec=None):
    """Ulysses (all-to-all head-scatter) attention over ``axis_name``;
    the head count must divide by the axis degree."""
    n = _sep(mesh, axis_name)[1]
    if q.shape[2] % n:
        raise ValueError(f"num_heads {q.shape[2]} not divisible by "
                         f"sep degree {n}")
    return _call(_ulysses, q, k, v, mesh, axis_name, bool(is_causal), scale)
