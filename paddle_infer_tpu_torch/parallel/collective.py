"""Collectives over a mesh axis, on sharded values.

Port of ``paddle_infer_tpu/parallel/collective.py``.  The reference's
collectives are ``shard_map``-wrapped ``jax.lax`` collectives over a
named mesh axis.  Here one controller drives every shard, so a
*sharded value* is the list of per-shard tensors, one per coordinate of
the group's axis in rank order, each on its shard's device; every
collective takes such a list and returns one.  A reduction copies every
contribution to the reducer's device (the first shard's) and sums in
fixed rank order, so a result never depends on where the shards live.

The EQuARX blockwise-int8 all-reduce is computed for real
(``quantized_psum``): each rank's contribution is flattened, cut into
blocks of ``_Q8_BLOCK`` elements and encoded as int8 codes plus one
float32 scale a block; with a block count the group size divides, each
rank dequantizes and sums its 1/r of the blocks, re-encodes the sum and
the reduced shards are gathered (two stages), otherwise the full gather
is dequantized and summed (the exact-shape path).  ``CollectiveLedger``
/ ``LEDGER`` tally the analytic wire bytes by op and dtype.

Training: every verb differentiates through its transpose (see the API
section), so autograd flows back through the sharded values of
``parallel/mp_layers.py``, ``pipeline.py``, ``sequence_parallel.py``
and ``moe.py``.  Plain PyTorch throughout: none of this is a Pallas
kernel in the reference.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import topology


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communication group: ``(mesh, axis name(s))``; its ranks are
    the coordinates of the axis."""

    def __init__(self, mesh, axis: Union[str, Sequence[str]]):
        self.mesh = mesh
        self.axis = tuple(axis) if not isinstance(axis, str) else (axis,)

    @property
    def nranks(self) -> int:
        n = 1
        for a in self.axis:
            n *= self.mesh.shape[a]
        return n

    world_size = nranks

    @property
    def name(self):
        return "+".join(self.axis)

    def __repr__(self):
        return f"Group(axis={self.axis}, nranks={self.nranks})"

    def __hash__(self):
        return hash((id(self.mesh), self.axis))

    def __eq__(self, other):
        return (isinstance(other, Group) and self.mesh is other.mesh
                and self.axis == other.axis)


def _default_group() -> Group:
    """The current mesh's ``mp`` axis (a serving step), else the hybrid
    group's ``dp`` axis (the reference's default under ``fleet.init``)."""
    mesh = topology.get_current_mesh()
    if mesh is not None:
        return Group(mesh, "mp")
    hcg = topology.get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("no communication group: call fleet.init / "
                           "set_current_mesh first, or pass group= "
                           "explicitly")
    return Group(hcg.mesh, "dp")


def _check(parts, group):
    parts = list(parts)
    if group is not None and len(parts) != group.nranks:
        raise ValueError(f"{len(parts)} shards for a group of "
                         f"{group.nranks} ranks")
    if not parts:
        raise ValueError("a sharded value needs at least one shard")
    return parts


def _fanout(value, parts):
    """The replicated result on every shard's device (the same tensor
    where a shard shares the reducer's device)."""
    return [value if p.device == value.device else value.to(p.device)
            for p in parts]


def _reduce(parts, op):
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        p = p.to(dev)
        if op in (ReduceOp.SUM, ReduceOp.AVG):
            acc = acc + p
        elif op == ReduceOp.MAX:
            acc = torch.maximum(acc, p)
        elif op == ReduceOp.MIN:
            acc = torch.minimum(acc, p)
        elif op == ReduceOp.PROD:
            acc = acc * p
        else:
            raise ValueError(op)
    if op == ReduceOp.AVG:
        acc = acc / len(parts)
    return acc


def sum_in_order(parts):
    """The sum of per-shard partials in rank order on the first shard's
    device: the exact reduction inside a sharded layer (analytic bytes
    for those are the step log's ``mp_allreduce``, not this ledger's)."""
    return _reduce(list(parts), ReduceOp.SUM)


def gather_in_order(parts, dim=-1):
    """The shards concatenated along ``dim`` on the first shard's device
    (a column layer's gathered output)."""
    dev = parts[0].device
    return torch.cat([p if p.device == dev else p.to(dev) for p in parts],
                     dim=dim)


# ------------------------------------------------ quantized all-reduce

_Q8_BLOCK = 256          # elements per quantization block
_Q8_SCALE_BYTES = 4      # one fp32 scale per block on the wire


def _q8_encode(blocks):
    """``[nb, block]`` f32 -> ``(int8 codes, f32 scales [nb, 1])``.  The
    scale is ``maxabs / 127`` (1 for an all-zero block)."""
    scale = torch.amax(blocks.abs(), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantized_psum(parts, block: int = _Q8_BLOCK) -> torch.Tensor:
    """Blockwise-int8 SUM all-reduce of the per-rank contributions
    ``parts`` (same shape): the reduced tensor, on the first shard's
    device, in the parts' dtype.  Exact shape in, exact shape out; only
    the wire format is quantized.  Two stages when the group size
    divides the block count (rank j dequantizes and sums blocks ``j *
    nb / r ..``, re-encodes them, and the reduced codes are gathered),
    else the one-stage dequantize-and-sum of the full gather."""
    parts = list(parts)
    dev = parts[0].device
    shape, dtype = parts[0].shape, parts[0].dtype
    r = len(parts)
    n = parts[0].numel()
    nb = -(-n // block)
    codes, scales = [], []
    for p in parts:
        flat = p.reshape(-1).to(torch.float32)
        flat = torch.nn.functional.pad(flat, (0, nb * block - n))
        q, s = _q8_encode(flat.reshape(nb, block))
        codes.append(q.to(dev))
        scales.append(s.to(dev))
    if nb % r == 0:
        shard = nb // r
        outq, outs = [], []
        for j in range(r):
            sl = slice(j * shard, (j + 1) * shard)
            red = codes[0][sl].to(torch.float32) * scales[0][sl]
            for q, s in zip(codes[1:], scales[1:]):
                red = red + q[sl].to(torch.float32) * s[sl]
            q2, s2 = _q8_encode(red)
            outq.append(q2)
            outs.append(s2)
        vals = torch.cat(outq).to(torch.float32) * torch.cat(outs)
    else:
        vals = codes[0].to(torch.float32) * scales[0]
        for q, s in zip(codes[1:], scales[1:]):
            vals = vals + q.to(torch.float32) * s
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)


def quantized_wire_bytes(n_elems: int, nranks: int, itemsize: int = 4,
                         block: int = _Q8_BLOCK):
    """``(quantized_bytes, full_precision_bytes)`` moved per rank by one
    SUM all-reduce of ``n_elems`` elements over ``nranks`` ranks, ring
    model: 2(r-1)/r of the payload crosses the wire."""
    nranks = max(int(nranks), 1)
    ring = 2.0 * (nranks - 1) / nranks
    nb = -(-int(n_elems) // block)
    q_payload = nb * block * 1 + nb * _Q8_SCALE_BYTES
    fp_payload = int(n_elems) * int(itemsize)
    return ring * q_payload, ring * fp_payload


def quantization_error_bound(parts, block: int = _Q8_BLOCK) -> float:
    """Worst-case elementwise ``|quantized - exact|`` for summing the
    per-rank contributions ``parts`` (arrays or tensors of one shape)
    through ``quantized_psum``: stage 1 rounds each rank's block by at
    most maxabs / 254, stage 2 re-rounds the reduced block once more;
    the one-stage path has only the first term, so this covers both."""
    flats = [np.asarray(p.detach().cpu() if isinstance(p, torch.Tensor)
                        else p, np.float32).reshape(-1) for p in parts]
    n = flats[0].shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    amax_sum = np.zeros(nb, np.float64)
    for f in flats:
        fb = np.pad(f, (0, pad)).reshape(nb, block)
        amax_sum += np.max(np.abs(fb), axis=1)
    stage1 = amax_sum / 254.0
    stage2 = (amax_sum + stage1) / 254.0
    return float(np.max(stage1 + stage2)) if nb else 0.0


class CollectiveLedger:
    """Thread-safe analytic tally of interconnect bytes moved by
    collectives, by op and wire dtype, plus the bytes a quantized wire
    format saved against full precision.  Feeds the
    ``collective_bytes_total{op,dtype}`` / ``collective_bytes_saved_total``
    Prometheus families through the serving snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._by: Dict[str, Dict[str, float]] = {}
            self._saved = 0.0
            self._calls = 0

    def record(self, op: str, dtype: str, nbytes: float,
               saved: float = 0.0):
        with self._lock:
            per_op = self._by.setdefault(str(op), {})
            per_op[str(dtype)] = per_op.get(str(dtype), 0.0) + float(nbytes)
            self._saved += float(saved)
            self._calls += 1

    def snapshot(self) -> Dict:
        with self._lock:
            by = {op: dict(d) for op, d in self._by.items()}
            total = sum(v for d in by.values() for v in d.values())
            return {"calls": self._calls,
                    "by_op_dtype": by,
                    "bytes_total": total,
                    "bytes_saved_total": self._saved}


LEDGER = CollectiveLedger()


def _record_wire(op: str, nbytes: float, dtype, group: Group,
                 factor: float):
    """Analytic wire bytes of one full-precision collective: ``factor``
    x the payload (ring model), under numpy's name of the dtype."""
    LEDGER.record(op, str(dtype).replace("torch.", ""),
                  factor * float(nbytes))


def _ring(group: Group) -> float:
    r = max(group.nranks, 1)
    return (r - 1) / r


def _nbytes(t):
    return t.numel() * t.element_size()


# ------------------------------------------------------------ autograd

class _Verb(torch.autograd.Function):
    """A collective with its transpose as the backward: ``fwd`` maps the
    list of per-rank inputs to the per-rank outputs, ``bwd`` the list of
    per-rank output cotangents to the per-rank input cotangents."""

    @staticmethod
    def forward(ctx, fwd, bwd, *parts):
        ctx.bwd = bwd
        outs = []
        seen = {id(p) for p in parts}
        for o in fwd(list(parts)):
            # every output its own tensor: autograd keeps one cotangent
            # per rank
            if id(o) in seen or o._base is not None:
                o = o.clone()
            seen.add(id(o))
            outs.append(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.bwd(list(grads)))


def _run(fwd, bwd, parts):
    """``fwd(parts)``, differentiable through ``bwd`` when a part needs a
    gradient."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in parts):
        return list(_Verb.apply(fwd, bwd, *parts))
    return fwd(parts)


def _like(values, parts):
    """``values[i]`` moved to ``parts[i]``'s device."""
    return [v if v.device == p.device else v.to(p.device)
            for v, p in zip(values, parts)]


def _zeros(parts):
    return [torch.zeros_like(p) for p in parts]


# ------------------------------------------------------------------- API
#
# Every verb takes and returns a sharded value (one tensor per rank of
# the group, in rank order) and differentiates through its transpose,
# the reference's VJP of the same verb: all_reduce's cotangents are
# all-reduced (a cotangent only one rank holds, as a replicated result
# used once has, reaches every rank's contribution unchanged: the
# identity), all_gather <-> reduce_scatter, alltoall <-> alltoall,
# ppermute <-> the inverse permutation, broadcast <-> the sum onto the
# source, reduce and p2p_transfer <-> their adjoint copies.  Sums run in
# rank order on the first rank's device.

def all_reduce(parts, op: str = ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True, quantized: Optional[str] = None,
               block: int = _Q8_BLOCK):
    """Reduce the per-rank contributions ``parts`` over the group axis;
    every rank gets the result.  ``quantized="int8"`` sends the SUM over
    the blockwise-int8 wire format (``quantized_psum``): approximate
    within ``quantization_error_bound``, about 4x fewer bytes (no
    gradient)."""
    group = group or _default_group()
    parts = _check(parts, group)
    if quantized is None:
        _record_wire("all_reduce", _nbytes(parts[0]), parts[0].dtype,
                     group, 2.0 * _ring(group))
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            return _fanout(_reduce(parts, op), parts)

        def bwd(gs):
            return _fanout(_reduce(gs, op), parts)

        return _run(lambda ps: _fanout(_reduce(ps, op), ps), bwd, parts)
    if quantized != "int8":
        raise ValueError(f"unsupported quantized wire format {quantized!r}; "
                         "only 'int8' is implemented")
    if op != ReduceOp.SUM:
        raise ValueError("quantized all_reduce supports ReduceOp.SUM only")
    if len(group.axis) != 1:
        raise ValueError("quantized all_reduce needs a single-axis group, "
                         f"got axes {group.axis}")
    out = quantized_psum(parts, int(block))
    qb, fp = quantized_wire_bytes(parts[0].numel(), group.nranks,
                                  parts[0].element_size(), int(block))
    LEDGER.record("all_reduce", "int8", qb, saved=max(fp - qb, 0.0))
    return _fanout(out, parts)


def all_gather(parts, group: Optional[Group] = None, axis: int = 0):
    """Concatenate the shards along ``axis``; every rank gets the whole."""
    group = group or _default_group()
    parts = _check(parts, group)

    def fwd(ps):
        return _fanout(gather_in_order(ps, dim=axis), ps)

    def bwd(gs):
        sizes = [p.shape[axis] for p in parts]
        return _like(torch.split(_reduce(gs, ReduceOp.SUM), sizes,
                                 dim=axis), parts)

    out = _run(fwd, bwd, parts)
    _record_wire("all_gather", _nbytes(out[0]), out[0].dtype, group,
                 _ring(group))
    return out


def reduce_scatter(parts, op: str = ReduceOp.SUM,
                   group: Optional[Group] = None):
    """Reduce the full per-rank tensors, rank j keeps the j-th of the
    group's slices of dim 0."""
    group = group or _default_group()
    parts = _check(parts, group)

    def fwd(ps):
        return _like(torch.chunk(_reduce(ps, op), len(ps), dim=0), ps)

    def bwd(gs):
        return _fanout(gather_in_order(gs, dim=0), parts)

    _record_wire("reduce_scatter", _nbytes(parts[0]), parts[0].dtype,
                 group, _ring(group))
    if op != ReduceOp.SUM:
        return fwd(parts)
    return _run(fwd, bwd, parts)


def broadcast(parts, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True):
    """Every rank gets rank ``src``'s shard."""
    group = group or _default_group()
    parts = _check(parts, group)
    total = sum(_nbytes(p) for p in parts)
    _record_wire("broadcast", total, parts[0].dtype, group, _ring(group))

    def bwd(gs):
        out = _zeros(parts)
        out[src] = _reduce(gs, ReduceOp.SUM).to(parts[src].device)
        return out

    return _run(lambda ps: [ps[src].to(p.device) for p in ps], bwd, parts)


def reduce(parts, dst: int = 0, op: str = ReduceOp.SUM,
           group: Optional[Group] = None):
    """Rank ``dst`` gets the reduction, every other rank keeps its
    shard."""
    group = group or _default_group()
    parts = _check(parts, group)

    def fwd(ps):
        out = list(ps)
        out[dst] = _reduce(ps, op).to(ps[dst].device)
        return out

    def bwd(gs):
        gd = gs[dst]
        return [gd.to(p.device) if i == dst else gs[i] + gd.to(p.device)
                for i, p in enumerate(parts)]

    if op != ReduceOp.SUM:
        return fwd(parts)
    return _run(fwd, bwd, parts)


def alltoall(parts, group: Optional[Group] = None):
    """Pairwise chunk exchange: each rank's dim 0 splits into ``r``
    chunks and rank j receives chunk j of every rank, in rank order
    (the transport under MoE's ``global_scatter`` / ``global_gather``
    and Ulysses attention)."""
    group = group or _default_group()
    parts = _check(parts, group)

    def fwd(ps):
        r = len(ps)
        chunks = [torch.chunk(p, r, dim=0) for p in ps]
        return [torch.cat([chunks[i][j].to(ps[j].device) for i in range(r)])
                for j in range(r)]

    return _run(fwd, fwd, parts)


def ppermute(parts, perm, group: Optional[Group] = None):
    """Rank ``d`` gets rank ``s``'s shard for each pair ``(s, d)`` of
    ``perm``; a rank no pair sends to gets zeros (the reference's
    ``ppermute``)."""
    group = group or _default_group()
    parts = _check(parts, group)
    perm = [(int(s), int(d)) for s, d in perm]

    def move(ps, pairs):
        out = _zeros(ps)
        for s, d in pairs:
            out[d] = ps[s].to(ps[d].device)
        return out

    return _run(lambda ps: move(ps, perm),
                lambda gs: move(gs, [(d, s) for s, d in perm]), parts)


def p2p_transfer(parts, src: int, dst: int, group: Optional[Group] = None):
    """A single ``src`` -> ``dst`` transfer: rank ``dst`` gets rank
    ``src``'s shard, every other rank keeps its own (a matched send /
    recv pair)."""
    group = group or _default_group()
    parts = _check(parts, group)
    src, dst = int(src), int(dst)

    def fwd(ps):
        out = list(ps)
        out[dst] = ps[src].to(ps[dst].device)
        return out

    def bwd(gs):
        if src == dst:
            return list(gs)
        out = list(gs)
        out[src] = gs[src] + gs[dst].to(parts[src].device)
        out[dst] = torch.zeros_like(gs[dst])
        return out

    return _run(fwd, bwd, parts)


def barrier(group: Optional[Group] = None):
    """A tiny all-reduce over the group (the reference's barrier)."""
    group = group or _default_group()
    dev = group.mesh.controller
    all_reduce([torch.zeros((), device=dev)] * group.nranks, group=group)


def new_group(ranks=None, axis: Union[str, Sequence[str], None] = None
              ) -> Group:
    """A registered group over a mesh axis of the current hybrid group's
    (or this thread's) mesh; ``ranks`` must be one whole axis's peer set
    (the reference takes rank lists, a mesh groups by axis)."""
    mesh = topology.active_mesh()
    if mesh is None:
        raise RuntimeError("fleet.init / set_current_mesh must run first")
    if axis is None:
        axis = mesh.axis_names[0] if ranks is None else _axis_for_ranks(
            mesh, ranks)
    group = Group(mesh, axis)
    group.id = len(_GROUP_REGISTRY) + 1
    _GROUP_REGISTRY[group.id] = group
    return group


def _axis_for_ranks(mesh, ranks):
    topo = topology.CommunicateTopology(
        list(mesh.axis_names), [mesh.shape[a] for a in mesh.axis_names])
    for name in mesh.axis_names:
        if sorted(ranks) in [sorted(g) for g in topo.get_comm_list(name)]:
            return name
    raise ValueError(f"ranks {ranks} do not form a mesh-axis group")


# group registry (the reference's gid -> Group; gid 0 is the world)
_GROUP_REGISTRY: Dict[int, Group] = {}


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        g = _default_group()
        g.id = 0
        return g
    if gid not in _GROUP_REGISTRY:
        raise ValueError(f"no group with id {gid}")
    return _GROUP_REGISTRY[gid]


# ------------------------------------------- row-parallel matmul

def mp_quant_matmul(x_parts, w_parts, block: Optional[int] = None):
    """Row-parallel matmul whose partial sums are reduced over the
    blockwise-int8 wire: rank r computes ``x_parts[r] @ w_parts[r]``
    (its slice of the reduction dim) and ``quantized_psum`` reduces the
    partials (the reference's ``ops/distributed.py`` ``mp_quant_matmul``
    under ``shard_map``).  Returns the reduced product on the first
    shard's device."""
    block = int(block) if block else _Q8_BLOCK
    partial = [torch.matmul(x, w) for x, w in zip(x_parts, w_parts)]
    return quantized_psum(partial, block)
