"""Single-device layers of the serving path, as plain PyTorch modules.

Ports of ``paddle_infer_tpu/parallel/mp_layers.py``
(``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``) and ``nn/layers_common.py`` (``Linear``,
``Embedding``, ``Dropout``, ``RMSNorm``, ``LayerNorm``, and for the
high-level API ``ReLU``, ``Sequential`` and ``CrossEntropyLoss``).  The tensor-parallel layers keep their names and their
Paddle weight layout ``[in, out]`` so state dicts carry over one to one.

Under a serving mesh (``parallel/topology.py``; an engine built with
``mesh=`` makes its mesh and parameter placement current around every
model step) the tensor-parallel layers run per shard, as the
reference's ``mp_layers.py`` stamps them (``dist_attr``): a column
layer's shard holds its slice of output columns and the slices are
gathered; a row layer's shard holds its slice of input rows, and its
output is the fixed-order sum of the partial products (the blockwise
int8 ``quantized_psum`` under ``quantized_allreduce="int8"``) with the
bias added once, after the sum; the vocab embedding's shard holds its
slice of the vocabulary, looks up the ids in its range and the masked
lookups are summed.  Each replica group (``dp``) runs its own rows.
``LinearShards`` holds one layer's slices, made once by the engine's
placement (``inference.generation.Placement``); without a placement the
layers are plain single-device matmuls.

Parameters are allocated empty on the target device in the target dtype;
``reset_parameters(generator)`` fills them (Xavier, as the reference
initializers do), so a 7B model is never built on the CPU first.
Parameters are created with ``requires_grad=False`` (serving); a
training model turns them on (``models/ernie.py``).  On a training mesh
(a live ``inference.generation.Placement``) the same shards slice the live
parameters at every call, so autograd reaches them.

Every forward follows the O2 rule of ``amp.py`` through the port's
functional ops, so under ``amp_scope`` float32 parameters are cast to
bf16 where they are used; outside it nothing changes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import amp
from ..parallel import collective, topology
from . import functional as PF


def _xavier_uniform_(w: torch.Tensor, generator):
    fan_in, fan_out = w.shape[0], w.shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)


class ColumnParallelLinear(nn.Module):
    """y = x @ W + b, W ``[in, out]``, the output dim split over ``mp``
    under a mesh (each shard's columns, gathered)."""

    # the reference's dist_attr stamps: which mesh axis splits each dim
    _DIST = {"weight": (None, "mp"), "bias": ("mp",)}
    _KIND = "column"

    def __init__(self, in_features, out_features, has_bias=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype),
                                  requires_grad=False)
                     if has_bias else None)
        _stamp(self, self._DIST)

    def reset_parameters(self, generator=None):
        _xavier_uniform_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        sh = mesh_shards(self)
        if sh is None:
            return PF.linear(x, self.weight, self.bias)
        return sh.forward(x)


class RowParallelLinear(ColumnParallelLinear):
    """y = x @ W + b, W ``[in, out]``, the reduction dim split over
    ``mp`` under a mesh (the bias replicated and added after the
    sum)."""

    _DIST = {"weight": ("mp", None)}
    _KIND = "row"


class Embedding(nn.Module):
    """Lookup table ``[num_embeddings, embedding_dim]`` (GPT's learned
    positions); initialised N(0, 1) as the reference's."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype),
            requires_grad=False)

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids):
        return PF.embedding(ids, self.weight)


class VocabParallelEmbedding(Embedding):
    """Token embedding, Xavier-normal initialised; its vocabulary rows
    split over ``mp`` under a mesh."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
        _stamp(self, {"weight": ("mp", None)})

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / sum(self.weight.shape))
        self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids):
        sh = mesh_shards(self)
        if sh is None:
            return PF.embedding(ids, self.weight)
        return sh.lookup(ids)

    def logits(self, x):
        """``x @ weight.T``: the LM head tied to this table (GPT); under
        a mesh each shard scores its slice of the vocabulary and the
        slices are gathered."""
        sh = mesh_shards(self)
        if sh is None:
            return torch.matmul(amp.cast(x, "matmul"),
                                amp.cast(self.weight, "matmul").t())
        return sh.tied_logits(x)


class RMSNorm(nn.Module):
    """RMSNorm computed in float32 and cast back (the reference's
    ``rms_norm`` dtype policy)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(hidden_size, device=device,
                                               dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)

    def forward(self, x):
        return F.rms_norm(x.to(torch.float32), (x.shape[-1],),
                          self.weight.to(torch.float32),
                          self.epsilon).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dims, float32 statistics."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(
            self.normalized_shape, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(
            self.normalized_shape, device=device, dtype=dtype),
            requires_grad=False)

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return PF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.epsilon)


class Linear(ColumnParallelLinear):
    """``y = x @ W + b`` with W ``[in, out]`` (``nn/layers_common.py``
    ``Linear``): never sharded."""

    _DIST = {}
    _KIND = None


class Dropout(nn.Module):
    """Hash-RNG dropout drawing its keys from ``keys`` (a
    ``core.random.KeyStream``); an identity in eval."""

    def __init__(self, p=0.5, mode="upscale_in_train", keys=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.keys = keys

    def forward(self, x):
        return PF.dropout(x, p=self.p, training=self.training,
                          mode=self.mode, keys=self.keys)


class ReLU(nn.Module):
    """``max(x, 0)`` (``nn/layers_common.py`` ``ReLU``)."""

    def forward(self, x):
        return F.relu(amp.cast(x, "relu"))


class Sequential(nn.Sequential):
    """Layers applied in order (``nn/layers_common.py`` ``Sequential``):
    named ``"0"``, ``"1"``, ... or by ``(name, layer)`` pairs, given as
    arguments or as one list of pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = tuple(layers[0])
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class CrossEntropyLoss(nn.Module):
    """Softmax cross-entropy over the last axis with integer labels
    (``nn/layers_common.py`` ``CrossEntropyLoss``), through
    ``functional.cross_entropy``.  Class weights, soft labels and
    ``use_softmax=False`` are not ported (ROADMAP.md item 14, the ``nn``
    surface) and raise."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True):
        super().__init__()
        if weight is not None or soft_label or not use_softmax:
            raise NotImplementedError(
                "CrossEntropyLoss with weight, soft_label or use_softmax="
                "False is not ported; see ROADMAP.md item 14")
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.axis = axis

    def forward(self, input, label):
        return PF.cross_entropy(input, label, ignore_index=self.ignore_index,
                                reduction=self.reduction, axis=self.axis)


# ------------------------------------------------------------ mesh shards

def _stamp(module, dist):
    """Stamp the reference's ``dist_attr`` on the module's parameters."""
    for name, spec in dist.items():
        p = getattr(module, name, None)
        if p is not None:
            p.dist_attr = tuple(spec)


def mesh_shards(module):
    """The current placement's shards of ``module`` (None off a mesh, or
    for a layer the placement left whole)."""
    pl = topology.get_current_placement()
    return None if pl is None else pl.get(module)


def row_groups(mesh, b):
    """``[(dp coordinate, row slice)]``: each replica group's rows of a
    batch of ``b`` (one group holding every row when ``dp`` does not
    divide ``b``, the reference's replicated fallback)."""
    if topology.axis_if_divides(mesh, "dp", b) is None:
        return [(0, slice(None))]
    n = b // mesh.shape["dp"]
    return [(g, slice(g * n, (g + 1) * n)) for g in range(mesh.shape["dp"])]


def mp_sum(parts):
    """The fixed-rank-order sum of per-shard partial products (blockwise
    int8 over the wire while the current program serves with
    ``quantized_allreduce="int8"``), on the first shard's device."""
    if len(parts) == 1:
        return parts[0]
    if topology.get_quantized_allreduce() == "int8" \
            and parts[0].dtype != torch.int32:
        return collective.quantized_psum(parts)
    return collective.sum_in_order(parts)


def mp_block(x, cols, act, row):
    """A column -> row pair (an MLP) on the mesh: for each replica
    group's rows and each mp shard r, ``row_r(act(col_r(x), ...))``,
    the partial outputs summed in rank order and the row bias added
    once.  ``cols`` are the column layers' shards, ``act`` combines
    their outputs."""
    mesh = row.mesh
    outs = []
    for g, rows in row_groups(mesh, x.shape[0]):
        parts = []
        for r in range(row.n):
            xg = _to(x[rows], mesh.device(dp=g, mp=r))
            parts.append(row.product(r, act(*[c.product(r, xg, rows)
                                               for c in cols]), rows))
        outs.append(_to(row.finish(mp_sum(parts)), mesh.controller))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _to(t, dev):
    return t if t is None or t.device == dev else t.to(dev)


class LinearShards:
    """One column or row layer's per-shard slices under a mesh.

    ``index[r]`` is shard r's output columns (column) or input rows
    (row); ``n`` the shard count (1 when ``mp`` does not divide the dim:
    the layer stays whole, the reference's replicated fallback).  A
    weight-only layer's shards slice its int8 / int4 payload and scales
    the same way and dequantize per shard; an ``Int8Linear``'s slice its
    int8 weight and per-channel scales, and a row shard's int32
    accumulators are summed exactly before the one scaling.  A
    ``LoRAServingLinear`` is sliced as its base layer, and each shard
    adds its part of the delta read from the live pools: a column shard
    its columns of B, a row shard the delta of its rows of A, which
    joins the partial sum.  ``heads[r]`` (a fused QKV split by head) is
    ``(q heads, kv heads, kv index or None)``.

    ``live=True`` (training) slices the layer's current tensors at every
    call instead of copying them once, so autograd reaches the whole
    parameter through each shard's slice (and a ``functional_call``
    swap is seen)."""

    def __init__(self, layer, mesh, kind, n, index, heads=None, live=False):
        from ..serving.adapters.layer import LoRAServingLinear

        self.mesh = mesh
        self.kind = kind
        self.n = n
        self.index = index
        self.heads = heads
        self.lora = layer if isinstance(layer, LoRAServingLinear) else None
        base = layer.inner if self.lora is not None else layer
        self.layer = base if live else None
        self.int8 = hasattr(base, "w_scale")
        self.act_scale = getattr(base, "act_scale", 1.0)
        self.algo = None if self.int8 else getattr(base, "algo", None)
        self.group_size = getattr(base, "group_size", -1)
        self._dtype = None
        self.parts = None if live else [
            tuple(None if t is None else _place(t, mesh.device(mp=r),
                                                self.int8)
                  for t in self._slice(base, index[r])) for r in range(n)]
        # a row layer's bias is whole, added once after the sum
        self._bias = base.bias if kind == "row" else None

    @property
    def bias(self):
        if self.layer is not None and self.kind == "row":
            return self.layer.bias
        return self._bias

    def _part(self, r):
        if self.parts is not None:
            return self.parts[r]
        dev = self.mesh.device(mp=r)
        return tuple(None if t is None else _to(t, dev)
                     for t in self._slice(self.layer, self.index[r]))

    def _slice(self, layer, idx):
        """Shard tensors ``(weight, bias)``, ``(payload, scales, bias)``
        or an int8 layer's ``(int8 weight, scales, bias)``; a row shard
        carries no bias."""
        col = self.kind == "column"
        bias = None if not col or layer.bias is None else layer.bias[idx]
        if self.int8:
            qw, sc = layer.qweight, layer.w_scale
            return ((qw[:, idx], sc[idx], bias) if col
                    else (qw[idx], sc, None))
        if not hasattr(layer, "qweight"):
            return (layer.weight[:, idx] if col else layer.weight[idx],
                    bias)
        qw, sc = layer.qweight, layer.scale
        if col:
            return (qw[:, idx], sc[:, idx], bias)
        if self.n == 1:
            return (qw, sc, None)
        rows = idx.stop - idx.start
        packed = 2 if self.algo == "weight_only_int4" else 1
        groups = sc.shape[0]
        gs = layer.in_features // groups
        if rows % packed or (groups > 1 and rows % gs):
            raise ValueError("a row shard must hold whole packed rows and "
                             "scale groups")
        ssl = (slice(None) if groups == 1
               else slice(idx.start // gs, idx.stop // gs))
        return (qw[idx.start // packed:idx.stop // packed], sc[ssl], None)

    def product(self, r, x, rows=slice(None)):
        """Shard r's product on its slice (its bias slice included for a
        column layer, never for a row layer); ``rows`` are the batch rows
        ``x`` holds (a replica group's), which pick the LoRA slots."""
        p = self._part(r)
        if self.int8:
            from ..quantization.int8 import int8_accumulate, int8_linear

            self._dtype = x.dtype
            if self.kind == "row" and self.n > 1 and self.lora is None:
                # the exact int32 partial sum, scaled once in finish
                y = int8_accumulate(x, p[0], self.act_scale)
            else:
                y = int8_linear(x, p[0], p[1], p[2],
                                act_scale=self.act_scale)
        elif self.algo is None:
            y = PF.linear(x, p[0], p[1])
        else:
            from ..quantization.weight_only import weight_only_linear

            y = weight_only_linear(x, p[0], p[1], p[-1], algo=self.algo,
                                   group_size=self.group_size)
        if self.lora is not None:
            y = self._lora_delta(r, x, y, rows)
        return y

    def _lora_delta(self, r, x, y, rows):
        """``y`` plus this shard's part of the LoRA delta (float32; the
        sum is cast back to ``y``'s dtype for a column shard, after the
        reduction for a row shard)."""
        from ..serving.adapters import slots as lora_slots

        slots = lora_slots.row_slots()
        if slots is None:
            return y
        lo, dev = self.lora, y.device
        sl = _to(slots[rows], dev).long()
        ga = _to(lo.lora_a, dev)[sl]                 # [b, d_in, rank]
        gb = _to(lo.lora_b, dev)[sl]                 # [b, rank, d_out]
        if self.n > 1 and self.kind == "column":
            gb = gb[..., self.index[r]]
        elif self.n > 1:
            ga = ga[:, self.index[r]]
        delta = torch.bmm(torch.bmm(x.to(torch.float32), ga), gb)
        out = y.to(torch.float32) + _to(lo.lora_scale, dev)[sl][
            :, None, None] * delta
        if self.kind == "column" or self.n == 1:
            return out.to(y.dtype)
        self._dtype = y.dtype
        return out

    def finish(self, y):
        """A row layer's reduced output plus its bias (an int8 layer's
        exact int32 sum scaled first), in the layer's output dtype."""
        if self.kind != "row":
            return y
        bias = self.bias
        if y.dtype == torch.int32:
            p = self._part(0)
            y = y.to(torch.float32) * (_to(p[1], y.device)
                                       * float(self.act_scale))
            if bias is not None:
                y = y + _to(bias, y.device).to(torch.float32)
            return y.to(self._dtype)
        if bias is not None:
            y = y + _to(bias, y.device).to(y.dtype)
        return y if self._dtype is None else y.to(self._dtype)

    def forward(self, x):
        """The whole layer over ``x [b, ..., in]`` on the mesh's
        controller device: each replica group's rows through every
        shard."""
        mesh = self.mesh
        ctrl = mesh.controller
        outs = []
        for g, rows in row_groups(mesh, x.shape[0]):
            xg = x[rows]
            if self.n == 1:
                y = self.product(0, _to(xg, mesh.device(dp=g)), rows)
                if self.kind == "row":
                    y = self.finish(y)
            elif self.kind == "column":
                y = collective.gather_in_order(
                    [self.product(r, _to(xg, mesh.device(dp=g, mp=r)), rows)
                     for r in range(self.n)], dim=-1)
            else:
                y = self.finish(mp_sum(
                    [self.product(r, _to(xg[..., self.index[r]],
                                         mesh.device(dp=g, mp=r)), rows)
                     for r in range(self.n)]))
            outs.append(_to(y, ctrl))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _place(t, dev, int8_act=False):
    """A serving shard's own copy of a slice on ``dev`` (an
    ``Int8Linear``'s weight kept column-major, the layout of the card's
    IMMA kernel)."""
    if int8_act and t.dtype == torch.int8:
        return t.t().contiguous().t().to(dev)
    return t.contiguous().to(dev)


def linear_shards(layer, mesh, live=False):
    """``LinearShards`` of a column / row layer (plain, weight-only,
    int8 or a LoRA wrapper of one): contiguous blocks of the split dim,
    or for a fused QKV whose heads ``_qkv_heads = (hq, hkv, head_dim)``
    name, each shard's query heads with the key / value heads they
    read."""
    src = getattr(layer, "inner", layer)
    kind = getattr(src, "_mp_kind", None) if hasattr(src, "qweight") \
        else getattr(src, "_KIND", None)
    if kind is None:
        return None
    dim = src.out_features if kind == "column" else src.in_features
    heads = getattr(src, "_qkv_heads", None)
    kw = dict(live=live)
    mp = mesh.shape["mp"]
    if heads is not None:
        hq, hkv, d = heads
        if topology.axis_if_divides(mesh, "mp", hq) is None:
            return LinearShards(layer, mesh, kind, 1, [slice(None)], **kw)
        hs, rep = hq // mp, hq // hkv
        index, per = [], []
        for r in range(mp):
            lo, hi = (r * hs) // rep, ((r + 1) * hs - 1) // rep + 1
            cols = [h * d + i for h in range(r * hs, (r + 1) * hs)
                    for i in range(d)]
            for base in (hq, hq + hkv):
                cols += [(base + h) * d + i for h in range(lo, hi)
                         for i in range(d)]
            index.append(torch.tensor(cols, dtype=torch.long,
                                      device=layer_device(src)))
            kv = [(r * hs + j) // rep - lo for j in range(hs)]
            plain = kv == [j // rep for j in range(hs)] and (hi - lo) * rep \
                == hs
            per.append((hs, hi - lo, None if plain else torch.tensor(
                kv, dtype=torch.long, device=mesh.device(mp=r))))
        return LinearShards(layer, mesh, kind, mp, index, heads=per, **kw)
    if topology.axis_if_divides(mesh, "mp", dim) is None:
        return LinearShards(layer, mesh, kind, 1, [slice(None)], **kw)
    n = dim // mp
    return LinearShards(layer, mesh, kind, mp,
                        [slice(r * n, (r + 1) * n) for r in range(mp)], **kw)


def layer_device(layer):
    return next(iter(list(layer.parameters()) + list(layer.buffers())))\
        .device


class EmbeddingShards:
    """A vocab-parallel table's per-shard row slices: ``lookup`` sums
    the shards' masked lookups, ``tied_logits`` gathers their vocabulary
    slices of ``x @ weight.T``.  ``live=True`` slices the current table
    at every call (training: autograd reaches the table through each
    shard's rows)."""

    def __init__(self, layer, mesh, live=False):
        self.mesh = mesh
        V = layer.weight.shape[0]
        self.n = mesh.shape["mp"] if topology.axis_if_divides(
            mesh, "mp", V) else 1
        self.rows = V // self.n
        self.layer = layer if live else None
        self._parts = None if live else [
            layer.weight[r * self.rows:(r + 1) * self.rows]
            .contiguous().to(mesh.device(mp=r)) for r in range(self.n)]

    @property
    def parts(self):
        if self._parts is not None:
            return self._parts
        w = self.layer.weight
        return [_to(w[r * self.rows:(r + 1) * self.rows],
                    self.mesh.device(mp=r)) for r in range(self.n)]

    def lookup(self, ids):
        mesh = self.mesh
        tables = self.parts
        outs = []
        for g, rows in row_groups(mesh, ids.shape[0]):
            parts = []
            for r in range(self.n):
                dev = mesh.device(dp=g, mp=r)
                local = _to(ids[rows], dev).long() - r * self.rows
                inside = (local >= 0) & (local < self.rows)
                e = PF.embedding(torch.where(inside, local,
                                             torch.zeros_like(local)),
                                 tables[r])
                parts.append(e * inside[..., None].to(e.dtype))
            outs.append(_to(collective.sum_in_order(parts),
                            mesh.controller))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def tied_logits(self, x):
        mesh = self.mesh
        tables = self.parts
        outs = []
        for g, rows in row_groups(mesh, x.shape[0]):
            parts = [torch.matmul(_to(x[rows], mesh.device(dp=g, mp=r)),
                                  tables[r].t())
                     for r in range(self.n)]
            outs.append(_to(collective.gather_in_order(parts, dim=-1),
                            mesh.controller))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
