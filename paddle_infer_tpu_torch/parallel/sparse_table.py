"""Row-sharded sparse embedding tables: the parameter server.

Port of ``paddle_infer_tpu/parallel/sparse_table.py``.  The reference
keeps one ``[rows, dim]`` device array row-sharded over a mesh axis and
compiles pull and push as SPMD programs; here the table is a list of
row blocks, one per shard of the axis, each on its shard's device (on
one card every block sits on ``cuda:0``), and one controller runs each
verb shard by shard:

* ``pull_sparse``: each shard gathers the ids it owns, the others keep
  what earlier shards gave (a select per shard, rank order).
* ``push_sparse``: the batch's ids are de-duplicated once
  (``torch.unique``, sorted: the live prefix of the reference's
  ``jnp.unique(size=n, fill_value=-1)``, whose ``-1`` fill slots change
  no row), repeated ids sum their gradients, then each shard applies the
  optimizer rule to the rows it owns: a contiguous run of the sorted
  unique ids (``searchsorted``), so a shard's update touches distinct
  rows only (the reference sends dead slots to a scratch row instead).

Summation order.  Repeated ids are summed with ``index_put_(...,
accumulate=True)`` after a stable sort by the inverse index, inside
``torch.use_deterministic_algorithms``: the CPU runs it serially in
occurrence order (the order of JAX's ``segment_sum`` on the CPU) and
CUDA sums each run of equal indices in one thread in that order, with
no atomics, so two identical pushes give the same bits.  ``index_add_``
on CUDA would sum repeated indices with atomics in no fixed order; the
per-shard updates use it only on distinct rows, where each element
takes one add.

The push runs eagerly: ``torch.unique``'s size depends on the data, so
its host read rules out a CUDA graph.  Per-row optimizer state
(adagrad's accumulator, adam's moments) is sharded as the table.  The
initial table is ``N(0, initializer_range)`` from a torch generator on
the first shard's device seeded with ``seed`` (not JAX's bits; the
same for any shard count): ``set_state_dict`` loads any table, a JAX
one too.

``SparseEmbedding``'s lookup is a ``torch.autograd.Function`` (the
reference's ``PyLayer``) whose backward queues ``(ids, grad rows)`` on
the table; ``apply_pending`` pushes them.  None of this is a Pallas
kernel in the reference, so it stays plain PyTorch.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from . import topology


def _pick_axis(mesh, axis):
    if mesh is None or axis is False:     # axis=False forces one shard
        return None
    if axis is not None:
        return axis if mesh.shape.get(axis, 1) > 1 else None
    for cand in ("sharding", "mp", "dp"):
        if mesh.shape.get(cand, 1) > 1:
            return cand
    return None


@contextlib.contextmanager
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def segment_sum_in_order(values, inv, num_segments):
    """``jax.ops.segment_sum(values, inv, num_segments)`` with each
    segment summed in occurrence order (see the module docstring)."""
    order = torch.argsort(inv, stable=True)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    with _deterministic():
        out.index_put_((inv[order],), values[order], accumulate=True)
    return out


class ShardedSparseTable:
    """A ``[num_rows, dim]`` embedding table plus per-row optimizer
    state, row-sharded over a mesh axis (``sharding``, else ``mp``, else
    ``dp``; ``axis=False`` keeps one shard).  ``optimizer``: ``"sgd"``,
    ``"adagrad"`` or ``"adam"`` (the reference's accessor rules)."""

    def __init__(self, num_rows: int, dim: int, optimizer: str = "adagrad",
                 lr: float = 0.05, initializer_range: float = 0.01,
                 mesh=None, axis: Optional[str] = None,
                 dtype=torch.float32, seed: int = 0, eps: float = 1e-10,
                 beta1: float = 0.9, beta2: float = 0.999, device=None):
        assert optimizer in ("sgd", "adagrad", "adam")
        from .. import resolve_device

        self.dim = dim
        self.optimizer = optimizer
        self.lr = lr
        self.eps = eps
        self.beta1, self.beta2 = beta1, beta2
        mesh = mesh if mesh is not None else topology.active_mesh()
        self.mesh = mesh
        self.axis = _pick_axis(mesh, axis)
        self.nshard = mesh.shape[self.axis] if self.axis else 1
        if self.axis:
            self.devices = [mesh.device(**{self.axis: s})
                            for s in range(self.nshard)]
        else:
            self.devices = [mesh.controller if mesh is not None
                            else resolve_device(device)]
        self.num_rows = num_rows
        # padded so the shards split evenly (padding rows are never
        # addressed: ids are bounds-checked by the caller contract)
        self._rows_padded = ((num_rows + self.nshard - 1)
                             // self.nshard) * self.nshard
        self.rows_per_shard = self._rows_padded // self.nshard
        dev0 = self.devices[0]
        gen = torch.Generator(device=dev0).manual_seed(int(seed))
        full = torch.zeros((self._rows_padded, dim), dtype=torch.float32,
                           device=dev0)
        # drawn at the unpadded size: the rows do not depend on the shards
        full[:num_rows] = torch.randn((num_rows, dim), generator=gen,
                                      dtype=torch.float32,
                                      device=dev0) * initializer_range
        self.table = self._blocks(full.to(dtype))
        del full
        if optimizer == "adagrad":
            self.slot0 = self._blocks(torch.zeros((self._rows_padded,),
                                                  dtype=torch.float32))
            self.slot1 = None
        elif optimizer == "adam":
            self.slot0 = self._blocks(torch.zeros((self._rows_padded, dim),
                                                  dtype=torch.float32))
            self.slot1 = self._blocks(torch.zeros((self._rows_padded, dim),
                                                  dtype=torch.float32))
        else:
            self.slot0 = self.slot1 = None
        self._step = 0
        self._pending = []

    def _blocks(self, full: torch.Tensor):
        """``full`` ``[rows_padded, ...]`` as per-shard row blocks, each on
        its shard's device."""
        r = self.rows_per_shard
        return [full[s * r:(s + 1) * r].to(dev).clone()
                for s, dev in enumerate(self.devices)]

    def _whole(self, blocks) -> np.ndarray:
        return torch.cat([b.cpu() for b in blocks]).numpy()

    # ----------------------------------------------------------- pull
    @torch.no_grad()
    def pull_sparse(self, ids):
        """``ids`` (any shape) -> rows ``[..., dim]`` on the controller."""
        ids_t = torch.as_tensor(np.asarray(ids) if not isinstance(
            ids, torch.Tensor) else ids).to(torch.int64)
        shape = tuple(ids_t.shape)
        dev0 = self.devices[0]
        flat = ids_t.reshape(-1).to(dev0)
        out = None
        r = self.rows_per_shard
        for s, blk in enumerate(self.table):
            local = flat.to(blk.device) - s * r
            own = (local >= 0) & (local < r)
            rows = blk.index_select(0, local.clamp(0, r - 1)).to(dev0)
            out = rows if out is None else torch.where(
                own.to(dev0)[:, None], rows, out)
        return out.reshape(shape + (self.dim,))

    # ----------------------------------------------------------- push
    @torch.no_grad()
    def push_sparse(self, ids, grads, lr: Optional[float] = None):
        """Apply sparse gradients: ``ids [n]``, ``grads [n, dim]``."""
        dev0 = self.devices[0]
        ids_t = torch.as_tensor(ids).to(dev0, torch.int64).reshape(-1)
        g_in = torch.as_tensor(grads).to(dev0, torch.float32).reshape(
            -1, self.dim)
        self._step += 1
        lr = float(lr if lr is not None else self.lr)
        uniq, inv = torch.unique(ids_t, sorted=True, return_inverse=True)
        g = segment_sum_in_order(g_in, inv, uniq.shape[0])
        r = self.rows_per_shard
        bounds = torch.searchsorted(uniq, torch.arange(
            0, (self.nshard + 1) * r, r, device=dev0)).tolist()
        for s in range(self.nshard):
            lo, hi = bounds[s], bounds[s + 1]
            if hi > lo:
                dev = self.devices[s]
                self._apply(s, (uniq[lo:hi] - s * r).to(dev),
                            g[lo:hi].to(dev), lr)

    def _apply(self, s, idx, g, lr):
        """The optimizer rule on shard ``s``'s distinct local rows
        ``idx`` with their summed gradients ``g``."""
        tbl = self.table[s]
        if self.optimizer == "sgd":
            upd = lr * g
        elif self.optimizer == "adagrad":
            acc = self.slot0[s]
            acc.index_add_(0, idx, torch.sum(g * g, dim=1))
            denom = torch.sqrt(acc[idx] / self.dim + self.eps)
            upd = (lr / denom)[:, None] * g
        else:
            b1, b2 = self.beta1, self.beta2
            m_rows = self.slot0[s][idx] * b1 + (1 - b1) * g
            v_rows = self.slot1[s][idx] * b2 + (1 - b2) * g * g
            self.slot0[s].index_copy_(0, idx, m_rows)
            self.slot1[s].index_copy_(0, idx, v_rows)
            step = np.float32(self._step)
            bc1 = float(np.float32(1) - np.float32(b1) ** step)
            bc2 = float(np.float32(1) - np.float32(b2) ** step)
            upd = lr * (m_rows / bc1) / (torch.sqrt(v_rows / bc2) + self.eps)
        tbl.index_add_(0, idx, -upd.to(tbl.dtype))

    # -------------------------------------------- eager-layer integration
    def queue_grad(self, ids, grads):
        self._pending.append((ids, grads))

    def apply_pending(self, lr: Optional[float] = None):
        """Push every gradient queued by ``SparseEmbedding`` backward
        passes as one batch (the reference's communicator flush)."""
        if not self._pending:
            return
        ids = torch.cat([torch.as_tensor(i).reshape(-1).to(torch.int64)
                         .to(self.devices[0]) for i, _ in self._pending])
        grads = torch.cat([torch.as_tensor(g).reshape(-1, self.dim)
                           .to(self.devices[0], torch.float32)
                           for _, g in self._pending])
        self._pending = []
        self.push_sparse(ids, grads, lr)

    # ------------------------------------------------------------- state
    def state_dict(self):
        d = {"table": self._whole(self.table)[: self.num_rows]}
        if self.slot0 is not None:
            d["slot0"] = self._whole(self.slot0)[: self.num_rows]
        if self.slot1 is not None:
            d["slot1"] = self._whole(self.slot1)[: self.num_rows]
        return d

    def set_state_dict(self, d):
        def put(cur, new):
            arr = torch.as_tensor(np.array(new)).to(cur[0].dtype)
            pad = self._rows_padded - arr.shape[0]
            if pad:
                arr = torch.cat([arr, torch.zeros((pad,) + tuple(
                    arr.shape[1:]), dtype=arr.dtype)])
            return self._blocks(arr)

        self.table = put(self.table, d["table"])
        if "slot0" in d and self.slot0 is not None:
            self.slot0 = put(self.slot0, d["slot0"])
        if "slot1" in d and self.slot1 is not None:
            self.slot1 = put(self.slot1, d["slot1"])


class _Lookup(torch.autograd.Function):
    """Rows of the table for ``ids``; the backward queues ``(ids, grad
    rows)`` on the table instead of making a dense gradient."""

    @staticmethod
    def forward(ctx, hook, ids, table):
        ctx.ids = ids
        ctx.table = table
        return table.pull_sparse(ids)

    @staticmethod
    def backward(ctx, grad):
        ctx.table.queue_grad(ctx.ids.reshape(-1),
                             grad.reshape(-1, ctx.table.dim))
        return None, None, None


class SparseEmbedding(torch.nn.Module):
    """An embedding backed by a ``ShardedSparseTable``: the backward
    yields ``(ids, grad rows)`` for the table, never a dense ``[rows,
    dim]`` gradient (the reference's ``sparse_embedding``)."""

    def __init__(self, num_embeddings, embedding_dim, table=None, **kw):
        super().__init__()
        self.table = table or ShardedSparseTable(num_embeddings,
                                                 embedding_dim, **kw)
        # ids carry no gradient: the lookup tapes through this float hook
        self._tape_hook = torch.nn.Parameter(
            torch.zeros((1,), device=self.table.devices[0]))

    def forward(self, ids):
        ids = torch.as_tensor(ids).to(self.table.devices[0], torch.int64)
        return _Lookup.apply(self._tape_hook, ids, self.table)


__all__ = ["ShardedSparseTable", "SparseEmbedding", "segment_sum_in_order"]
