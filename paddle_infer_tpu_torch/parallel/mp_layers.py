"""Tensor-parallel layers, trained on a mesh.

Port of ``paddle_infer_tpu/parallel/mp_layers.py``:
``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding`` (the layers of ``nn/layers.py``, with the
reference's ``dist_attr`` stamps) and ``ParallelCrossEntropy``.

The reference's layers hold whole weights and GSPMD splits them by
their stamps.  Here ``FleetTrainStep`` makes the serving engine's
``inference.generation.Placement``, built with ``live=True``, current
around the step's forward: every tensor-parallel layer gets
``nn.layers.LinearShards`` / ``EmbeddingShards`` that slice the
CURRENT parameter at every call
(a column shard its output columns, a row shard its input rows, a
vocabulary shard its rows) and computes its part on its device; the
parts are gathered or summed in rank order to the controller, and
autograd flows back through the slices into the whole parameter.  Each
replica group (``dp``) runs its rows of the batch, so a parameter's
gradient is the sum of the groups' contributions, the data-parallel
all-reduce.  Expert stacks split over ``ep`` the same way
(``Placement.ep_parts``).  The reference's ``gather_output`` and
``input_is_parallel`` layout hints are not taken: activations between
layers are gathered on the controller, which changes no value.

``ParallelCrossEntropy`` splits the class dim of the logits over ``mp``:
each shard's max, its sum of exponentials and its picked target logit,
combined in rank order (the reference's two all-reduces of
``c_softmax_with_cross_entropy``); off a mesh it is
``functional.cross_entropy`` with ``reduction="none"``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import functional as PF
from ..nn.layers import (ColumnParallelLinear, RowParallelLinear,
                         VocabParallelEmbedding)
from . import collective, topology

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy"]


class ParallelCrossEntropy(nn.Module):
    """Softmax cross-entropy on logits whose class dim splits over
    ``mp``; the per-token loss (``reduction="none"``), 0 at
    ``ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        mesh = topology.active_mesh()
        V = input.shape[-1]
        if topology.axis_if_divides(mesh, "mp", V) is None:
            return PF.cross_entropy(input, label, reduction="none",
                                    ignore_index=self.ignore_index)
        n = mesh.shape["mp"]
        rows = V // n
        lbl = label.long()
        if lbl.dim() == input.dim():
            lbl = lbl.squeeze(-1)
        valid = lbl != self.ignore_index
        parts = [input[..., r * rows:(r + 1) * rows].float()
                 .to(mesh.device(mp=r)) for r in range(n)]
        # the max carries no gradient: log-sum-exp does not depend on it
        gmax = collective.all_reduce(
            [p.detach().amax(dim=-1, keepdim=True) for p in parts],
            op=collective.ReduceOp.MAX, group=collective.Group(mesh, "mp"))
        sums, picks = [], []
        for r, (p, m) in enumerate(zip(parts, gmax)):
            sums.append(torch.exp(p - m).sum(dim=-1))
            local = lbl.to(p.device) - r * rows
            inside = (local >= 0) & (local < rows) & valid.to(p.device)
            got = torch.gather(p, -1, torch.where(inside, local, 0)[..., None])
            picks.append(torch.where(inside, got[..., 0], 0.0))
        lse = torch.log(collective.sum_in_order(sums)) + gmax[0][..., 0]
        loss = lse - collective.sum_in_order(picks)
        return torch.where(valid.to(loss.device), loss, 0.0)
