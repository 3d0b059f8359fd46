"""Single-device layers of the serving path, as plain PyTorch modules.

Ports of ``paddle_infer_tpu/parallel/mp_layers.py``
(``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``) and ``nn/layers_common.py`` (``Embedding``,
``RMSNorm``, ``LayerNorm``).  The tensor-parallel layers keep their names and their
Paddle weight layout ``[in, out]`` so state dicts carry over one to one;
their mesh sharding is a later slice (ROADMAP.md slice B), so here they
are plain matmuls.

Parameters are allocated empty on the target device in the target dtype;
``reset_parameters(generator)`` fills them (Xavier, as the reference
initializers do), so a 7B model is never built on the CPU first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _xavier_uniform_(w: torch.Tensor, generator):
    fan_in, fan_out = w.shape[0], w.shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)


class ColumnParallelLinear(nn.Module):
    """y = x @ W + b, W ``[in, out]`` (output dim sharded under a mesh in
    the reference; single device here)."""

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

    def reset_parameters(self, generator=None):
        _xavier_uniform_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y + self.bias if self.bias is not None else y


class RowParallelLinear(ColumnParallelLinear):
    """y = x @ W + b, W ``[in, out]`` (reduction dim sharded under a mesh
    in the reference; on one device the same matmul as the column
    layer)."""


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
        return F.embedding(ids.long(), self.weight)


class VocabParallelEmbedding(Embedding):
    """Token embedding (vocab sharded under a mesh in the reference;
    single device here), Xavier-normal initialised."""

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / sum(self.weight.shape))
        self.weight.normal_(0.0, std, generator=generator)


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
        return F.layer_norm(x.to(torch.float32), self.normalized_shape,
                            self.weight.to(torch.float32),
                            self.bias.to(torch.float32),
                            self.epsilon).to(x.dtype)
