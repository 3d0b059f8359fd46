"""Pipeline parallelism over the ``pp`` mesh axis.

Port of ``paddle_infer_tpu/parallel/pipeline.py``: ``LayerDesc`` and
``PipelineStack``.  A homogeneous stack of N blocks keeps every
parameter layer-stacked, ``(N, ...)``, stamped ``("pp", ...)``, so
stage s holds layers ``s·N/pp .. (s+1)·N/pp - 1`` (the reference's
stage partitioning, as a placement).

The schedule is fill-drain over ``micro_batches`` (the reference's
``accumulate_steps``): at tick t stage s runs micro-batch t - s through
its resident layers on the device of ``pp = s`` and hands the
activation to stage s + 1 (the stage-to-stage hop, a ``.to`` of the next
stage's device); after M + pp - 1 ticks the last stage holds every
output.  ``interleave = v > 1`` gives each stage v non-contiguous
chunks (chunk j on stage j % pp) and micro-batch m = pp·g + r makes its
(w, s) visit at tick s + r + pp·(g·v + w), every activation moving one
hop a tick round the ring (the reference's closed-form conflict-free
schedule; L must divide by pp·v and M by pp).  ``recompute=True``
checkpoints each layer (``torch.utils.checkpoint``).  The backward is
autograd's through the schedule, as the reference derives its own by
differentiating the program.  Without a mesh (or at pp = 1) the layers
run in sequence.

Each layer runs as the template block with its slice of the stacks
(``torch.func.functional_call``); the blocks are built from the
``LayerDesc`` and filled by their ``reset_parameters`` from a seeded
``torch.Generator`` (``seed``), then stacked.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from . import topology


class LayerDesc:
    """Deferred layer construction, so the stack can build one template
    and N parameter sets."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)


def _sanitize(name: str) -> str:
    return name.replace(".", "__")


class PipelineStack(nn.Module):
    """N identical blocks, parameters layer-stacked and split over
    ``pp``; embeddings and heads stay outside."""

    def __init__(self, desc: LayerDesc, num_layers: int,
                 micro_batches: int = 1, recompute: bool = False,
                 interleave: int = 1, seed: int = 0):
        super().__init__()
        self.num_layers = int(num_layers)
        self.micro_batches = int(micro_batches)
        self.recompute = bool(recompute)
        self.interleave = int(interleave)
        template = desc.build()
        object.__setattr__(self, "_template", template)
        instances = [desc.build() for _ in range(self.num_layers)]
        self._pnames = [n for n, _ in template.named_parameters()]
        dev = next(template.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for inst in instances:
                for mod in inst.modules():
                    if hasattr(mod, "reset_parameters"):
                        mod.reset_parameters(gen)
            for n, tp in template.named_parameters():
                stacked = torch.stack([dict(inst.named_parameters())[n]
                                       for inst in instances])
                p = nn.Parameter(stacked, requires_grad=True)
                da = tuple(getattr(tp, "dist_attr", None) or ())
                p.dist_attr = ("pp",) + da + (None,) * (
                    stacked.dim() - 1 - len(da))
                self.register_parameter(_sanitize(n), p)

    def train(self, mode: bool = True):
        self._template.train(mode)
        return super().train(mode)

    def _apply_layer(self, i, h):
        params = {n: getattr(self, _sanitize(n))[i] for n in self._pnames}
        return functional_call(self._template, params, (h,))

    def _run(self, layers, h):
        for i in layers:
            if self.recompute and torch.is_grad_enabled():
                h = checkpoint(self._apply_layer, i, h, use_reentrant=False)
            else:
                h = self._apply_layer(i, h)
        return h

    def forward(self, x):
        mesh = topology.active_mesh()
        pp = mesh.shape["pp"] if mesh is not None else 1
        L = self.num_layers
        if pp <= 1:
            return self._run(range(L), x)
        if L % pp:
            raise ValueError(f"num_layers {L} not divisible by pp degree "
                             f"{pp}")
        M, B = self.micro_batches, x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by micro_batches {M}")
        v = self.interleave
        if v > 1 and L % (pp * v):
            raise ValueError(f"num_layers {L} not divisible by "
                             f"pp*interleave {pp * v}")
        if v > 1 and M % pp:
            raise ValueError(f"interleave needs micro_batches {M} divisible "
                             f"by pp {pp}")
        chunk = L // (pp * v)
        devs = [mesh.device(pp=s) for s in range(pp)]
        mbs = torch.chunk(x, M, dim=0)
        out = [None] * M
        state = [None] * pp
        for t in range(M * v + pp - 1):
            nxt = [None] * pp
            for s in range(pp):
                u = t - s
                if not 0 <= u < M * v:
                    continue
                r, q = u % pp, u // pp
                w, g = q % v, q // v
                m = pp * g + r if v > 1 else u
                if s == 0 and w == 0:
                    h = mbs[m].to(devs[0])
                else:
                    h = state[s]
                first = (w * pp + s) * chunk
                h = self._run(range(first, first + chunk), h)
                if s == pp - 1 and w == v - 1:
                    out[m] = h.to(mesh.controller)
                else:
                    nxt[(s + 1) % pp] = h.to(devs[(s + 1) % pp])
            state = nxt
        return torch.cat(out, dim=0)
