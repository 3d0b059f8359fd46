"""``DataParallel``: a module wrapper that averages gradients over the
data-parallel group.

Port of ``paddle_infer_tpu/distributed/data_parallel.py`` (the
reference's ``DataParallel`` and its ``EagerReducer``).  After
``loss.backward()`` outside a compiled step, ``apply_collective_grads``
averages every parameter's ``.grad`` over the dp group:

* across processes (``init_parallel_env`` with more than one process),
  through the process group, summed in rank order
  (``parallel.collective.cross_process_mean``), so every rank holds the
  same bits;
* on a one-controller mesh, as the reference's ``all_reduce(AVG)`` over
  its dp axis of a replicated gradient: the gradient is already the
  whole batch's (autograd sums each shard's contribution on the one
  controller), so it is left as it is.
"""
from __future__ import annotations

import torch

from ..parallel import collective, topology


class DataParallel(torch.nn.Module):
    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _dp_group(self):
        if self._group is not None:
            return self._group
        hcg = topology.get_hybrid_communicate_group()
        if hcg is not None:
            return hcg.get_data_parallel_group()
        mesh = topology.get_current_mesh()
        if mesh is not None and mesh.shape.get("dp", 1) > 1:
            return collective.Group(mesh, "dp")
        return None

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average the gradients over the dp group (see the module
        docstring)."""
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        if grads:
            collective.cross_process_mean(grads)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, state, *a, **kw):
        return self._layers.load_state_dict(state, *a, **kw)

    scale_loss = staticmethod(lambda loss: loss)
