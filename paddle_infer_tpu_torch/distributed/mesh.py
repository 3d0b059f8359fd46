"""``ProcessMesh`` / ``DeviceMesh`` over the port's ``Mesh``.

Port of ``paddle_infer_tpu/distributed/mesh.py``.  The reference's
``to_jax_mesh`` builds a ``jax.sharding.Mesh``; here ``to_mesh`` builds
the port's ``parallel.topology.Mesh``: each named dim must be one of the
hybrid axes (``pp``, ``dp``, ``sharding``, ``sep``, ``ep``, ``mp``), and
each process id picks its device from ``devices`` (default: the card,
repeated for every id, as a mesh on one card is built).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..parallel import topology


class ProcessMesh:
    """An n-D logical processor grid with named dims."""

    def __init__(self, mesh: Sequence, dim_names: Optional[Sequence[str]] = None,
                 process_ids=None):
        arr = np.asarray(mesh)
        self.shape = list(arr.shape)
        self.ndim = arr.ndim
        self.dim_names = list(dim_names) if dim_names else [
            f"d{i}" for i in range(arr.ndim)]
        self.process_ids = arr.ravel().tolist()

    def to_mesh(self, devices: Optional[Sequence] = None) -> topology.Mesh:
        """The port's mesh over ``devices`` (indexed by process id)."""
        bad = [n for n in self.dim_names if n not in topology.HYBRID_AXES]
        if bad:
            raise ValueError(f"mesh dims {bad} are not hybrid axes "
                             f"{topology.HYBRID_AXES}")
        if devices is None:
            from .. import resolve_device

            devices = [resolve_device(None)] * (max(self.process_ids) + 1)
        sizes = dict(zip(self.dim_names, self.shape))
        # the port's mesh orders devices row-major over HYBRID_AXES
        order = [a for a in topology.HYBRID_AXES if a in sizes]
        ids = np.asarray(self.process_ids).reshape(self.shape).transpose(
            [self.dim_names.index(a) for a in order]).ravel()
        return topology.Mesh(sizes, [devices[i] for i in ids])

    to_jax_mesh = to_mesh


DeviceMesh = ProcessMesh


def set_mesh(mesh, devices: Optional[Sequence] = None):
    """Make ``mesh`` (a ``ProcessMesh`` or the port's ``Mesh``) current
    on this thread; returns the port's mesh."""
    if isinstance(mesh, ProcessMesh):
        mesh = mesh.to_mesh(devices)
    topology.set_current_mesh(mesh)
    return mesh


def get_mesh():
    return topology.get_current_mesh()
