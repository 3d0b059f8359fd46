"""The mesh: a named grid of shards, each with a torch device.

Port of ``paddle_infer_tpu/parallel/topology.py`` (``HYBRID_AXES``,
``create_hybrid_mesh``, ``axis_if_divides``, the scoped current-mesh
and quantized-all-reduce settings and the training half below).  The
reference's topology IS a ``jax.sharding.Mesh`` and one SPMD program
runs over it; here a ``Mesh`` holds the axis sizes and one
``torch.device`` per coordinate, and one controller drives every
shard: the mesh-aware
layers (``nn/layers.py``, ``models/transformer_block.py``) run each
shard's slice of a product, or its kernel launch, on that shard's
device and reduce the partial results in a fixed rank order
(``parallel/collective.py``).

On the CPU a mesh of ``n`` shards takes ``[cpu] * n``, the counterpart
of the forced host device count under which the reference's tests run.
On the card the visible devices are ``torch.cuda.device_count()``; a
caller may pass ``devices=`` repeating one card, so an mp=2 mesh runs
both shards on one H100 (each shard's kernels launch over its own
heads).  A mesh over several DISTINCT CUDA devices raises
``ShardedConfigError``: serving and training across cards (peer copies
between devices, one CUDA graph per device) are not built yet.

The current mesh, its placement and the quantized-all-reduce mode are
per thread, set and restored by ``mesh_scope`` around every program an
engine runs and every training step's forward, so two engines stepping
on two threads (a fleet) never see each other's mesh.

The training half: ``CommunicateTopology`` (rank <-> coordinate
bookkeeping over the axes) and ``HybridCommunicateGroup`` (the degrees,
the mesh, per-axis ranks and groups), which ``parallel.fleet.init``
builds and ``set_hybrid_communicate_group`` makes current for the
process, as in the reference.  One controller drives every shard, so
the group's own rank is coordinate 0 (the reference's single-process
answer).
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, Optional, Sequence

import torch

# canonical axis names, outermost -> innermost (the reference's order)
HYBRID_AXES = ("pp", "dp", "sharding", "sep", "ep", "mp")


def _norm_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Axis names and sizes, and one ``torch.device`` per coordinate.

    ``shape`` maps each axis of ``HYBRID_AXES`` to its size (the
    reference's ``dict(mesh.shape)``); ``device(**coords)`` is the
    device of a coordinate (unnamed axes at 0); ``devices`` the flat
    list in row-major order over ``HYBRID_AXES``."""

    def __init__(self, sizes: Dict[str, int], devices: Sequence):
        self.axis_names = HYBRID_AXES
        self.shape = {a: int(sizes.get(a, 1)) for a in HYBRID_AXES}
        self.devices = [_norm_device(d) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} devices, "
                             f"got {len(self.devices)}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def device(self, **coords) -> torch.device:
        flat = 0
        for a in HYBRID_AXES:
            c = int(coords.get(a, 0))
            if not 0 <= c < self.shape[a]:
                raise IndexError(f"coordinate {a}={c} outside {self.shape}")
            flat = flat * self.shape[a] + c
        return self.devices[flat]

    @property
    def controller(self) -> torch.device:
        """The device of coordinate 0: where activations between the
        sharded layers live and where partial sums are reduced."""
        return self.devices[0]

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items() if s > 1)
        return f"Mesh({axes or 'single'}, devices={len(self.devices)})"


def visible_devices(device_type: str = "cuda"):
    """The devices a mesh may take by default: every visible card, or
    one CPU device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_hybrid_mesh(dp: int = 1, mp: int = 1, pp: int = 1,
                       sharding: int = 1, sep: int = 1, ep: int = 1,
                       devices: Optional[Sequence] = None) -> Mesh:
    """The hybrid mesh ``[pp, dp, sharding, sep, ep, mp]`` over
    ``devices``.  A longer device list is cut to the product of the
    degrees (a smaller job than the machine), as in the reference; a
    shorter one raises.  ``devices=None`` takes the visible cards and
    raises, as ``resolve_device(None)`` does, where none is visible: a
    mesh on the CPU passes ``devices=["cpu"] * n``."""
    degrees = {"pp": pp, "dp": dp, "sharding": sharding, "sep": sep,
               "ep": ep, "mp": mp}
    total = 1
    for v in degrees.values():
        total *= int(v)
    if devices is None:
        from .. import resolve_device

        resolve_device(None)
        devices = visible_devices("cuda")
    devices = [_norm_device(d) for d in devices]
    if total < len(devices):
        devices = devices[:total]
    if total != len(devices):
        from ..serving.sharded.mesh import ShardedConfigError

        raise ShardedConfigError(
            f"mesh degrees product {degrees} = {total} != device count "
            f"{len(devices)}: pass devices= with {total} entries (one "
            "card may repeat)")
    cards = {d for d in devices if d.type == "cuda"}
    if len(cards) > 1:
        from ..serving.sharded.mesh import ShardedConfigError

        raise ShardedConfigError(
            f"a mesh over {len(cards)} distinct CUDA devices "
            f"({sorted(str(d) for d in cards)}) is not supported: serving "
            "and training across cards are ROADMAP.md step 8; repeat one "
            "card in devices= to shard on it")
    return Mesh(degrees, devices)


def axis_if_divides(mesh, axis: str, dim: int) -> Optional[str]:
    """``axis`` when the mesh has it with size > 1 AND it divides
    ``dim``, else None (replicate).  The one gating rule for every
    serving-side sharding decision (params, pools, kernels, rows)."""
    if mesh is None:
        return None
    size = mesh.shape.get(axis, 1)
    return axis if (size > 1 and int(dim) % size == 0) else None


# ------------------------------------------------ per-thread settings

class _State(threading.local):
    mesh = None
    placement = None
    quantized = None


_STATE = _State()


class mesh_scope:
    """Make ``mesh``, its ``placement`` and the ``quantized`` all-reduce
    mode current on this thread while open (an engine's model step, a
    training step's forward) and restore the previous settings on exit,
    so a step never inherits another engine's mesh or wire format;
    nothing changes for ``mesh=None``."""

    def __init__(self, mesh, placement=None, quantized=None):
        self._mesh, self._placement = mesh, placement
        self._quant = quantized
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.mesh, _STATE.placement, _STATE.quantized)
        if self._mesh is not None:
            set_current_mesh(self._mesh, self._placement)
            set_quantized_allreduce(self._quant)
        return self

    def __exit__(self, *exc):
        _STATE.mesh, _STATE.placement, _STATE.quantized = self._prev
        return False


def set_current_mesh(mesh: Optional[Mesh], placement=None):
    """Make ``mesh`` (and the engine's parameter ``placement``, see
    ``inference.generation.Placement``) current on this thread."""
    _STATE.mesh = mesh
    _STATE.placement = placement if mesh is not None else None


def get_current_mesh() -> Optional[Mesh]:
    return _STATE.mesh


def get_current_placement():
    return _STATE.placement


def set_quantized_allreduce(mode: Optional[str]):
    """The wire format of the mp all-reduces run while it is set
    (``None`` exact, ``"int8"`` blockwise int8); scoped per program by
    ``mesh_scope``."""
    if mode not in (None, "int8"):
        raise ValueError(f"unsupported quantized all-reduce mode {mode!r}; "
                         "expected None or 'int8'")
    _STATE.quantized = mode


def get_quantized_allreduce() -> Optional[str]:
    return _STATE.quantized


# ------------------------------------------------------ training half

class CommunicateTopology:
    """Axis-name <-> coordinate bookkeeping over an n-D grid of ranks
    (row-major, the last axis fastest), plain index math."""

    def __init__(self, hybrid_group_names: Sequence[str],
                 dims: Sequence[int]):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world = list(itertools.product(*[range(d)
                                               for d in self._dims]))
        self._coord2rank = {c: i for i, c in enumerate(self._world)}

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        n = 1
        for d in self._dims:
            n *= d
        return n

    def get_rank(self, **axes) -> int:
        return self._coord2rank[tuple(axes[n]
                                      for n in self._parallel_names)]

    def get_coord(self, rank: int):
        return self._world[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self._world) if c[axis] == index]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The peer groups along ``axis_name``: for each setting of the
        other axes, the ranks that differ only there."""
        axis = self._parallel_names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in itertools.product(*others):
            ranks = []
            for k in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, k)
                ranks.append(self._coord2rank[tuple(coord)])
            groups.append(ranks)
        return groups


class HybridCommunicateGroup:
    """The fleet topology: the mesh over ``devices`` and the per-axis
    degree, rank and group queries.  ``PADDLE_TRAINER_ID`` sets the
    global rank, as in the reference; otherwise it is 0.

    In a job of ``processes`` > 1 (``parallel.fleet.init`` after
    ``distributed.init_parallel_env``) the mesh is this process's local
    one and dp spans the processes: the dp world size is the local dp
    times ``processes`` and this process's dp rank starts at
    ``process_index`` times the local dp."""

    def __init__(self, dp_degree: int = 1, mp_degree: int = 1,
                 pp_degree: int = 1, sharding_degree: int = 1,
                 sep_degree: int = 1, ep_degree: int = 1,
                 devices: Optional[Sequence] = None, processes: int = 1,
                 process_index: int = 0):
        self.mesh = create_hybrid_mesh(dp=dp_degree, mp=mp_degree,
                                       pp=pp_degree,
                                       sharding=sharding_degree,
                                       sep=sep_degree, ep=ep_degree,
                                       devices=devices)
        self._degrees: Dict[str, int] = dict(self.mesh.shape)
        self._topo = CommunicateTopology(
            list(HYBRID_AXES), [self._degrees[a] for a in HYBRID_AXES])
        self.processes = int(processes)
        self.process_index = int(process_index)
        self.global_rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) \
            if self.processes == 1 else 0
        self._coord = self._topo.get_coord(self.global_rank)

    def get_parallel_mode(self) -> str:
        if self._degrees["pp"] > 1:
            return "pipeline"
        if self._degrees["sharding"] > 1:
            return "sharding_parallel"
        if self._degrees["mp"] > 1:
            return "model_parallel"
        return "data_parallel"

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_global_rank(self) -> int:
        return self.global_rank

    def _rank(self, axis):
        return self._coord[HYBRID_AXES.index(axis)]

    def _group(self, axis):
        from .collective import Group

        return Group(self.mesh, axis)

    def get_data_parallel_world_size(self):
        return self._degrees["dp"] * self.processes

    def get_data_parallel_rank(self):
        return self.process_index * self._degrees["dp"] + self._rank("dp")

    def get_model_parallel_world_size(self):
        return self._degrees["mp"]

    def get_model_parallel_rank(self):
        return self._rank("mp")

    def get_pipe_parallel_world_size(self):
        return self._degrees["pp"]

    def get_stage_id(self):
        return self._rank("pp")

    def get_sharding_parallel_world_size(self):
        return self._degrees["sharding"]

    def get_sharding_parallel_rank(self):
        return self._rank("sharding")

    def get_sep_parallel_world_size(self):
        return self._degrees["sep"]

    def get_sep_parallel_rank(self):
        return self._rank("sep")

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_check_parallel_group(self):
        return self._group(HYBRID_AXES)

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._degrees["pp"] - 1


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    """Make ``hcg`` the process's topology (``fleet.init`` does)."""
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG


def active_mesh(mesh=None):
    """``mesh``, else this thread's current mesh, else the current
    hybrid group's."""
    if mesh is not None:
        return mesh
    mesh = get_current_mesh()
    if mesh is None and _HCG is not None:
        mesh = _HCG.mesh
    return mesh
