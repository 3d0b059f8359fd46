"""The process group: rendezvous, rank and world size.

Port of ``paddle_infer_tpu/distributed/env.py``.  The reference starts
``jax.distributed`` (its coordination service) for a multi-process
job; here ``init_parallel_env`` starts ``torch.distributed``'s default
process group from the same variables:

* the rendezvous address, ``PTI_COORDINATOR_ADDR`` or ``PADDLE_MASTER``
  (``host:port``, used as ``tcp://host:port``);
* the process count, ``PTI_NUM_PROCESSES`` or ``PADDLE_TRAINERS_NUM``;
* this process's rank, ``PTI_PROCESS_ID`` or ``PADDLE_TRAINER_ID``.

A job of one process needs no group, as in the reference.

The backend is chosen, never switched behind the caller's back:

* ``gloo`` where the process has no card;
* ``nccl`` where each rank of this host has a card of its own
  (``PTI_LOCAL_RANK`` picks it, ``PTI_LOCAL_WORLD_SIZE`` says how many
  ranks share the host; ``launch.spawn`` sets both);
* where the host's ranks would share a card, NCCL refuses ("Duplicate GPU
  detected"), so the call raises unless the caller passes
  ``backend="gloo"``.

``get_rank`` / ``get_world_size`` are the process group's (0 and 1
without one); ``PTI_DP_WORLD_SIZE`` overrides the world size, as in the
reference.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

_initialized = False
_backend: Optional[str] = None


def _int_env(name, default):
    v = os.environ.get(name)
    return int(v) if v is not None else default


def _dist():
    import torch.distributed as dist

    return dist


def choose_backend(backend: Optional[str] = None,
                   world_size: Optional[int] = None) -> str:
    """The backend this process would use (see the module docstring)."""
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs a CUDA device")
        return backend
    if not torch.cuda.is_available():
        return "gloo"
    local = _int_env("PTI_LOCAL_WORLD_SIZE", world_size or 1)
    cards = torch.cuda.device_count()
    if local > cards:
        raise RuntimeError(
            f"{local} ranks on this host share {cards} CUDA device(s): "
            "NCCL refuses two ranks on one device; pass backend='gloo' "
            "to init_parallel_env to run them over gloo")
    return "nccl"


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, backend: Optional[str] = None,
                      timeout_s: float = 600.0):
    """Join the job's process group (a no-op for a one-process job or
    when already joined); returns the backend, or None without a
    group."""
    global _initialized, _backend
    if _initialized:
        return _backend
    addr = coordinator_address or os.environ.get("PTI_COORDINATOR_ADDR") \
        or os.environ.get("PADDLE_MASTER")
    nproc = num_processes or _int_env("PTI_NUM_PROCESSES",
                                      _int_env("PADDLE_TRAINERS_NUM", None))
    pid = process_id if process_id is not None else _int_env(
        "PTI_PROCESS_ID", _int_env("PADDLE_TRAINER_ID", None))
    if addr and nproc and nproc > 1:
        if pid is None:
            raise ValueError("a multi-process job needs this process's "
                             "rank: PTI_PROCESS_ID or process_id=")
        chosen = choose_backend(backend, nproc)
        if chosen == "nccl":
            local = _int_env("PTI_LOCAL_RANK", pid)
            torch.cuda.set_device(local % torch.cuda.device_count())
        _dist().init_process_group(
            chosen, init_method=f"tcp://{addr}", world_size=int(nproc),
            rank=int(pid), timeout=datetime.timedelta(seconds=timeout_s))
        _backend = chosen
    _initialized = True
    return _backend


def in_process_group() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The process group's size (1 without one); no override."""
    return _dist().get_world_size() if in_process_group() else 1


def process_index() -> int:
    return _dist().get_rank() if in_process_group() else 0


def get_rank() -> int:
    """This process's rank in the job."""
    return process_index()


def get_world_size() -> int:
    env = os.environ.get("PTI_DP_WORLD_SIZE")
    if env is not None:
        return int(env)
    return process_count()


class ParallelEnv:
    """The reference's ``ParallelEnv`` (rank, world size, device)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        """The rank's card under NCCL (its local rank), else 0."""
        if _backend != "nccl":
            return 0
        return _int_env("PTI_LOCAL_RANK", 0) % torch.cuda.device_count()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _int_env("PTI_LOCAL_RANK", get_rank())


def is_initialized() -> bool:
    """Whether ``init_parallel_env`` has run."""
    return _initialized


def shutdown():
    """Leave the process group (idempotent)."""
    global _initialized, _backend
    if not _initialized:
        return
    if in_process_group():
        _dist().destroy_process_group()
    _initialized = False
    _backend = None
