"""Named RNG states for tensor-parallel regions.

Port of ``paddle_infer_tpu/parallel/random.py``: ``RNGStatesTracker``,
``get_rng_state_tracker`` and ``model_parallel_random_seed``.  A state
is a named threefry key; ``add`` folds the model-parallel coordinate of
the current hybrid group into a "local" state, so draws differ per mp
rank, while the global stream (the ``KeyStream`` a model's dropouts
draw from) folds in nothing and is the same everywhere.  One controller
drives every shard, so the group's own coordinate is 0, the
reference's single-process value; ``local_key(name, mp_rank)`` gives
any other rank's state.  ``rng_state(name, keys)`` splits the state and
opens ``keys.trace_key_scope`` on the drawn half, as the reference opens
its global scope.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..core import random as R
from . import topology

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, torch.Tensor] = {}
        self._seeds: Dict[str, int] = {}

    def reset(self):
        self.states_.clear()
        self._seeds.clear()

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        hcg = topology.get_hybrid_communicate_group()
        rank = hcg.get_model_parallel_rank() if hcg is not None else None
        self._seeds[name] = int(seed)
        self.states_[name] = self.local_key(name, rank)

    def local_key(self, name: str, mp_rank: Optional[int]) -> torch.Tensor:
        """The state ``add`` makes for ``name`` on mp rank ``mp_rank``
        (None: no hybrid group, nothing folded in)."""
        key = R.PRNGKey(self._seeds[name])
        return key if mp_rank is None else R.fold_in(key, int(mp_rank))

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG, keys=None):
        """Split the state ``name`` and draw ``keys``' keys from the
        drawn half while open."""
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        if keys is None:
            raise ValueError("rng_state needs the KeyStream the region's "
                             "dropouts draw from (keys=)")
        new_key, use_key = R.split(self.states_[name])
        self.states_[name] = new_key
        with keys.trace_key_scope(use_key):
            yield


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: int = 2023, keys=None):
    """Seed the global stream (``keys``, when given) with ``seed`` and
    the local model-parallel state with ``seed + 1024``."""
    _TRACKER.reset()
    if keys is not None:
        keys.seed(seed)
    _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024)
