"""The step cost model and the parallelism tuner.

Port of ``paddle_infer_tpu/distributed/cost_model.py``.  The reference
reads XLA's ``cost_analysis()`` / ``memory_analysis()`` of the compiled
step; the port's ``FleetTrainStep`` gives the same keys from one
forward and backward: flops from ``torch.utils.flop_counter``
(``FlopCounterMode``), argument bytes from the parameters and optimizer
slots, temporary bytes from the card's peak allocation (0 on the CPU,
not measured there).  The tuner builds the model under each candidate
factorization of the caller's ``devices``, times ``measure_steps``
steps, and returns the fastest.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class CostEstimate:
    """The cost of one train step."""

    flops: float = 0.0                  # FlopCounterMode, forward + backward
    bytes_accessed: float = 0.0         # parameters, slots and batch read
    temp_bytes: int = 0                 # peak allocation above the state
    argument_bytes: int = 0             # parameters and optimizer slots
    wall_ms: Optional[float] = None     # measured, when the tuner ran it

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)


def _sync(step):
    if step.device.type == "cuda":
        torch.cuda.synchronize(step.device)


def estimate_step_cost(step, *batch, measure: int = 0) -> CostEstimate:
    """The cost of ``step`` on ``batch`` (after one step, as the
    reference compiles first); ``measure`` > 0 also times that many
    steps."""
    est = CostEstimate()
    step(*batch).item()
    ca = step.cost_analysis(*batch)
    est.flops = float(ca.get("flops", 0.0))
    est.bytes_accessed = float(ca.get("bytes accessed", 0.0))
    ma = step.memory_analysis(*batch)
    est.temp_bytes = int(ma.temp_size_in_bytes)
    est.argument_bytes = int(ma.argument_size_in_bytes)
    if measure > 0:
        _sync(step)
        t0 = time.perf_counter()
        for _ in range(measure):
            loss = step(*batch)
        loss.item()
        est.wall_ms = (time.perf_counter() - t0) / measure * 1e3
    return est


def candidate_factorizations(n_devices: int,
                             axes: Sequence[str] = ("dp", "mp"),
                             ) -> List[Dict[str, int]]:
    """Every way to factor ``n_devices`` over ``axes``."""
    def divisors(n):
        return [d for d in range(1, n + 1) if n % d == 0]

    out = []
    for combo in itertools.product(*[divisors(n_devices) for _ in axes]):
        if int(np.prod(combo)) == n_devices:
            out.append(dict(zip(axes, combo)))
    return out


@dataclass
class TrialResult:
    degrees: Dict[str, int]
    cost: Optional[CostEstimate]
    error: Optional[str] = None


@dataclass
class TuneReport:
    best: Dict[str, int]
    trials: List[TrialResult] = field(default_factory=list)


def _snapshot_fleet():
    from ..parallel import fleet, topology

    return (topology.get_current_mesh(),
            topology.get_hybrid_communicate_group(), fleet._state.hcg,
            fleet._state.strategy, fleet._state.device)


def _restore_fleet(snap):
    from ..parallel import fleet, topology

    mesh, hcg, fhcg, strategy, device = snap
    topology.set_current_mesh(mesh)
    topology.set_hybrid_communicate_group(hcg)
    fleet._state.hcg = fhcg
    fleet._state.strategy = strategy
    fleet._state.device = device


def _reset_fleet():
    _restore_fleet((None, None, None, None, None))


def tune_parallelism(model_fn, loss_fn, optimizer_fn, sample_batch,
                     n_devices: Optional[int] = None,
                     axes: Sequence[str] = ("dp", "mp"),
                     measure_steps: int = 3,
                     candidates: Optional[List[Dict[str, int]]] = None,
                     verbose: bool = False, devices=None) -> TuneReport:
    """Build the model under each candidate factorization of ``devices``
    (default: the card, ``n_devices`` times), time ``measure_steps``
    steps of each and return the fastest (least bytes when nothing was
    timed).  ``model_fn()`` builds a fresh model, ``optimizer_fn(params)``
    its optimizer; a candidate that fails (a batch its dp does not
    divide) is recorded with its error.  The caller's fleet state is
    restored."""
    from .. import resolve_device
    from ..parallel import DistributedStrategy, FleetTrainStep, fleet

    if devices is None:
        devices = [resolve_device(None)] * (n_devices or 1)
    devices = list(devices)[:n_devices] if n_devices else list(devices)
    cands = candidates if candidates is not None else \
        candidate_factorizations(len(devices), axes)
    trials: List[TrialResult] = []
    caller_state = _snapshot_fleet()
    try:
        for degrees in cands:
            _reset_fleet()
            try:
                st = DistributedStrategy()
                st.hybrid_configs = dict(st.hybrid_configs, **{
                    f"{a}_degree": d for a, d in degrees.items()})
                fleet.init(is_collective=True, strategy=st, devices=devices)
                model = model_fn()
                opt = optimizer_fn(model.parameters())
                step = FleetTrainStep(model, loss_fn, opt, strategy=st)
                cost = estimate_step_cost(step, *sample_batch,
                                          measure=measure_steps)
                trials.append(TrialResult(degrees, cost))
                if verbose:
                    wall = (f"{cost.wall_ms:.1f} ms"
                            if cost.wall_ms is not None else "unmeasured")
                    print(f"tune {degrees}: {wall}, "
                          f"temp {cost.temp_bytes / 1e6:.1f} MB", flush=True)
            except Exception as e:      # a non-dividing batch, OOM, ...
                trials.append(TrialResult(degrees, None,
                                          error=repr(e)[:200]))
                if verbose:
                    print(f"tune {degrees}: failed {e!r}", flush=True)
    finally:
        _restore_fleet(caller_state)
    ok = [t for t in trials if t.cost is not None]
    if not ok:
        raise RuntimeError(
            "no parallelism candidate succeeded: "
            + "; ".join(f"{t.degrees}: {t.error}" for t in trials))
    if all(t.cost.wall_ms is not None for t in ok):
        best = min(ok, key=lambda t: t.cost.wall_ms)
    else:
        best = min(ok, key=lambda t: (t.cost.bytes_accessed
                                      or float("inf")))
    return TuneReport(best=best.degrees, trials=trials)
