"""Engine health state machine.

Port of ``paddle_infer_tpu/serving/resilience/health.py``.  Four states
drive both the degradation ladder and a server's health surface:

  HEALTHY   full service; effective max batch at its configured ceiling.
  DEGRADED  serving, but the supervisor has shrunk the effective batch
            (memory pressure) or observed watchdog trips / step faults;
            recovers to HEALTHY after a run of clean steps.
  DRAINING  administratively draining: in-flight requests finish, new
            submissions are rejected with ``LoadShedError``.
  DOWN      crash-looping past the supervisor threshold; requests fail
            fast, replay is disabled, the engine is not ready.

Transitions are guarded — DRAINING is sticky (only an explicit resume
leaves it) and recovery to HEALTHY is only legal from DEGRADED — so a
metrics race can't accidentally un-drain a node an operator is taking
out of rotation.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import List, Optional, Tuple


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DRAINING = "draining"
    DOWN = "down"

    @property
    def code(self) -> int:
        """Stable numeric code for the ``engine_health_state`` gauge."""
        return _CODES[self]


_CODES = {HealthState.HEALTHY: 0, HealthState.DEGRADED: 1,
          HealthState.DRAINING: 2, HealthState.DOWN: 3}

# states in which the engine accepts new work
_SERVING = (HealthState.HEALTHY, HealthState.DEGRADED)


class HealthMonitor:
    """Thread-safe holder for the engine health state plus a bounded
    ring of (timestamp, from, to, reason) transition records."""

    LOG_CAP = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._state = HealthState.HEALTHY
        self._log: List[Tuple[float, str, str, str]] = []

    @property
    def state(self) -> HealthState:
        with self._lock:
            return self._state

    def is_serving(self) -> bool:
        with self._lock:
            return self._state in _SERVING

    def _transition(self, to: HealthState, reason: str,
                    only_from: Optional[Tuple[HealthState, ...]] = None
                    ) -> bool:
        with self._lock:
            cur = self._state
            if cur is to:
                return False
            if only_from is not None and cur not in only_from:
                return False
            self._state = to
            self._log.append((time.monotonic(), cur.value, to.value,
                              reason))
            del self._log[:-self.LOG_CAP]
            return True

    def to_degraded(self, reason: str) -> bool:
        # DRAINING/DOWN outrank DEGRADED — never soften them
        return self._transition(HealthState.DEGRADED, reason,
                                only_from=(HealthState.HEALTHY,))

    def to_healthy(self, reason: str) -> bool:
        # recovery only climbs one rung; DRAINING/DOWN need an explicit
        # resume / restart decision
        return self._transition(HealthState.HEALTHY, reason,
                                only_from=(HealthState.DEGRADED,))

    def to_draining(self, reason: str) -> bool:
        return self._transition(HealthState.DRAINING, reason,
                                only_from=_SERVING)

    def to_down(self, reason: str) -> bool:
        return self._transition(HealthState.DOWN, reason)

    def resume(self, reason: str = "resume") -> bool:
        """Operator action: leave DRAINING/DOWN back to DEGRADED (the
        clean-step ladder then earns HEALTHY)."""
        return self._transition(
            HealthState.DEGRADED, reason,
            only_from=(HealthState.DRAINING, HealthState.DOWN))

    def transitions(self) -> List[dict]:
        with self._lock:
            return [{"t": t, "from": a, "to": b, "reason": r}
                    for (t, a, b, r) in self._log]

    def snapshot(self) -> dict:
        """One consistent read of (state, code, serving, transition
        count) — the per-replica health row the fleet router publishes
        without taking this lock four times."""
        with self._lock:
            return {"state": self._state.value,
                    "code": _CODES[self._state],
                    "serving": self._state in _SERVING,
                    "transitions": len(self._log)}
