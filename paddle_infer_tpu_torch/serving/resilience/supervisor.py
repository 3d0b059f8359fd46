"""EngineSupervisor — watchdog, crash-loop backoff, and retry/replay
recovery around an ``EngineCore``.

Port of ``paddle_infer_tpu/serving/resilience/supervisor.py``, over the
port's ragged ``EngineCore``.  The supervisor owns the stepping thread
(use ``sup.start()`` instead of ``core.start()``) and implements the
recovery protocol the core calls into at failure points
(``core.attach_recovery(sup)``):

  * **step watchdog** — a sidecar thread detects a hung ``run_once``
    (a step blocked past ``watchdog_s``) *while it is still blocked*,
    marks the engine DEGRADED and counts ``watchdog_trips_total``;
    ``stalled_for()`` reads the stall live.
  * **crash-loop detection** — consecutive engine failures back off
    exponentially (base·2^(streak−1), capped); past
    ``crash_threshold`` the engine goes DOWN and replay is disabled
    (fail fast beats a retry storm on a wedged accelerator).
  * **retry/replay** — ``request_should_replay`` grants a bounded
    per-request retry budget; the core then requeues the request at the
    queue head and replays it from its retained prompt + emitted
    tokens.  With the prefix cache enabled and KV intact, the retained
    pages make the replay compute only what they do not hold (on the
    port: the last delivered token, as a decode row).  Budget
    exhausted → poison-request quarantine (the request fails with
    ``QuarantinedError`` and is never requeued again).
  * **degradation ladder** — each ``MemoryError`` halves the core's
    effective max batch (floor 1); repeated pressure sheds queued
    requests whose deadline headroom is below ``shed_headroom_s``.
    Every ``recover_after`` clean steps the batch grows back
    one slot; at full width the engine returns to HEALTHY.

Lock discipline: the supervisor's lock only guards its own counters and
is NEVER held across a call into the core (the core's step lock may be
held by the caller of any hook — holding both in the other order would
deadlock).
"""
from __future__ import annotations

import threading
import time
from typing import Optional, TYPE_CHECKING

from .health import HealthMonitor, HealthState

if TYPE_CHECKING:   # pragma: no cover - typing only
    from ..engine_core import EngineCore


class EngineSupervisor:
    """Supervises one ``EngineCore`` (see module docstring)."""

    def __init__(self, core: "EngineCore", watchdog_s: float = 5.0,
                 max_retries: int = 2, crash_threshold: int = 5,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 recover_after: int = 20, shed_headroom_s: float = 1.0,
                 health: Optional[HealthMonitor] = None):
        self._core = core
        self._watchdog_s = float(watchdog_s)
        self.max_retries = int(max_retries)
        self._crash_threshold = int(crash_threshold)
        self._backoff_base = float(backoff_base_s)
        self._backoff_cap = float(backoff_cap_s)
        self._recover_after = max(1, int(recover_after))
        self._shed_headroom = float(shed_headroom_s)
        self.health = health or HealthMonitor()
        self._metrics = core.metrics

        self._lock = threading.Lock()
        self._step_started: Optional[float] = None
        self._stall_flagged = False
        self._crash_streak = 0
        self._mem_streak = 0
        self._good_steps = 0
        self._backoff_s = 0.0

        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch_thread: Optional[threading.Thread] = None
        core.attach_recovery(self)

    @property
    def core(self) -> "EngineCore":
        return self._core

    # -------------------------------------------------- stepping + watchdog
    def run_once(self, wait_s: float = 0.0) -> bool:
        """One supervised scheduler step: records the step start for the
        live watchdog, delegates to the core, and post-hoc trips on a
        step that overran the deadline but did return."""
        t0 = time.monotonic()
        with self._lock:
            self._step_started = t0
        try:
            return self._core.run_once(wait_s)
        finally:
            dur = time.monotonic() - t0
            with self._lock:
                self._step_started = None
                flagged, self._stall_flagged = self._stall_flagged, False
            # wait_s is legitimate idle blocking, not compute
            if dur > self._watchdog_s + wait_s and not flagged:
                self._trip_watchdog(dur)

    def stalled_for(self, now: Optional[float] = None) -> float:
        """Seconds the current step has been running (0.0 when no step
        is in flight) — the live hung-step signal."""
        with self._lock:
            started = self._step_started
        if started is None:
            return 0.0
        return (time.monotonic() if now is None else now) - started

    def _trip_watchdog(self, stalled_s: float):
        self._metrics.on_watchdog_trip()
        self.health.to_degraded(f"watchdog: step stalled {stalled_s:.2f}s "
                                f"(limit {self._watchdog_s:.2f}s)")

    def _watch_loop(self):
        period = max(0.01, self._watchdog_s / 4.0)
        while not self._stop_evt.wait(period):
            stalled = self.stalled_for()
            if stalled <= self._watchdog_s:
                continue
            with self._lock:
                already, self._stall_flagged = self._stall_flagged, True
            if not already:
                self._trip_watchdog(stalled)

    # ------------------------------------------------- recovery protocol
    # (called by EngineCore, possibly while it holds its step lock —
    #  these hooks therefore never block on the core)
    def on_engine_failure(self, err: BaseException):
        """A scheduler step (prefill/decode/copy) failed.  Advance the
        crash streak, arm exponential backoff, and degrade/DOWN."""
        with self._lock:
            self._crash_streak += 1
            streak = self._crash_streak
            self._good_steps = 0
            self._backoff_s = min(
                self._backoff_cap,
                self._backoff_base * (2.0 ** (streak - 1)))
        if streak >= self._crash_threshold:
            self.health.to_down(
                f"crash loop: {streak} consecutive engine failures "
                f"(last: {type(err).__name__})")
        else:
            self.health.to_degraded(
                f"engine failure #{streak}: {type(err).__name__}")

    def on_engine_restart(self):
        """KV state was lost and the page pools rebuilt — the core is
        replaying survivors; note it on the health surface."""
        self.health.to_degraded("engine restart: KV state rebuilt")

    def request_should_replay(self, req, err: BaseException) -> bool:
        """Grant (and consume) one retry from ``req``'s budget.  False →
        the core quarantines the request instead of requeueing it."""
        if req.kind != "batch" or req.prompt is None:
            return False
        if self.health.state is HealthState.DOWN:
            return False
        if req.expired():
            return False
        if req.retries >= self.max_retries:
            return False
        req.retries += 1
        return True

    def on_memory_pressure(self):
        """A (possibly injected) MemoryError reached admission: park
        before shedding, then shrink the effective batch; repeated
        pressure sheds queued load with too little deadline headroom to
        survive the degraded engine.

        Park-before-shed: when the core runs a host KV tier, preempting
        one active row into it releases device pages AND the row's
        adapter pin — reversible, nothing lost — so the ladder only
        advances (batch shrink, shedding) once the tier can absorb no
        more.  The park call happens outside ``self._lock``: the
        supervisor lock is never held across core calls."""
        # the port's core returns False until the host KV tier is
        # ported (ROADMAP.md queue 1, item 5): the ladder always advances
        if self._core.park_for_pressure():
            self.health.to_degraded("memory pressure: parked one row "
                                    "into the host KV tier")
            return
        with self._lock:
            self._mem_streak += 1
            streak = self._mem_streak
            self._good_steps = 0
        self.health.to_degraded(f"memory pressure #{streak}")
        cur = self._core.effective_max_batch
        self._core.set_effective_max_batch(max(1, cur // 2))
        if streak >= 2:
            self._core.shed_queued(self._shed_headroom)

    def on_step_ok(self):
        """A mixed step completed cleanly: reset failure streaks and
        climb the recovery ladder."""
        with self._lock:
            self._crash_streak = 0
            self._mem_streak = 0
            self._backoff_s = 0.0
            self._good_steps += 1
            climb = self._good_steps >= self._recover_after
            if climb:
                self._good_steps = 0
        if not climb:
            return
        cur = self._core.effective_max_batch
        full = self._core.max_batch
        if cur < full:
            self._core.set_effective_max_batch(min(full, cur + 1))
        elif self.health.state is HealthState.DEGRADED:
            self.health.to_healthy(
                f"recovered: {self._recover_after} clean steps at "
                f"full batch")

    def consume_backoff(self) -> float:
        """Return and clear the armed crash backoff (the loop sleeps it
        exactly once per failure)."""
        with self._lock:
            b, self._backoff_s = self._backoff_s, 0.0
            return b

    # ----------------------------------------------------- admin control
    def drain(self) -> bool:
        """Stop admitting (``submit`` raises ``LoadShedError``); in-flight
        requests finish."""
        changed = self.health.to_draining("admin drain")
        self._core.set_draining(True)
        return changed

    def resume(self) -> bool:
        changed = self.health.resume()
        self._core.set_draining(False)
        return changed

    def health_info(self) -> dict:
        st = self.health.state
        with self._lock:
            crash = self._crash_streak
            mem = self._mem_streak
        return {"health_state": st.value, "health_code": st.code,
                "crash_streak": crash, "memory_pressure_streak": mem,
                "stalled_for_s": round(self.stalled_for(), 4),
                "watchdog_s": self._watchdog_s,
                "max_retries": self.max_retries}

    # ---------------------------------------------------- thread control
    def start(self) -> "EngineSupervisor":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serving-supervisor", daemon=True)
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="serving-watchdog",
                daemon=True)
            self._thread.start()
            self._watch_thread.start()
        return self

    def _loop(self):
        while not self._stop_evt.is_set():
            try:
                self.run_once(wait_s=0.02)
            except Exception:
                # the core's own loop hooks already counted/logged it;
                # the supervisor's job is to keep stepping
                pass
            b = self.consume_backoff()
            if b > 0.0:
                self._stop_evt.wait(b)

    def stop(self, timeout: float = 10.0) -> bool:
        self._stop_evt.set()
        joined = True
        for attr in ("_thread", "_watch_thread"):
            t = getattr(self, attr)
            setattr(self, attr, None)
            if t is not None:
                t.join(timeout)
                joined = joined and not t.is_alive()
        return joined

    def close(self, timeout: float = 10.0):
        self.stop(timeout)
        self._core.close()
