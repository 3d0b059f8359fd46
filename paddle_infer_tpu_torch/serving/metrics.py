"""Serving counters and latency reservoirs.

Port of the ``ServingMetrics`` counters the ragged path records in
``paddle_infer_tpu/serving/metrics.py``: submitted / rejected, queue
wait, time to first token, inter-token latency, step wall, finished,
the speculative draft counters (``on_spec``, the ``speculation``
section of ``snapshot``), the resilience counters (engine restarts,
retries, watchdog trips, quarantines, sheds: the ``resilience``
section), and the ``prefix_cache`` and ``kv_quant`` sections the core
hands to ``snapshot``.  Prometheus exposition and the per-tenant
families wait for ``observability/`` (ROADMAP.md queue 1, item 2).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

_RESERVOIR = 2048        # samples kept per latency series


def _percentile(samples, q: float) -> Optional[float]:
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return float(s[idx])


class _Series:
    """Bounded reservoir: ``count``/``mean`` are lifetime aggregates,
    percentiles cover only the most recent samples (``*_recent``)."""

    def __init__(self, maxlen: int = _RESERVOIR):
        self._d: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def add(self, v: float):
        self._d.append(float(v))
        self.count += 1
        self.total += float(v)

    def summary(self) -> Dict[str, Optional[float]]:
        d = list(self._d)
        return {"count": self.count,
                "mean": (self.total / self.count) if self.count else None,
                "window": len(d),
                "p50_recent": _percentile(d, 0.50),
                "p99_recent": _percentile(d, 0.99),
                "max_recent": max(d) if d else None}


class ServingMetrics:
    """Thread-safe counters shared by EngineCore and its callers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected_queue_full = 0
        self.rejected = 0
        self.cancelled_deadline = 0
        self.loop_exceptions = 0
        self.tokens_generated = 0
        self.prefills = 0
        self.decode_steps = 0
        # in-engine speculative decoding (EngineCore speculate=True)
        self.spec_rows = 0              # row-steps that carried drafts
        self.spec_drafts_proposed = 0
        self.spec_drafts_accepted = 0
        # fault tolerance (serving/resilience/)
        self.engine_restarts = 0
        self.request_retries = 0
        self.watchdog_trips = 0
        self.requests_quarantined = 0
        self.requests_shed = 0
        self.ttft = _Series()
        self.itl = _Series()            # inter-token latency (s)
        self.e2e = _Series()
        self.queue_wait = _Series()
        self.step_ms = _Series()        # one mixed step (ms)
        self.occupancy = _Series()      # active rows / max_batch

    def on_submitted(self, n: int = 1):
        with self._lock:
            self.submitted += n

    def on_rejected_queue_full(self, n: int = 1):
        with self._lock:
            self.rejected_queue_full += n

    def on_rejected(self, n: int = 1):
        with self._lock:
            self.rejected += n

    def on_deadline(self, n: int = 1):
        with self._lock:
            self.cancelled_deadline += n

    def on_failed(self, n: int = 1):
        with self._lock:
            self.failed += n

    def on_loop_exception(self):
        with self._lock:
            self.loop_exceptions += 1

    def on_queue_wait(self, wait_s: float):
        with self._lock:
            self.queue_wait.add(wait_s)

    def on_prefill(self, ttft_s: float):
        with self._lock:
            self.prefills += 1
            self.ttft.add(ttft_s)

    def on_tokens(self, n: int, itl_s: Optional[float] = None):
        with self._lock:
            self.tokens_generated += n
            if itl_s is not None and n > 0:
                self.itl.add(itl_s)

    def on_step(self, wall_ms: float, active: int, max_batch: int):
        with self._lock:
            self.decode_steps += 1
            self.step_ms.add(wall_ms)
            if max_batch > 0:
                self.occupancy.add(active / max_batch)

    def on_spec(self, rows: int, proposed: int, accepted: int):
        """One mixed step verified ``proposed`` draft tokens across
        ``rows`` speculating rows and accepted ``accepted`` of them."""
        with self._lock:
            self.spec_rows += rows
            self.spec_drafts_proposed += proposed
            self.spec_drafts_accepted += accepted

    def on_completed(self, e2e_s: float):
        with self._lock:
            self.completed += 1
            self.e2e.add(e2e_s)

    # --------------------------------------------- resilience hooks
    def on_engine_restart(self, n: int = 1):
        with self._lock:
            self.engine_restarts += n

    def on_retry(self, n: int = 1):
        with self._lock:
            self.request_retries += n

    def on_watchdog_trip(self, n: int = 1):
        with self._lock:
            self.watchdog_trips += n

    def on_quarantined(self, n: int = 1):
        with self._lock:
            self.requests_quarantined += n

    def on_shed(self, n: int = 1):
        with self._lock:
            self.requests_shed += n

    def snapshot(self, prefix_cache: Optional[Dict] = None,
                 kv_quant: Optional[Dict] = None,
                 resilience: Optional[Dict] = None, **extra) -> dict:
        """Every counter and series as a plain dict, with ``extra``
        (the core's gauges: queue depth, active rows, ``kv_pool``)
        merged in.  ``prefix_cache`` is ``PrefixCache.stats_snapshot()``
        and ``kv_quant`` the core's int8 pool byte accounting; each
        section is present only when its feature is on.  The
        ``resilience`` section is always there: the core's gauges
        (``effective_max_batch``, ``draining``, ``faults_injected`` and
        the supervisor's ``health_info()``) with this registry's
        counters."""
        with self._lock:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "rejected_queue_full": self.rejected_queue_full,
                "cancelled_deadline": self.cancelled_deadline,
                "loop_exceptions": self.loop_exceptions,
                "tokens_generated": self.tokens_generated,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "spec_rows": self.spec_rows,
                "spec_drafts_proposed": self.spec_drafts_proposed,
                "spec_drafts_accepted": self.spec_drafts_accepted,
                "speculation": {
                    "rows": self.spec_rows,
                    "drafts_proposed": self.spec_drafts_proposed,
                    "drafts_accepted": self.spec_drafts_accepted,
                    "acceptance_rate": (
                        self.spec_drafts_accepted
                        / self.spec_drafts_proposed
                        if self.spec_drafts_proposed else 0.0),
                    "wasted_ratio": (
                        (self.spec_drafts_proposed
                         - self.spec_drafts_accepted)
                        / self.spec_drafts_proposed
                        if self.spec_drafts_proposed else 0.0),
                },
                "ttft_s": self.ttft.summary(),
                "itl_s": self.itl.summary(),
                "e2e_s": self.e2e.summary(),
                "queue_wait_s": self.queue_wait.summary(),
                "step_ms": self.step_ms.summary(),
                "occupancy": self.occupancy.summary(),
            }
            res = dict(resilience) if resilience is not None else {
                "health_state": "healthy", "health_code": 0,
                "effective_max_batch": extra.get("max_batch"),
                "faults_injected": {}}
            res.update({
                "engine_restarts": self.engine_restarts,
                "request_retries": self.request_retries,
                "watchdog_trips": self.watchdog_trips,
                "requests_quarantined": self.requests_quarantined,
                "requests_shed": self.requests_shed,
                "loop_exceptions": self.loop_exceptions,
            })
            out["resilience"] = res
        out.update(extra)
        if prefix_cache is not None:
            out["prefix_cache"] = dict(prefix_cache)
        if kv_quant is not None:
            out["kv_quant"] = dict(kv_quant)
        return out
