"""Serving metrics registry.

Port of ``paddle_infer_tpu/serving/metrics.py``'s ``ServingMetrics``:
lock-protected counters plus bounded reservoirs for the latency
distributions the serving loop cares about (time to first token,
inter-token latency, end-to-end latency, step wall, batch occupancy),
each latency series also fed into a log-bucketed ``Histogram`` so the
Prometheus exposition renders native ``_bucket``/``_sum``/``_count``
families; the speculative draft counters, the resilience counters, and
the per-tenant SLO section fed by ``on_journey``.  ``snapshot()``
renders everything to a plain dict in the reference's layout (and key
order, through ``sorted_tree``), and ``to_prometheus`` renders that.

Not ported: ``on_moe`` and ``on_predictive_shed`` (the MoE plane and
the SLO scheduler, ROADMAP.md queue 1).

Percentiles come from a fixed-size tail reservoir (last N samples, not
a sketch).  Token throughput is measured over a sliding window of
recent (timestamp, count) emission events.
"""
from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, Optional

from ..observability.histogram import DEFAULT_BOUNDS, Histogram
from ..observability.journey import BUCKETS as _JOURNEY_BUCKETS
from ..observability.stable import sorted_tree

_RESERVOIR = 2048        # samples kept per latency series
_RATE_WINDOW_S = 30.0    # sliding window for tokens/s

# the lifetime counters, as the ``counters`` section names them; the
# snapshot also keeps each at its top level, the port's first layout
_COUNTERS = ("submitted", "completed", "failed", "rejected_queue_full",
             "rejected", "cancelled_deadline", "tokens_generated",
             "prefills", "decode_steps", "spec_rows",
             "spec_drafts_proposed", "spec_drafts_accepted")


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
    """Thread-safe registry shared by EngineCore and its callers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            for name in _COUNTERS:
                setattr(self, name, 0)
            self.loop_exceptions = 0
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
            self._emits: deque = deque()    # (t, ntokens) rate window
            # native-histogram twins of the latency series (seconds)
            self.ttft_hist = Histogram()
            self.itl_hist = Histogram()
            self.e2e_hist = Histogram()
            self.step_wall_hist = Histogram()
            self.queue_wait_hist = Histogram()
            # tenant -> counters, an e2e histogram, attribution bucket
            # sums and exemplar journey ids by histogram bucket
            self._tenants: Dict[str, dict] = {}

    # ------------------------------------------------ recording hooks
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

    def on_loop_exception(self, n: int = 1):
        with self._lock:
            self.loop_exceptions += n

    def on_queue_wait(self, wait_s: float):
        """One request left the admission queue after ``wait_s``."""
        with self._lock:
            self.queue_wait.add(wait_s)
            self.queue_wait_hist.observe(max(0.0, wait_s))

    def on_prefill(self, ttft_s: Optional[float] = None):
        with self._lock:
            self.prefills += 1
            if ttft_s is not None:
                self.ttft.add(ttft_s)
                self.ttft_hist.observe(ttft_s)

    def on_tokens(self, n: int, itl_s: Optional[float] = None):
        now = time.monotonic()
        with self._lock:
            self.tokens_generated += n
            self._emits.append((now, n))
            while self._emits and now - self._emits[0][0] > _RATE_WINDOW_S:
                self._emits.popleft()
            if itl_s is not None and n > 0:
                self.itl.add(itl_s)
                self.itl_hist.observe(itl_s)

    def on_step(self, wall_ms: float, active: int, max_batch: int):
        with self._lock:
            self.decode_steps += 1
            self.step_ms.add(wall_ms)
            self.step_wall_hist.observe(wall_ms / 1e3)
            if max_batch > 0:
                self.occupancy.add(active / max_batch)

    def on_spec(self, rows: int, proposed: int, accepted: int):
        """One mixed step verified ``proposed`` draft tokens across
        ``rows`` speculating rows and accepted ``accepted`` of them."""
        with self._lock:
            self.spec_rows += rows
            self.spec_drafts_proposed += proposed
            self.spec_drafts_accepted += accepted

    def on_completed(self, e2e_s: Optional[float] = None):
        with self._lock:
            self.completed += 1
            if e2e_s is not None:
                self.e2e.add(e2e_s)
                self.e2e_hist.observe(e2e_s)

    def on_journey(self, tenant: Optional[str], e2e_s: float,
                   tokens: int, attained: bool, buckets: Dict[str, float],
                   coverage: float, journey_id: str):
        """One request's journey finished: fold its attribution summary
        into the per-tenant SLO section.  ``tenant`` is the accounting
        label from ``submit(tenant=)`` (untenanted traffic lands under
        ``"default"``); ``journey_id`` becomes the exemplar on the
        tenant e2e histogram bucket this observation lands in."""
        key = "default" if tenant is None else str(tenant)
        with self._lock:
            t = self._tenants.get(key)
            if t is None:
                t = self._tenants[key] = {
                    "requests": 0, "attained": 0, "tokens": 0,
                    "parked_seconds": 0.0,
                    "e2e_hist": Histogram(),
                    "buckets": {b: 0.0 for b in _JOURNEY_BUCKETS},
                    "exemplars": {},
                }
            t["requests"] += 1
            if attained:
                t["attained"] += 1
            t["tokens"] += int(tokens)
            t["parked_seconds"] += float(buckets.get("parked", 0.0))
            t["e2e_hist"].observe(e2e_s)
            for b, v in buckets.items():
                if b in t["buckets"]:
                    t["buckets"][b] += float(v)
            # latest exemplar per landing bucket; +Inf for overflow
            i = bisect_left(DEFAULT_BOUNDS, float(e2e_s))
            le = ("+Inf" if i >= len(DEFAULT_BOUNDS)
                  else str(DEFAULT_BOUNDS[i]))
            t["exemplars"][le] = {"journey_id": journey_id,
                                  "value": float(e2e_s)}

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

    # ------------------------------------------------------ rendering
    def tokens_per_second(self) -> float:
        now = time.monotonic()
        with self._lock:
            while self._emits and now - self._emits[0][0] > _RATE_WINDOW_S:
                self._emits.popleft()
            if not self._emits:
                return 0.0
            span = max(now - self._emits[0][0], 1e-6)
            return sum(n for _, n in self._emits) / span

    def snapshot(self, queue_depth: int = 0, active: int = 0,
                 max_batch: int = 0,
                 kv_pool: Optional[Dict] = None,
                 prefix_cache: Optional[Dict] = None,
                 kv_quant: Optional[Dict] = None,
                 resilience: Optional[Dict] = None,
                 steplog: Optional[Dict] = None,
                 device_memory: Optional[Dict] = None,
                 journeys: Optional[Dict] = None) -> Dict:
        """Every counter and series as a plain dict, in the reference's
        layout: ``counters``, the reservoir summaries (lifetime
        ``count``/``mean``, ``*_recent`` percentiles) and their native
        cumulative-bucket twins under ``histograms``.  The sections the
        core hands in are present only when given: ``kv_pool`` (block
        pool occupancy), ``prefix_cache`` (``PrefixCache
        .stats_snapshot()``), ``kv_quant`` (int8 pool byte accounting),
        ``steplog`` (``StepLog.summary()``), ``device_memory``
        (``profiler.statistic.memory_stats()``, on the card),
        ``journeys`` (``JourneyStore.summary()``); ``tenants`` rides
        along once any journey finished.  ``resilience`` is always
        there: the core's gauges (``effective_max_batch``, ``draining``,
        ``faults_injected``, the supervisor's ``health_info()``) with
        this registry's counters.  Each counter, and the ``itl_s``,
        ``e2e_s``, ``queue_wait_s`` and ``step_ms`` series, also stay at
        the top level, where the port's callers read them."""
        tps = self.tokens_per_second()
        with self._lock:
            counters = {k: getattr(self, k) for k in _COUNTERS}
            out = {
                "queue_depth": queue_depth,
                "active": active,
                "max_batch": max_batch,
                "batch_occupancy": (active / max_batch) if max_batch
                else 0.0,
                "counters": counters,
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
                "tokens_per_second": tps,
                "ttft_s": self.ttft.summary(),
                "inter_token_latency_s": self.itl.summary(),
                "e2e_latency_s": self.e2e.summary(),
                "decode_step_ms": self.step_ms.summary(),
                "occupancy": self.occupancy.summary(),
                "histograms": {
                    "ttft": self.ttft_hist.snapshot(),
                    "itl": self.itl_hist.snapshot(),
                    "e2e": self.e2e_hist.snapshot(),
                    "step_wall": self.step_wall_hist.snapshot(),
                    "queue_wait": self.queue_wait_hist.snapshot(),
                },
                # the port's first layout: flat counters, its series names
                **counters,
                "loop_exceptions": self.loop_exceptions,
                "itl_s": self.itl.summary(),
                "e2e_s": self.e2e.summary(),
                "queue_wait_s": self.queue_wait.summary(),
                "step_ms": self.step_ms.summary(),
            }
            if journeys is not None:
                out["journeys"] = dict(journeys)
            if self._tenants:
                out["tenants"] = {
                    name: {
                        "requests": t["requests"],
                        "attained": t["attained"],
                        "attainment": (t["attained"] / t["requests"]
                                       if t["requests"] else 0.0),
                        "tokens": t["tokens"],
                        "parked_seconds": t["parked_seconds"],
                        "e2e": t["e2e_hist"].snapshot(),
                        "buckets": dict(t["buckets"]),
                        "exemplars": {le: dict(ex) for le, ex
                                      in t["exemplars"].items()},
                    }
                    for name, t in sorted(self._tenants.items())}
            if steplog is not None:
                out["steplog"] = dict(steplog)
            if device_memory:
                out["device_memory"] = dict(device_memory)
            if kv_pool is not None:
                out["kv_pool"] = dict(kv_pool)
            if prefix_cache is not None:
                out["prefix_cache"] = dict(prefix_cache)
            if kv_quant is not None:
                out["kv_quant"] = dict(kv_quant)
            res = dict(resilience) if resilience is not None else {
                "health_state": "healthy", "health_code": 0,
                "effective_max_batch": max_batch,
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
            # canonical key order at every level: the JSON body is
            # byte-stable across replicas and restarts
            return sorted_tree(out)

    def to_prometheus(self, snapshot: Optional[Dict] = None,
                      compile_summary: Optional[Dict] = None) -> str:
        """Prometheus text exposition of a snapshot (taken fresh when
        not given), with the compile log's summary when given."""
        from ..observability.prometheus import render_prometheus

        return render_prometheus(snapshot or self.snapshot(),
                                 compile_summary)
