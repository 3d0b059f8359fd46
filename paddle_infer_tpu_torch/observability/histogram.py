"""Log-bucketed, lock-safe latency histograms with native Prometheus
exposition.

Port of ``paddle_infer_tpu/observability/histogram.py`` (unchanged).

The reservoir series in ``serving.metrics`` answer "what was the recent
p99" but cannot be aggregated across replicas or re-quantiled by a
dashboard — percentile gauges don't sum.  Native Prometheus histogram
families do: cumulative ``_bucket`` counters (plus ``_sum``/``_count``)
are monotone, mergeable, and ``histogram_quantile()``-able server-side.
This module provides the histogram itself; the renderer
(``observability/prometheus.py``) turns ``snapshot()`` dicts into
``_bucket``/``_sum``/``_count`` sample lines and ``validate_exposition``
enforces cumulativity and the ``+Inf`` terminal bucket.

Bucket bounds default to a 1-2-5 log series over 100 µs .. 100 s —
wide enough for TTFT on a cold compile and tight enough (≤ 2.5×
resolution) for ITL on a warm decode step.  Snapshots keep the terminal
bucket's ``le`` as the string ``"+Inf"`` so they stay strict-JSON
serializable (``float("inf")`` isn't).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence

from .stable import sorted_tree


def log_bounds(lo: float = 1e-4, hi: float = 100.0) -> tuple:
    """1-2-5 log-series bucket bounds covering [lo, hi] inclusive."""
    out: List[float] = []
    exp = int(math.floor(math.log10(lo)))
    while True:
        for m in (1.0, 2.0, 5.0):
            v = m * (10.0 ** exp)
            if v < lo * (1 - 1e-9):
                continue
            if v > hi * (1 + 1e-9):
                return tuple(out)
            out.append(v)
        exp += 1


DEFAULT_BOUNDS = log_bounds()


class Histogram:
    """Thread-safe fixed-bound histogram.

    ``observe()`` is O(log buckets) under a short lock; ``snapshot()``
    renders the *cumulative* bucket list the Prometheus text format
    wants: ``[[le, count_le], ..., ["+Inf", total]]`` with ``le``
    ascending and counts non-decreasing.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        bs = tuple(float(b) for b in
                   (DEFAULT_BOUNDS if bounds is None else bounds))
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError("bucket bounds must be finite and non-empty")
        if any(a >= b for a, b in zip(bs, bs[1:])):
            raise ValueError("bucket bounds must be strictly increasing")
        self._bounds = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)     # last = overflow (+Inf)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        v = float(value)
        # bucket semantics are `value <= le` (Prometheus cumulative
        # `le`): bisect_left finds the first bound >= v
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def __len__(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Dict:
        with self._lock:
            counts = list(self._counts)
            total = self._count
            acc = self._sum
        buckets: List[list] = []
        cum = 0
        for le, c in zip(self._bounds, counts):
            cum += c
            buckets.append([le, cum])
        buckets.append(["+Inf", total])
        return sorted_tree(
            {"buckets": buckets, "sum": acc, "count": total})

    def quantile(self, q: float) -> Optional[float]:
        return quantile(self.snapshot(), q)


def _le_value(le) -> float:
    if isinstance(le, str):
        return math.inf if le.strip() in ("+Inf", "Inf", "inf") \
            else float(le)
    return float(le)


def quantile(snapshot: Optional[Dict], q: float) -> Optional[float]:
    """Estimate the q-quantile from a cumulative-bucket snapshot by
    linear interpolation inside the target bucket (the same model
    PromQL's ``histogram_quantile`` uses).  Observations in the ``+Inf``
    overflow bucket clamp to the largest finite bound.  Returns None on
    an empty histogram."""
    if not snapshot or not snapshot.get("count"):
        return None
    q = min(1.0, max(0.0, float(q)))
    target = q * snapshot["count"]
    lo = 0.0
    prev_cum = 0
    last_finite = 0.0
    for le, cum in snapshot["buckets"]:
        bound = _le_value(le)
        if math.isinf(bound):
            if cum >= target:
                return last_finite
            continue
        last_finite = bound
        if cum >= target:
            span = cum - prev_cum
            if span <= 0:
                return bound
            frac = (target - prev_cum) / span
            return lo + (bound - lo) * min(1.0, max(0.0, frac))
        lo = bound
        prev_cum = cum
    return last_finite
