"""Fleet-wide request journeys: cross-replica trace stitching and
latency attribution.

Port of ``paddle_infer_tpu/observability/journey.py`` (unchanged).  A
single ``EngineCore`` keeps a private store; the cross-replica parts
(``record_import``, ``context``) wait for the port's fleet and host KV
tier to call them.

Since the disaggregated fleet (router dispatch, chunk-boundary KV
handoff) and the host-RAM KV tier (park/resume), one request's life
spans multiple ``EngineCore``s — but the ``tracing.Tracer`` is strictly
per-core, so no single artifact explains where a slow request spent its
time.  This module adds the missing plane:

``JourneyStore``
    One store shared by every core in a fleet (each core registers its
    replica name + ``Tracer``).  A *journey* is keyed by request id —
    rids are preserved across handoff and park/resume precisely so the
    bitwise stream contract holds, which makes them a free global
    correlation key.  A journey context (``journey_id``, origin
    replica, hop count) rides the handoff/park packet dicts as plain
    data; importing a packet records a *hop edge* (source replica,
    destination replica, transfer interval between the export span's
    end and the import span's start).

Latency attribution
    On finish the journey's end-to-end wall ``[begin, finish]`` is
    decomposed into named, non-overlapping buckets by an interval sweep
    over every replica's depth-0 spans plus synthesized intervals for
    parked time (park-span end -> resume-span start) and handoff
    transfer (export end -> import start).  The sweep *partitions* the
    window, so buckets sum to e2e exactly by construction; anything no
    span claims lands in ``other`` and the coverage gauge
    (``1 - other/e2e``) makes attribution drift a visible defect, not a
    silent lie.

Chrome export
    ``to_chrome(rid)`` renders the multi-replica journey as ONE Chrome
    trace: each replica becomes a process lane (``pid`` = replica
    index, named via ``process_name`` metadata), and a final synthetic
    ``journey`` lane carries the hop-edge and parked-interval events so
    the cross-replica structure is visible at a glance.

Everything here is host-side plain Python over already-recorded spans:
no device work, no effect on scheduling order (bitwise streams) and no
new traced shapes (zero post-warmup compiles).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from .stable import sorted_tree
from .tracing import Trace, Tracer

# The closed bucket vocabulary.  Order matters: it is the presentation
# order in summaries and the docs catalog.
BUCKETS = ("queue_wait", "sched_reorder", "adapter_wait",
           "prefill_compute", "handoff", "parked", "resume",
           "decode_compute", "detok", "replay_retry", "other")

# span name -> bucket.  Engine span names are a closed set (the
# reference's catalog); anything unknown attributes to
# the nearest compute bucket via _default below.
_SPAN_BUCKET = {
    "queue_wait": "queue_wait",
    "sched_reorder": "sched_reorder",
    "adapter_wait": "adapter_wait",
    "prefix_match": "prefill_compute",
    "prefill": "prefill_compute",
    "suffix_prefill": "prefill_compute",
    "decode": "decode_compute",
    "exclusive": "decode_compute",
    "evict": "decode_compute",
    "handoff": "handoff",
    "route": "handoff",
    "park": "parked",
    "resume": "resume",
    "recovery": "replay_retry",
    "detokenize": "detok",
}

# Sweep priority when spans overlap (rare: the engine chains spans
# edge-to-edge via slot span_end, but the router's route span overlaps
# the head of queue_wait, and replayed requests can re-cover intervals).
# Control/transition spans beat compute spans beat synthesized gaps.
_PRIORITY = {
    "handoff": 5, "parked": 5, "resume": 5, "replay_retry": 5,
    "queue_wait": 4, "sched_reorder": 4, "adapter_wait": 4, "detok": 4,
    "prefill_compute": 3, "decode_compute": 3,
}
_GAP_PRIORITY = 2  # synthesized parked/transfer gaps: only fill holes


def _bucket_of(name: str) -> str:
    return _SPAN_BUCKET.get(name, "decode_compute")


def attribute(intervals: List[tuple], begin: float,
              finish: float) -> Dict[str, float]:
    """Partition ``[begin, finish]`` into bucket seconds.

    ``intervals`` is a list of ``(start, end, bucket, priority)``; the
    highest-priority covering interval wins each elementary segment,
    uncovered segments land in ``other``.  Returns a dict over every
    name in ``BUCKETS``; values sum to ``finish - begin`` exactly.
    """
    out = {b: 0.0 for b in BUCKETS}
    total = finish - begin
    if total <= 0:
        return out
    clipped = []
    points = {begin, finish}
    for a, b, bucket, prio in intervals:
        a = max(float(a), begin)
        b = min(float(b), finish)
        if b <= a:
            continue
        clipped.append((a, b, bucket, prio))
        points.add(a)
        points.add(b)
    cuts = sorted(points)
    for i in range(len(cuts) - 1):
        lo, hi = cuts[i], cuts[i + 1]
        mid = (lo + hi) / 2.0
        best = None
        for a, b, bucket, prio in clipped:
            if a <= mid < b and (best is None or prio > best[0]):
                best = (prio, bucket)
        out[best[1] if best else "other"] += hi - lo
    return out


class _Journey:
    """Mutable per-request journey record (live until finalize)."""

    __slots__ = ("jid", "rid", "origin", "tenant", "hops", "replicas",
                 "hop_events", "state", "finished", "cached")

    def __init__(self, rid: int, origin: str):
        self.jid = f"j{rid}"
        self.rid = rid
        self.origin = origin
        self.tenant: Optional[str] = None
        self.hops = 0
        self.replicas = [origin]
        self.hop_events: List[dict] = []
        self.state: Optional[str] = None
        self.finished = False
        self.cached: Optional[dict] = None


class JourneyStore:
    """Fleet-shared journey registry.  Thread-safe: cores finish
    requests on their scheduler threads while the HTTP thread reads."""

    def __init__(self, ring_size: int = 512):
        self.ring_size = int(ring_size)
        # annotated as Dict (not OrderedDict) so the lock-order
        # analyzer resolves the value type and sees the
        # JourneyStore._lock -> Tracer._lock/Trace._lock ordering
        self._tracers: Dict[str, Tracer] = OrderedDict()
        self._live: Dict[int, _Journey] = {}
        self._done: "OrderedDict[int, _Journey]" = OrderedDict()
        self._lock = threading.RLock()
        # running aggregates for the snapshot section / gauge
        self._count = 0
        self._hops_total = 0
        self._coverage_sum = 0.0
        self._bucket_sums = {b: 0.0 for b in BUCKETS}

    # ------------------------------------------------------------ wiring
    def register(self, replica: str, tracer: Tracer) -> None:
        """Attach one core's tracer under its replica name.  Idempotent
        per name; re-registering a name rebinds it (test fixtures)."""
        with self._lock:
            self._tracers[str(replica)] = tracer

    # --------------------------------------------------------- lifecycle
    def begin(self, rid: int, replica: str,
              tenant: Optional[str] = None) -> str:
        """Start (or adopt) the journey for ``rid`` at ``replica``.
        Idempotent: re-submission after requeue keeps the original
        origin and hop count."""
        with self._lock:
            j = self._live.get(rid)
            if j is None:
                j = self._live[rid] = _Journey(rid, str(replica))
            if tenant is not None:
                j.tenant = str(tenant)
            return j.jid

    def context(self, rid: int, replica: str,
                export_end: Optional[float] = None) -> dict:
        """Journey context for a handoff/park packet: plain data only —
        packets must survive pickling into the host tier."""
        with self._lock:
            j = self._live.get(rid)
            if j is None:
                self.begin(rid, replica)
                j = self._live[rid]
            return {"journey_id": j.jid, "origin": j.origin,
                    "replica": str(replica), "hops": j.hops,
                    "tenant": j.tenant, "export_end": export_end}

    def record_import(self, rid: int, ctx: Optional[dict], replica: str,
                      t0: float, t1: float, **attrs) -> None:
        """A packet landed on ``replica``: bump the hop count and record
        the hop edge (transfer interval = export end -> import start)."""
        with self._lock:
            j = self._live.get(rid)
            if j is None:
                origin = (ctx or {}).get("origin", str(replica))
                j = self._live[rid] = _Journey(rid, origin)
            if ctx:
                j.hops = int(ctx.get("hops", j.hops)) + 1
                if ctx.get("tenant") is not None and j.tenant is None:
                    j.tenant = ctx["tenant"]
                src = ctx.get("replica", j.origin)
            else:
                j.hops += 1
                src = j.replicas[-1]
            if str(replica) != j.replicas[-1]:
                j.replicas.append(str(replica))
            start = (ctx or {}).get("export_end")
            j.hop_events.append({
                "kind": "handoff", "src": src, "dst": str(replica),
                "start": float(start) if start is not None else float(t0),
                "end": float(t0), "import_end": float(t1), **attrs})

    def finalize(self, rid: int, state: str) -> Optional[dict]:
        """Move the journey to the done ring and return its attribution
        summary (computed over spans recorded so far; late spans like
        the HTTP detokenize append still show in ``get``/``to_chrome``,
        which recompute)."""
        with self._lock:
            j = self._live.pop(rid, None)
            if j is None:
                return None
            j.state = state
            j.finished = True
            # close out still-live traces on OTHER replicas (the source
            # core of a handoff never sees the request finish) so their
            # live tables stay bounded; end() is a no-op for tracers
            # that already finished (or never saw) this rid
            # subscript (not .values()) iteration so the lock-order
            # analyzer types the receiver and records the
            # JourneyStore._lock -> Tracer._lock ordering
            for name in self._tracers:
                self._tracers[name].end(rid, state)
            j.cached = self._summarize(j)
            self._done[rid] = j
            while len(self._done) > self.ring_size:
                self._done.popitem(last=False)
            self._count += 1
            self._hops_total += j.hops
            self._coverage_sum += j.cached["coverage"]
            for b, v in j.cached["buckets"].items():
                self._bucket_sums[b] += v
            return dict(j.cached)

    # --------------------------------------------------------- stitching
    def _traces(self, j: _Journey) -> Dict[str, Trace]:
        """Per-replica traces for this rid, in replica-visit order, then
        any other registered tracer that happens to hold the rid.

        Subscript (not ``.get``/``.items``) access so the lock-order
        analyzer resolves the receiver types and sees the
        ``JourneyStore._lock -> Tracer._lock/Trace._lock`` ordering."""
        out: Dict[str, Trace] = OrderedDict()
        seen = set()  # a fleet may share ONE Tracer across replicas —
        #               the same Trace must not stitch in twice
        for name in j.replicas:
            if name not in self._tracers:
                continue
            t = self._tracers[name].get(j.rid)
            if t is not None and id(t) not in seen:
                out[name] = t
                seen.add(id(t))
        for name in self._tracers:
            if name in out:
                continue
            t = self._tracers[name].get(j.rid)
            if t is not None and id(t) not in seen:
                out[name] = t
                seen.add(id(t))
        return out

    def _window(self, j: _Journey, traces: Dict[str, Trace]) -> tuple:
        begins, ends = [], []
        for name in traces:
            t = traces[name]
            begins.append(t.begin)
            if t.finish is not None:
                ends.append(t.finish)
            for s in t.ordered():
                if s.end is not None:
                    ends.append(s.end)
        for h in j.hop_events:
            ends.append(h["import_end"])
        if not begins or not ends:
            return (0.0, 0.0)
        return (min(begins), max(ends))

    def _intervals(self, j: _Journey, traces: Dict[str, Trace],
                   begin: float, finish: float) -> List[tuple]:
        ivals: List[tuple] = []
        parks: List[tuple] = []    # (end_of_park_span,)
        resumes: List[float] = []  # start_of_resume_span
        exports: List[float] = []
        imports: List[float] = []
        for name in traces:
            for s in traces[name].ordered():
                if s.end is None or s.depth != 0:
                    continue
                bucket = _bucket_of(s.name)
                ivals.append((s.start, s.end, bucket,
                              _PRIORITY.get(bucket, 3)))
                if s.name == "park":
                    parks.append(s.end)
                elif s.name == "resume":
                    resumes.append(s.start)
                elif s.name == "handoff":
                    if s.attrs.get("direction") == "export":
                        exports.append(s.end)
                    elif s.attrs.get("direction") == "import":
                        imports.append(s.start)
        # synthesized parked gaps: park-span end -> next resume start
        # (or journey finish when the request dies parked)
        resumes.sort()
        for p_end in sorted(parks):
            nxt = next((r for r in resumes if r >= p_end), finish)
            if nxt > p_end:
                ivals.append((p_end, nxt, "parked", _GAP_PRIORITY))
        # synthesized transfer gaps: export end -> next import start
        imports.sort()
        for e_end in sorted(exports):
            nxt = next((i for i in imports if i >= e_end), None)
            if nxt is not None and nxt > e_end:
                ivals.append((e_end, nxt, "handoff", _GAP_PRIORITY))
        for h in j.hop_events:
            if h["end"] > h["start"]:
                ivals.append((h["start"], h["end"], "handoff",
                              _GAP_PRIORITY))
        return ivals

    def _summarize(self, j: _Journey) -> dict:
        traces = self._traces(j)
        begin, finish = self._window(j, traces)
        e2e = max(finish - begin, 0.0)
        buckets = attribute(
            self._intervals(j, traces, begin, finish), begin, finish)
        coverage = (1.0 - buckets["other"] / e2e) if e2e > 0 else 0.0
        return {"journey_id": j.jid, "request_id": j.rid,
                "tenant": j.tenant, "origin": j.origin,
                "replicas": list(traces.keys()) or list(j.replicas),
                "hops": j.hops, "state": j.state,
                "e2e_s": round(e2e, 6),
                "coverage": round(coverage, 4),
                "buckets": {b: round(v, 6) for b, v in buckets.items()}}

    # ------------------------------------------------------------ lookup
    def _find(self, key) -> Optional[_Journey]:
        """Accept a rid int, its str form, or a ``j<rid>`` journey id."""
        try:
            rid = int(str(key).lstrip("j"))
        except ValueError:
            return None
        return self._done.get(rid) or self._live.get(rid)

    def get(self, key) -> Optional[dict]:
        """Full journey: fresh attribution summary + per-replica span
        dumps + hop edges.  Recomputed on read so late spans (HTTP
        detokenize) are included."""
        with self._lock:
            j = self._find(key)
            if j is None:
                return None
            out = self._summarize(j)
            traces = self._traces(j)
            out["spans"] = {name: t.to_dict()
                            for name, t in traces.items()}
            out["hop_events"] = [dict(h) for h in j.hop_events]
            return out

    def to_chrome(self, key) -> Optional[dict]:
        """One Chrome trace for the whole journey: pid per replica lane
        plus a synthetic ``journey`` lane for hop edges and parked
        intervals."""
        with self._lock:
            j = self._find(key)
            if j is None:
                return None
            traces = self._traces(j)
            events: List[dict] = []
            for pid, (name, t) in enumerate(traces.items()):
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": f"replica {name}"}})
                events.extend(t.to_chrome(pid=pid)["traceEvents"])
            jpid = len(traces)
            events.append({"name": "process_name", "ph": "M",
                           "pid": jpid, "tid": 0,
                           "args": {"name": "journey"}})
            begin, finish = self._window(j, traces)
            for a, b, bucket, prio in self._intervals(
                    j, traces, begin, finish):
                if prio != _GAP_PRIORITY:
                    continue
                events.append({
                    "name": bucket, "ph": "X", "pid": jpid, "tid": j.rid,
                    "ts": a * 1e6, "dur": (b - a) * 1e6,
                    "args": {"request_id": j.rid,
                             "journey_id": j.jid}})
            for h in j.hop_events:
                events.append({
                    "name": f"hop {h['src']}->{h['dst']}", "ph": "X",
                    "pid": jpid, "tid": j.rid,
                    "ts": h["start"] * 1e6,
                    "dur": max(h["import_end"] - h["start"], 0.0) * 1e6,
                    "args": {"request_id": j.rid, "journey_id": j.jid,
                             "kind": h["kind"]}})
            return {"traceEvents": events}

    def summaries(self) -> List[dict]:
        """One line per finished journey (newest last) — ``GET
        /journeys``."""
        with self._lock:
            return [dict(j.cached) for j in self._done.values()
                    if j.cached is not None]

    def summary(self) -> dict:
        """Aggregate section for ``snapshot["journeys"]`` — feeds the
        ``journeys_total`` / ``journey_hops_total`` /
        ``journey_attribution_coverage`` /
        ``journey_attribution_seconds_total{bucket}`` families."""
        with self._lock:
            cov = (self._coverage_sum / self._count
                   if self._count else 0.0)
            return sorted_tree(
                {"count": self._count,
                 "hops_total": self._hops_total,
                 "attribution_coverage": round(cov, 4),
                 "bucket_seconds": {b: round(v, 6) for b, v in
                                    self._bucket_sums.items()},
                 "live": len(self._live)})
