"""Span-based request tracer for the serving path.

Port of ``paddle_infer_tpu/observability/tracing.py`` (unchanged).
TTFT/ITL percentiles say *that* a request was slow, this module says
*why*.
Every request moving through ``serving.EngineCore`` gets a ``Trace``
holding explicit ``Span``s with no wall-clock-free zones — queue wait,
prefill, each fused decode chunk, evict, and (appended by the HTTP
layer) detokenize — stitched edge-to-edge so the covered fraction of
the request's end-to-end wall time is a *measured* quantity
(``Trace.coverage()``), not an assumption.

Completed traces land in a bounded ring buffer keyed by request id.
Export is Chrome-trace JSON (``ph: "X"`` events, microsecond
``ts``/``dur``, ``thread_name`` metadata), the event shape
``torch.profiler``'s Chrome export uses, so a serving trace opens
beside a device profile in the same viewer.

Every time is ``time.monotonic()``, the clock of ``Request.arrival``:
the engine's spans start at the request's arrival and chain on it.

Span nesting is explicit: ``Tracer.span`` is a context manager keeping
a per-thread stack, so a span opened inside another records its parent
and depth — ordering and nesting round-trip through the Chrome export.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

_span_ids = itertools.count(1)


def _now() -> float:
    return time.monotonic()


class Span:
    """One timed region of a request's life.  ``start``/``end`` are
    ``time.monotonic()`` seconds; ``parent`` is the enclosing span's id
    (None at top level)."""

    __slots__ = ("sid", "name", "start", "end", "parent", "depth", "attrs")

    def __init__(self, name: str, start: float, end: Optional[float] = None,
                 parent: Optional[int] = None, depth: int = 0,
                 attrs: Optional[dict] = None):
        self.sid = next(_span_ids)
        self.name = name
        self.start = float(start)
        self.end = None if end is None else float(end)
        self.parent = parent
        self.depth = depth
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return 0.0 if self.end is None else max(self.end - self.start, 0.0)

    def to_dict(self) -> dict:
        return {"sid": self.sid, "name": self.name, "start": self.start,
                "end": self.end, "duration_s": self.duration,
                "parent": self.parent, "depth": self.depth,
                "attrs": dict(self.attrs)}


class Trace:
    """All spans of one request, from submission to finish."""

    def __init__(self, rid: int, meta: Optional[dict] = None):
        self.rid = rid
        self.meta = meta or {}
        self.begin = _now()
        self.finish: Optional[float] = None
        self.state: Optional[str] = None
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def add(self, span: Span) -> Span:
        with self._lock:
            self.spans.append(span)
        return span

    def ordered(self) -> List[Span]:
        with self._lock:
            return sorted(self.spans, key=lambda s: (s.start, s.depth))

    # ---------------------------------------------------------- analysis
    def duration(self) -> float:
        end = self.finish if self.finish is not None else _now()
        return max(end - self.begin, 0.0)

    def coverage(self) -> float:
        """Fraction of [begin, finish] covered by the union of top-level
        spans (interval union, so overlapping spans don't double-count).
        This is the acceptance metric: the engine stitches spans
        edge-to-edge, so anything below ~1.0 is unattributed scheduler
        time."""
        total = self.duration()
        if total <= 0:
            return 0.0
        ivals = sorted((s.start, s.end) for s in self.ordered()
                       if s.depth == 0 and s.end is not None)
        covered = 0.0
        cur_a = cur_b = None
        for a, b in ivals:
            a = max(a, self.begin)
            b = min(b, self.begin + total)
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    covered += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            covered += cur_b - cur_a
        return min(covered / total, 1.0)

    # ------------------------------------------------------------ export
    def to_dict(self) -> dict:
        return {"request_id": self.rid, "meta": dict(self.meta),
                "begin": self.begin, "finish": self.finish,
                "state": self.state, "duration_s": self.duration(),
                "coverage": round(self.coverage(), 4),
                "spans": [s.to_dict() for s in self.ordered()]}

    def to_chrome(self, pid: int = 0) -> dict:
        """Chrome-trace JSON ({"traceEvents": [...]}, us timestamps),
        one tid per request."""
        tid = self.rid
        events = [{"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": tid,
                   "args": {"name": f"request {self.rid}"}}]
        for s in self.ordered():
            if s.end is None:
                continue
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": tid,
                "ts": s.start * 1e6, "dur": s.duration * 1e6,
                "args": {"request_id": self.rid, "depth": s.depth,
                         **{k: v for k, v in s.attrs.items()}}})
        return {"traceEvents": events}


class _SpanCtx:
    """Context manager produced by ``Tracer.span`` — closes the span and
    pops the per-thread nesting stack on exit."""

    def __init__(self, tracer: "Tracer", trace: Trace, name: str,
                 attrs: Optional[dict]):
        self._tracer = tracer
        self._trace = trace
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        stack = self._tracer._stack()
        parent = stack[-1] if stack else None
        self.span = Span(self._name, _now(),
                         parent=None if parent is None else parent.sid,
                         depth=0 if parent is None else parent.depth + 1,
                         attrs=self._attrs)
        stack.append(self.span)
        self._trace.add(self.span)
        return self.span

    def __exit__(self, *exc):
        self.span.end = _now()
        stack = self._tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        return False


class Tracer:
    """Request-trace registry: live traces by request id plus a bounded
    ring of completed ones (oldest evicted first).  All methods are
    thread-safe; span *recording* on one trace may come from the
    scheduler thread while the HTTP thread reads another."""

    def __init__(self, ring_size: int = 256):
        self.ring_size = int(ring_size)
        self._live: Dict[int, Trace] = {}
        self._done: "OrderedDict[int, Trace]" = OrderedDict()
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # ----------------------------------------------------------- lifecycle
    def begin(self, rid: int, **meta) -> Trace:
        tr = Trace(rid, meta)
        with self._lock:
            self._live[rid] = tr
        return tr

    def end(self, rid: int, state: str = "done") -> Optional[Trace]:
        """Finalize a trace and move it into the completed ring."""
        with self._lock:
            tr = self._live.pop(rid, None)
            if tr is None:
                return None
            tr.finish = _now()
            tr.state = state
            self._done[rid] = tr
            while len(self._done) > self.ring_size:
                self._done.popitem(last=False)
        return tr

    # ----------------------------------------------------------- recording
    def span(self, rid: int, name: str, **attrs) -> _SpanCtx:
        """``with tracer.span(rid, "prefill"): ...`` — nested uses on the
        same thread record parent/depth."""
        tr = self._get_any(rid)
        if tr is None:
            tr = self.begin(rid)
        return _SpanCtx(self, tr, name, attrs or None)

    def add_span(self, rid: int, name: str, start: float, end: float,
                 **attrs) -> Optional[Span]:
        """Record an externally-timed span (e.g. one fused decode chunk
        measured once and attributed to every active row).  Works on
        completed traces still in the ring too — the HTTP layer appends
        its detokenize span after the engine finished the request."""
        tr = self._get_any(rid)
        if tr is None:
            return None
        return tr.add(Span(name, start, end, attrs=attrs or None))

    # ------------------------------------------------------------- lookup
    def _get_any(self, rid: int) -> Optional[Trace]:
        with self._lock:
            return self._live.get(rid) or self._done.get(rid)

    def get(self, rid: int) -> Optional[Trace]:
        return self._get_any(rid)

    def completed(self) -> List[Trace]:
        with self._lock:
            return list(self._done.values())

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def summaries(self) -> List[dict]:
        """One line per completed trace (newest last) for ``GET
        /traces``."""
        return [{"request_id": t.rid, "state": t.state,
                 "duration_s": round(t.duration(), 6),
                 "coverage": round(t.coverage(), 4),
                 "spans": len(t.spans), "meta": dict(t.meta)}
                for t in self.completed()]
