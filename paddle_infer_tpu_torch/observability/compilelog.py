"""Recompile detector: a process-wide log of program builds.

Port of ``paddle_infer_tpu/observability/compilelog.py``.  The JAX
package logs each XLA compilation; the port logs what takes its place:

* on the card, each CUDA graph capture of a serving step or a train
  step (``core/graphs.py``), with the wall time of the call that
  captured it (the eager warm-up execution plus the capture);
* on the CPU, and on the card inside ``disable_graphs()``, the first
  execution of a new argument signature at a site — exactly the event
  the JAX log counts.

Warmup semantics are the reference's: a caller that owns a hot loop
(``serving.EngineCore`` owns one program key) calls ``mark_warm(site,
key)`` after the loop's first successful step.  Any later event at that
(site, key) is the bug the one-graph-per-key design rules out — it
increments ``post_warmup_decode_compiles`` (for a site whose name holds
"decode") and logs one structured warning.  A signature recorded twice
at the same (site, key) flips the ``recompile_storm`` gauge.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("paddle_infer_tpu_torch.observability")

_RING = 512             # events kept for inspection


def sorted_tree(obj):
    """``obj`` rebuilt with dict keys in sorted order (by ``str``, so
    mixed-type keys still sort); tuples become lists, as JSON renders
    them.  The port's copy of ``observability/stable.py``'s helper."""
    if isinstance(obj, dict):
        return {k: sorted_tree(obj[k])
                for k in sorted(obj, key=lambda x: (str(type(x)), str(x)))}
    if isinstance(obj, (list, tuple)):
        return [sorted_tree(v) for v in obj]
    return obj


def signature_of(args) -> tuple:
    """Shape/dtype signature of a flat argument list.  Non-tensors hash
    by value (static args), None stays None; lists, tuples and dicts
    recurse."""
    sig = []
    for a in args:
        if a is None:
            sig.append(None)
        elif hasattr(a, "shape") and hasattr(a, "dtype"):
            sig.append((tuple(a.shape), str(a.dtype)))
        elif isinstance(a, (list, tuple)):
            sig.append(signature_of(a))
        elif isinstance(a, dict):
            sig.append(tuple(sorted(
                (k, signature_of((v,))) for k, v in a.items())))
        else:
            try:
                hash(a)
                sig.append(("S", a))
            except TypeError:
                sig.append(("S", type(a).__name__))
    return tuple(sig)


class CompileEvent:
    __slots__ = ("site", "key", "signature", "wall_s", "at", "post_warmup")

    def __init__(self, site, key, signature, wall_s, post_warmup):
        self.site = site
        self.key = key
        self.signature = signature
        self.wall_s = float(wall_s)
        self.at = time.time()
        self.post_warmup = bool(post_warmup)

    def to_dict(self) -> dict:
        return {"site": self.site, "key": repr(self.key),
                "signature": repr(self.signature),
                "wall_s": round(self.wall_s, 6), "at": self.at,
                "post_warmup": self.post_warmup}


class CompileLog:
    """Thread-safe build registry (one process-wide instance via
    ``get_compile_log()``)."""

    def __init__(self, ring: int = _RING):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=ring)
        self._count_by_site: Dict[str, int] = {}
        self._seen: Dict[Tuple, int] = {}      # (site,key,sig) -> times
        self._warm: set = set()                # (site, key) marked warm
        self.enabled = True
        self.compile_count = 0
        self.recompile_count = 0               # same signature again
        self.post_warmup_compiles = 0
        self.post_warmup_decode_compiles = 0

    def record(self, site: str, key, signature, wall_s: float):
        if not self.enabled:
            return
        with self._lock:
            skey = (site, key, signature)
            times = self._seen.get(skey, 0)
            self._seen[skey] = times + 1
            post_warm = (site, key) in self._warm
            self._events.append(
                CompileEvent(site, key, signature, wall_s, post_warm))
            self.compile_count += 1
            self._count_by_site[site] = self._count_by_site.get(site, 0) + 1
            if times:
                self.recompile_count += 1
            if post_warm:
                self.post_warmup_compiles += 1
                if "decode" in site:
                    self.post_warmup_decode_compiles += 1
        if post_warm:
            logger.warning(
                "recompile after warmup: site=%s key=%r signature=%r "
                "wall_s=%.4f (the warm program's graph cache no longer "
                "covers this call)", site, key, signature, wall_s)

    def mark_warm(self, site: str, key=None):
        """Declare a hot loop warmed: events at (site, key) from now on
        are recompiles by definition."""
        with self._lock:
            self._warm.add((site, key))

    def is_warm(self, site: str, key=None) -> bool:
        with self._lock:
            return (site, key) in self._warm

    def count(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return self.compile_count
            return self._count_by_site.get(site, 0)

    @property
    def recompile_storm(self) -> bool:
        """True when any single (site, key, signature) was recorded more
        than once."""
        with self._lock:
            return self.recompile_count > 0

    def events(self, site: Optional[str] = None) -> List[CompileEvent]:
        with self._lock:
            evs = list(self._events)
        if site is not None:
            evs = [e for e in evs if e.site == site]
        return evs

    def summary(self) -> dict:
        """The reference's gauge block, key for key."""
        with self._lock:
            return sorted_tree({
                "compile_count": self.compile_count,
                "compile_count_by_site": dict(self._count_by_site),
                "recompile_count": self.recompile_count,
                "recompile_storm": self.recompile_count > 0,
                "post_warmup_compiles": self.post_warmup_compiles,
                "post_warmup_decode_compiles":
                    self.post_warmup_decode_compiles,
                "compile_wall_s_total": round(
                    sum(e.wall_s for e in self._events), 6),
            })

    def reset(self):
        with self._lock:
            self._events.clear()
            self._count_by_site.clear()
            self._seen.clear()
            self._warm.clear()
            self.compile_count = 0
            self.recompile_count = 0
            self.post_warmup_compiles = 0
            self.post_warmup_decode_compiles = 0


_LOG = CompileLog()


def get_compile_log() -> CompileLog:
    return _LOG


def instrument_first_calls(fn, site: str, key):
    """``instrument_jit``'s counterpart: wrap an eager callable so its
    first call per argument signature is timed and recorded.  Known
    signatures pay one set lookup; with the log disabled, one attribute
    check."""
    seen = set()

    def wrapped(*args, **kwargs):
        if not _LOG.enabled:
            return fn(*args, **kwargs)
        sig = signature_of(args)
        if sig in seen:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        seen.add(sig)
        _LOG.record(site, key, sig, wall)
        return out

    wrapped.__wrapped__ = fn
    return wrapped
