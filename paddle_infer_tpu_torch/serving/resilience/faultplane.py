"""FaultPlane — deterministic, seedable fault injection for the serving
engine.

Port of ``paddle_infer_tpu/serving/resilience/faultplane.py``: pure host
Python, kept as a copy so the port imports nothing of the JAX package.
The seeded ``random.Random`` schedule is the reference's, so one spec
list fires at the same sequence numbers in both packages.

Chaos testing a serving loop needs *reproducible* faults: "MemoryError
on the 7th decode step" must mean the same step on every run, or a chaos
test that passes proves nothing.  The plane is a list of ``FaultSpec``s
evaluated at named **sites** woven into the scheduler hot path
(``EngineCore``), the KV block pool reservation path and the program
dispatches:

  ``decode.step``    before each mixed step's dispatch
  ``prefill.run``    at each ragged admission, once the slot is staged
  ``kv.alloc``       before each slot KV reservation
  ``page.copy``      before each CoW page-copy dispatch
  ``prefix.match``   before each radix-tree prefix lookup
  ``kv.swap_out``    before each park's device->host KV page gather
  ``kv.swap_in``     before each resume's host->device KV page scatter

The port's ``EngineCore`` fires the first five; the two swap sites
belong to the host KV tier, which is not ported yet, and a plane that
scripts them is refused at construction.

Each ``fire(site)`` call increments a per-site sequence number; a spec
triggers either at an exact sequence number (``at`` — scripted schedules)
or with a seeded per-call probability (``p``).  Supported actions:

  ``raise``     raise ``InjectedFault`` (or ``InjectedMemoryError`` when
                ``exc="MemoryError"``) before the site's real work; with
                ``lose_kv=True`` the scheduler additionally drops the
                device page pools, modeling a fault *inside* a step that
                wrote them (full KV loss → engine restart + replay).
  ``latency``   sleep ``delay_s`` at the site (latency spike; long
                enough and the supervisor's step watchdog trips).
  ``hang``      alias of ``latency`` — named separately so schedules
                read as what they simulate.
  ``nan_rows``  report the target request rows as NaN/inf-logit
                corrupted for this step; the scheduler quarantines
                exactly those rows while the batch continues.

When injection is off the scheduler holds the module-level ``NULL_PLANE``
whose ``fire`` is an empty method — one attribute load and a no-op call
per site, nothing else (the "compiled to no-ops when disabled" form a
host-side Python path can have).

All mutable plane state (per-site counters, injected tallies, the seeded
RNG) lives under one lock; effects (sleep, raise) are applied after the
lock is released so a latency spike never serializes other sites.
"""
from __future__ import annotations

import json
import random
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

# the registered sites, the reference's (the same names and order)
SITES: Tuple[str, ...] = ("decode.step", "prefill.run", "kv.alloc",
                          "page.copy", "prefix.match", "kv.swap_out",
                          "kv.swap_in")

_ACTIONS = ("raise", "latency", "hang", "nan_rows")


class InjectedFault(RuntimeError):
    """A fault raised by the plane (``action="raise"``)."""

    def __init__(self, site: str, seq: int, lose_kv: bool = False):
        super().__init__(f"injected fault at {site} (fire #{seq})")
        self.site = site
        self.seq = seq
        self.lose_kv = lose_kv


class InjectedMemoryError(MemoryError):
    """Injected allocation failure — a real ``MemoryError`` subclass so
    the scheduler's degradation ladder reacts exactly as it would to the
    native pool running dry."""

    def __init__(self, site: str, seq: int, lose_kv: bool = False):
        super().__init__(f"injected MemoryError at {site} (fire #{seq})")
        self.site = site
        self.seq = seq
        self.lose_kv = lose_kv


class FaultSpec:
    """One scripted or probabilistic fault.

    ``at`` is the 1-based per-site fire sequence number ("on step 7");
    ``p`` a per-fire probability under the plane's seeded RNG; ``times``
    bounds how often the spec may trigger (default: once for scripted
    ``at`` specs, unbounded for probabilistic ones).  ``rid`` targets a
    specific request id (``nan_rows`` corrupts only that row; ``raise``
    at a request-scoped site only fires while that request is the one
    at the site)."""

    def __init__(self, site: str, action: str = "raise",
                 exc: str = "RuntimeError", at: Optional[int] = None,
                 p: float = 0.0, times: Optional[int] = None,
                 rid: Optional[int] = None, delay_s: float = 0.0,
                 lose_kv: bool = False):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"registered: {SITES}")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; "
                             f"supported: {_ACTIONS}")
        if exc not in ("RuntimeError", "MemoryError"):
            raise ValueError("exc must be 'RuntimeError' or 'MemoryError'")
        self.site = site
        self.action = action
        self.exc = exc
        self.at = None if at is None else int(at)
        self.p = float(p)
        self.times = (1 if times is None and at is not None
                      else times)          # None = unbounded
        self.rid = rid
        self.delay_s = float(delay_s)
        self.lose_kv = bool(lose_kv)
        self.fired = 0

    def to_dict(self) -> dict:
        return {"site": self.site, "action": self.action, "exc": self.exc,
                "at": self.at, "p": self.p, "times": self.times,
                "rid": self.rid, "delay_s": self.delay_s,
                "lose_kv": self.lose_kv, "fired": self.fired}


class FaultPlane:
    """Seeded fault-injection plane (see module docstring)."""

    SITES = SITES

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._specs: List[FaultSpec] = list(specs)
        self._seq: Dict[str, int] = {s: 0 for s in SITES}
        self._injected: Dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec, seed: int = 0) -> "FaultPlane":
        """Build a plane from a JSON string or a list of spec dicts (a
        fault script)."""
        if isinstance(spec, str):
            spec = json.loads(spec)
        return cls([FaultSpec(**d) for d in spec], seed=seed)

    def fire(self, site: str, rid: Optional[int] = None,
             rids: Optional[Iterable[int]] = None) -> Optional[dict]:
        """Evaluate the schedule at ``site``.  May sleep (latency/hang),
        may raise (injected fault), may return ``{"nan_rids": set}`` for
        the scheduler to corrupt.  ``rid`` identifies the request at a
        request-scoped site; ``rids`` the active rows at ``decode.step``."""
        sleep_s = 0.0
        to_raise: Optional[BaseException] = None
        nan_rids: Set[int] = set()
        with self._lock:
            self._seq[site] += 1
            seq = self._seq[site]
            for spec in self._specs:
                if spec.site != site:
                    continue
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.at is not None:
                    if seq != spec.at:
                        continue
                elif spec.p <= 0.0 or self._rng.random() >= spec.p:
                    continue
                if spec.rid is not None and spec.action != "nan_rows" \
                        and rid is not None and rid != spec.rid:
                    continue
                if spec.action == "nan_rows":
                    pool = set(rids or ())
                    if spec.rid is not None:
                        hit = {spec.rid} & pool
                    else:               # deterministic: lowest active rid
                        hit = {min(pool)} if pool else set()
                    if not hit:
                        continue
                    nan_rids |= hit
                elif spec.action in ("latency", "hang"):
                    sleep_s = max(sleep_s, spec.delay_s)
                elif to_raise is None:
                    cls = (InjectedMemoryError if spec.exc == "MemoryError"
                           else InjectedFault)
                    to_raise = cls(site, seq, lose_kv=spec.lose_kv)
                spec.fired += 1
                self._injected[site] = self._injected.get(site, 0) + 1
        if sleep_s > 0.0:
            time_sleep(sleep_s)
        if to_raise is not None:
            raise to_raise
        return {"nan_rids": nan_rids} if nan_rids else None

    def counts(self) -> Dict[str, int]:
        """Injected-fault tally per site (the ``faults_injected_total``
        Prometheus family)."""
        with self._lock:
            return dict(self._injected)

    def specs_snapshot(self) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in self._specs]


class _NullPlane:
    """The disabled plane: ``fire`` does nothing and allocates nothing."""

    SITES = SITES

    def fire(self, site, rid=None, rids=None):
        return None

    def counts(self):
        return {}


# sleep lives behind a module hook so chaos tests can virtualize time
from time import sleep as time_sleep  # noqa: E402  (bottom: patch point)

NULL_PLANE = _NullPlane()
