"""Request lifecycle and admission queue of the serving engine.

Port of ``paddle_infer_tpu/serving/request.py`` (the parts the ragged
single-device path uses).  A ``Request`` is one sequence, or one
exclusive engine call, moving through
QUEUED → ACTIVE → DONE/REJECTED/CANCELLED/FAILED; the scheduler thread
``_emit()``s tokens as they decode and consumers read them through
``stream()`` or ``result()``.  ``RequestQueue`` is a depth-bounded FIFO
with all-or-nothing ``submit_many`` and deadline sweeping; recovery
requeues a replayed request at its head (``push_front``) and the
degradation ladder sheds queued requests short of deadline headroom
(``shed_low_headroom``).

``_rid_counter`` is module-level, as in the reference, so a test can pin
request ids in both packages: each request's sampling key is
``fold_in(PRNGKey(seed), rid)``.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from enum import Enum
from typing import Callable, List, Optional

import numpy as np


class RejectedError(RuntimeError):
    """Request refused by admission control (bad size, shutdown, ...)."""


class QueueFullError(RejectedError):
    """Queue at max depth — backpressure, retry later."""


class DeadlineExceededError(RejectedError):
    """Per-request deadline passed while queued or mid-decode."""


class QuarantinedError(RejectedError):
    """Poison request: failed the engine past its retry budget (or while
    the engine is DOWN) and was quarantined instead of requeued."""


class LoadShedError(RejectedError):
    """Dropped by the degradation ladder (too little deadline headroom
    for the degraded engine) or refused while DRAINING."""


def effective_salt(cache_salt, adapter_id):
    """The prefix-cache isolation key from a tenant salt and an adapter
    binding: the adapter id joins the salt whenever one is present, so
    KV written under one fine-tune is never warm for another.  Salts are
    opaque hashable keys to the radix tree."""
    if adapter_id is None:
        return cache_salt
    return ("adapter", adapter_id, cache_salt)


class RequestState(Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    DONE = "done"
    REJECTED = "rejected"
    CANCELLED = "cancelled"
    FAILED = "failed"


_END = object()          # stream sentinel
_rid_counter = itertools.count(1)


class Request:
    """One serving request: a single sequence row (``kind="batch"``), or
    one engine call the continuous batch cannot host
    (``kind="exclusive"``: ``exclusive_fn`` runs alone on the scheduler
    thread and its return value lands in ``value``)."""

    def __init__(self, prompt, config, timeout_s: Optional[float] = None,
                 cache_salt: Optional[str] = None, kind: str = "batch",
                 exclusive_fn: Optional[Callable] = None,
                 tenant: Optional[str] = None):
        self.rid = next(_rid_counter)
        self.prompt = (None if prompt is None
                       else np.asarray(prompt, np.int32).reshape(-1))
        self.config = config
        self.kind = kind
        self.exclusive_fn = exclusive_fn
        self.value = None                  # exclusive_fn's return value
        # prefix-cache isolation domain: requests share cached KV only
        # with requests carrying the same salt (multi-tenant isolation)
        self.cache_salt = cache_salt
        # accounting label only (per-tenant SLO families, journey
        # attribution): never a scheduling or cache-isolation input
        self.tenant = tenant
        self.arrival = time.monotonic()
        self.deadline = (None if timeout_s is None
                         else self.arrival + float(timeout_s))
        self.state = RequestState.QUEUED
        self.error: Optional[BaseException] = None
        self.tokens: List[int] = []        # delivered tokens
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # retry/replay bookkeeping (resilience/supervisor.py): how many
        # engine failures this request already survived, and when it was
        # last requeued for replay
        self.retries = 0
        self.requeued_at: Optional[float] = None
        self._chunks: _queue.Queue = _queue.Queue()
        self._done = threading.Event()

    def route_salt(self):
        """The key under which this request reads and writes the prefix
        cache: ``effective_salt(cache_salt, adapter_id)``, with no
        adapter (adapters are not ported yet)."""
        return effective_salt(self.cache_salt, None)

    # ------------------------------------------------- scheduler side
    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline

    def _mark_active(self):
        self.state = RequestState.ACTIVE

    def _requeue(self):
        """Return a failed-but-replayable request to QUEUED.  Delivered
        tokens are kept — replay resumes generation after them (the
        consumer's stream is never rewound, so no duplicates)."""
        self.state = RequestState.QUEUED
        self.requeued_at = time.monotonic()

    def _emit(self, toks: np.ndarray):
        """Deliver decoded tokens (1-D array) to the consumer."""
        toks = np.asarray(toks, np.int32).reshape(-1)
        if toks.size == 0:
            return
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.tokens.extend(int(t) for t in toks)
        self._chunks.put(toks)

    def _finish(self, state: RequestState,
                error: Optional[BaseException] = None):
        self.state = state
        self.error = error
        self.finished_at = time.monotonic()
        self._chunks.put(_END)
        self._done.set()

    # -------------------------------------------------- consumer side
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def emitted(self) -> int:
        return len(self.tokens)

    def stream(self, timeout: Optional[float] = None):
        """Iterator over token chunks (np.int32 [n]) as they decode.
        Raises the request's error after draining."""
        while True:
            chunk = self._chunks.get(timeout=timeout)
            if chunk is _END:
                break
            yield chunk
        if self.error is not None:
            raise self.error

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until finished; return the delivered tokens [n]."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still running")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)


class RequestQueue:
    """Depth-bounded FIFO with deadline sweeping.  All mutation happens
    under one condition variable the scheduler waits on."""

    def __init__(self, max_depth: int = 64):
        self.max_depth = int(max_depth)
        self._q: List[Request] = []
        self._cond = threading.Condition()

    def __len__(self):
        with self._cond:
            return len(self._q)

    def submit(self, req: Request):
        self.submit_many([req])

    def submit_many(self, reqs: List[Request]):
        """Admit all of ``reqs`` or none.  Raises QueueFullError under
        backpressure."""
        with self._cond:
            if len(self._q) + len(reqs) > self.max_depth:
                raise QueueFullError(
                    f"queue full ({len(self._q)}/{self.max_depth} deep, "
                    f"{len(reqs)} arriving)")
            self._q.extend(reqs)
            self._cond.notify_all()

    def peek(self) -> Optional[Request]:
        with self._cond:
            return self._q[0] if self._q else None

    def pop(self) -> Optional[Request]:
        with self._cond:
            return self._q.pop(0) if self._q else None

    def remove_expired(self, now: float) -> List[Request]:
        """Drop and return every queued request past its deadline."""
        with self._cond:
            dead = [r for r in self._q if r.expired(now)]
            if dead:
                self._q = [r for r in self._q if not r.expired(now)]
            return dead

    def push_front(self, req: Request):
        """Requeue a replayed request at the queue HEAD — recovery must
        not send a half-served request to the back of the line.  Bypasses
        the depth bound: the request was already admitted once and
        dropping it now would lose its delivered tokens."""
        with self._cond:
            self._q.insert(0, req)
            self._cond.notify_all()

    def shed_low_headroom(self, now: float,
                          min_headroom_s: float) -> List[Request]:
        """Drop and return queued batch requests whose deadline headroom
        is below ``min_headroom_s`` (degradation-ladder load shedding;
        deadline-less requests are never shed)."""

        def low(r: Request) -> bool:
            return (r.kind == "batch" and r.deadline is not None
                    and r.deadline - now < min_headroom_s)

        with self._cond:
            shed = [r for r in self._q if low(r)]
            if shed:
                self._q = [r for r in self._q if not low(r)]
            return shed

    def drain(self) -> List[Request]:
        with self._cond:
            out, self._q = self._q, []
            return out

    def wait(self, timeout: float):
        """Sleep until new work is submitted (or timeout)."""
        with self._cond:
            if not self._q:
                self._cond.wait(timeout)
