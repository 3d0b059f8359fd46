"""EngineCore — the continuous-batching scheduler, ragged path.

Port of ``paddle_infer_tpu/serving/engine_core.py`` for one device and
the default ``ragged=True`` scheduler.  Each ``run_once()`` iteration
(a background thread just repeats it):

  1. sweep deadlines — expired queued requests are cancelled, expired
     active rows evicted and their KV pages freed;
  2. run the exclusive calls at the queue head, then admit queued
     requests into free slots up to the next exclusive call: admission
     only reserves KV pages and queues the prompt as ``pending`` tokens;
  3. run ONE mixed step (``serving/programs.build_mixed_step``): live
     decode rows feed their last token (packed first), then prompt rows
     feed up to ``prefill_chunk`` pending tokens each, all under the
     per-step ``token_budget`` — so a long prompt interleaves with
     decode instead of stalling it;
  4. emit tokens, evict finished rows, free their pages; freed slots are
     backfilled at the next iteration.

With ``speculate=True`` a decode row may also pack up to
``num_draft_tokens`` proposed continuation tokens (from
``serving/speculation.py``) into the SAME step as a ``query_len = k + 1``
verify row, using only budget left over after decode and prompt
packing; the step then emits each row's accepted window.

With ``enable_prefix_cache=True`` finished sequences' pages are retained
in a radix tree (``serving/prefix_cache/``) and matched against new
prompts at admission: the matched full pages are shared, a matched
partial tail page is copied on write (``build_page_copy``, one graph),
and only the uncached suffix enters the mixed steps as chunk rows
starting at ``ctx = cached``.  A prompt token always goes through the
ragged kernel and a generated token through the decode kernel, however
the prompt was split, so a warm stream is bitwise the cold one.  With an
engine built with ``kv_dtype="int8"`` the pools hold int8 pages under
the slot-0 scale protocol, with or without the cache.

Requests a batch row cannot host (beam search, a repetition penalty)
go through ``submit_exclusive``: an arbitrary call, queued FIFO with the
batch requests, that runs alone on the scheduler thread when it reaches
the queue head, its result in ``req.value``.  The core owns its engine
(its slots are the engine's sequence ids), so such a call runs on
another engine — a dense ``GenerationEngine`` over the same model, as
the reference's HTTP server does.

Slot/pool layout: slot ``s`` reserves native-pool sequence id ``s``; a
one-page scratch reservation (sequence id ``max_batch``) backs every
table entry of inactive rows, so their writes land where no live row's
attention reads.

Fault tolerance (``serving/resilience/``): ``fault_plane=`` fires the
``kv.alloc``, ``prefix.match``, ``page.copy``, ``prefill.run`` and
``decode.step`` sites, and an ``EngineSupervisor`` (``attach_recovery``)
turns failures into replays under a retry budget, as in the reference:
a failed admission is requeued at the queue head, memory pressure
halves the effective batch (and sheds queued work short of deadline
headroom), a poisoned row is quarantined while the batch goes on, and a
failed step replays every in-flight row.  Only an injected fault raised
before the step's dispatch leaves the pools intact; any other failure
marks them lost, and recovery releases every slot, clears the prefix
cache and zeroes the pools in place (``rebuild_kv_state``), so no
captured graph moves.  A replay re-admits prompt + delivered tokens and
samples its next token at step ``emitted`` with the same ``fold_in``
key.  Unlike the reference, which re-prefills the delivered tokens as
chunk rows, the port keeps each token on its kernel, so a replayed
stream is bitwise the stream that never failed: the uncached prompt
goes back through the ragged kernel as chunk rows that sample nothing,
and the delivered tokens whose KV the row lacks go back one a step
through the decode kernel as decode rows that sample nothing until the
last.  With the KV intact and the cache on, the retained pages hold
all but the last delivered token, so the row re-enters straight as a
decode row, in the step where the reference samples its one-token
chunk.  A real device fault (a sticky CUDA error, such as an illegal
address) poisons the CUDA context: the drop-and-rebuild path cannot
recover it, and a repeated failure's crash streak sends the engine
DOWN.  Only injected faults are exercised.

Observability (``observability/``), as in the reference: every request
gets a trace (``tracer``) whose spans chain edge to edge — queue wait,
prefix match, each prefill chunk, each decode step, recovery, evict —
and a journey (a private ``JourneyStore``) whose finish partitions its
e2e wall into attribution buckets and feeds the per-tenant section of
the metrics; every step event (mixed step, failed step, failed
admission, page copy, evict) appends one record to ``steplog`` with its
analytic bytes and FLOPs (``StepCostModel``).  All of it is host data
computed from what the step already read back: it adds no device read
and no graph.  A step's ``dispatch_s`` runs from the dispatch to the
end of its one readback (device time plus launch), its ``host_s`` is
the bookkeeping after it; ``wall_s`` fed to the step metrics is the
former, as before.  A page copy is enqueued without a sync, so its
record carries the enqueue wall and the next step's ``dispatch_s``
absorbs the copy.

Not ported yet, rejected at construction (ROADMAP.md): the legacy
``ragged=False`` programs, adapters, grammars, sharded serving, the host
KV tier (with its fault sites ``kv.swap_out`` / ``kv.swap_in`` and
park-before-shed: ``park_for_pressure`` returns False) and non-fifo
scheduling; also ``enqueue`` (the fleet router's requeue) and the
reference's ``tracer=`` / ``steplog=`` / ``journeys=`` /
``replica_name=`` arguments (the core builds its own, as ``core0``;
they come with the serving entry point and the fleet).  The step
log's planner fields (``planned_tokens``, ``planned_chunk_cap``,
``predicted_wall_s``) and host-tier fields (``parked_rows``,
``host_pages``) keep their schema defaults until the scheduler and the
host KV tier are ported.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..core import random as prng
from ..inference.generation import (GenerationConfig, PagedGenerationEngine,
                                    _round_up)
from ..observability.compilelog import get_compile_log
from ..observability.journey import JourneyStore
from ..observability.steplog import StepCostModel, StepLog
from ..observability.tracing import Tracer
from ..profiler.statistic import memory_stats
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .programs import build_mixed_step, build_page_copy
from .request import (DeadlineExceededError, LoadShedError,
                      QuarantinedError, QueueFullError, RejectedError,
                      Request, RequestQueue, RequestState)
from .resilience.faultplane import (NULL_PLANE, InjectedFault,
                                    InjectedMemoryError)
from .sharded import ShardedConfigError, validate_kv_quant_combo
from .speculation import resolve_draft_source

_log = logging.getLogger(__name__)


# the samp dict's fields, in the program's order
_SAMP_FIELDS = (("temperature", np.float32), ("top_k", np.int32),
                ("top_p", np.float32), ("min_len", np.int32),
                ("eos", np.int32), ("do_sample", np.bool_),
                ("pad", np.int32))

# the host KV tier's fault sites: nothing fires them until it is ported
_TIER_SITES = ("kv.swap_out", "kv.swap_in")
_NO_TOKENS = np.zeros((0,), np.int32)

_TRACE_STATE = {RequestState.DONE: "done", RequestState.FAILED: "failed",
                RequestState.CANCELLED: "cancelled",
                RequestState.REJECTED: "rejected"}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class EngineCore:
    """Continuous-batching scheduler over a ``PagedGenerationEngine``,
    which the core owns for its lifetime: a direct ``generate()`` on it
    would free and re-reserve the slots' sequence ids.  Calls the batch
    cannot host go through ``submit_exclusive`` with another engine."""

    def __init__(self, engine: PagedGenerationEngine, max_batch: int = 8,
                 max_queue: int = 64,
                 default_timeout_s: Optional[float] = None,
                 max_model_len: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 prefill_chunk: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 ragged: bool = True,
                 speculate: bool = False,
                 num_draft_tokens: int = 4,
                 draft_source="auto",
                 enable_prefix_cache: bool = False,
                 prefix_cache_watermark: float = 0.5,
                 prefix_cache_headroom_pages: int = 0,
                 kv_dtype: Optional[str] = None,
                 adapter_store=None,
                 grammar_vocab=None,
                 serving_mesh=None,
                 kv_host_pages: int = 0,
                 sched_policy: str = "fifo",
                 fault_plane=None,
                 device=None):
        unported = {
            "ragged=False": not ragged,
            "adapter_store": adapter_store is not None,
            "grammar_vocab": grammar_vocab is not None,
            "serving_mesh": serving_mesh is not None,
            "kv_host_pages": int(kv_host_pages) > 0,
            f"sched_policy={sched_policy!r}": sched_policy != "fifo",
            "fault sites kv.swap_out / kv.swap_in": any(
                spec["site"] in _TIER_SITES
                for spec in getattr(fault_plane, "specs_snapshot",
                                    list)()),
        }
        asked = [k for k, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"EngineCore options not ported yet: {', '.join(asked)}; "
                "see ROADMAP.md queue 1")
        dev = resolve_device(device)
        if dev.type != engine.device.type:
            raise ValueError(f"EngineCore device {dev} disagrees with the "
                             f"engine's {engine.device}")
        # the engine owns the pools, so it owns their dtype: the kwarg
        # here must agree with it
        engine_kv = engine._kv_dtype
        if kv_dtype is not None and kv_dtype != engine_kv:
            raise ShardedConfigError(
                f"EngineCore kv_dtype={kv_dtype!r} disagrees with the "
                f"engine's kv_dtype={engine_kv!r} — pass kv_dtype to "
                "PagedGenerationEngine (it owns the pools) or drop it "
                "here")
        validate_kv_quant_combo(engine_kv, speculate=speculate,
                                enable_prefix_cache=enable_prefix_cache)
        self._kv_dtype = engine_kv
        self._engine = engine
        self._max_batch = int(max_batch)
        # resilience plumbing (serving/resilience/): the fault plane is a
        # no-op unless one is given; a supervisor wires itself in through
        # attach_recovery() to turn failures into replays
        self._fault = fault_plane if fault_plane is not None else NULL_PLANE
        self._recovery = None
        self._drain_evt = threading.Event()
        # the degradation ladder's admission ceiling (<= max_batch)
        self._effective_max_batch = self._max_batch
        self._default_timeout = default_timeout_s
        self._metrics = metrics or ServingMetrics()
        # span-based request tracing: completed traces live in the
        # tracer's ring; a standalone core's journey store is private
        self.tracer = Tracer()
        self.replica_name = "core0"
        self._journeys = JourneyStore()
        self._journeys.register(self.replica_name, self.tracer)
        self._queue = RequestQueue(max_depth=max_queue)

        page = self._page = engine.page_size
        cap = engine._max_positions
        self._max_model_len = min(int(max_model_len or cap), cap)
        # every slot's page table has one fixed width, covering the
        # worst-case reservation (prompt + max_new)
        self._max_pages = _round_up(self._max_model_len, page) // page
        self._plen_cap = self._max_pages * page
        budget = int(token_budget or min(self._plen_cap, max(4 * page, 32)))
        # every active row must at least fit its decode token
        budget = max(2, self._max_batch, min(budget, self._plen_cap))
        self._token_budget = budget
        chunk = int(prefill_chunk or budget)
        self._prefill_chunk = max(1, min(chunk, budget))

        engine.refresh_params()
        # prefix_cache_headroom_pages widens the pool beyond the
        # worst-case live reservations (slots x max_pages) without
        # widening any slot's page table: only the radix tree can hold
        # the extra pages, so a full batch need not evict retained
        # prefixes (nor blind the tree's drafts) on admission
        headroom = (max(0, int(prefix_cache_headroom_pages))
                    if enable_prefix_cache else 0)
        self._headroom_pages = headroom
        self._pool = engine.serving_pool(self._max_batch * self._max_pages
                                         + 1 + headroom)
        # scratch page: inactive rows' writes land here, reads of live
        # rows never reach it (attention masks by per-row position)
        self._pool.free(self._max_batch)
        self._pool.reserve(self._max_batch, 1)
        self._scratch = int(self._pool.block_table(self._max_batch)[0])
        self._prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self._pool, page, prefix_cache_watermark)
            if enable_prefix_cache else None)
        # step-level flight recorder, priced by the analytic cost model
        self.steplog = StepLog()
        self._cost_model = StepCostModel(engine, self._pool)

        # in-engine speculative decoding: drafts ride the mixed step as
        # verify rows under leftover budget; the static window W joins
        # the program key, so one program serves every composition
        self._speculate = bool(speculate)
        if self._speculate:
            if int(num_draft_tokens) < 1:
                raise ValueError("num_draft_tokens must be >= 1")
            self._spec_window = max(
                2, min(int(num_draft_tokens) + 1, self._token_budget))
            self._draft_source = resolve_draft_source(
                draft_source, cache=self._prefix_cache)
        else:
            self._spec_window = 1
            self._draft_source = None

        self._slots: List[Optional[dict]] = [None] * self._max_batch
        self.step_trace: List[dict] = []
        self._step_idx = 0
        self._decode_warm = False
        self._step_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._closed = False

    # ------------------------------------------------------------ intake
    @staticmethod
    def batchable(g: GenerationConfig) -> bool:
        """Configs one batch row can host (no beams, no repetition
        penalty)."""
        return g.num_beams == 1 and g.repetition_penalty == 1.0

    @property
    def metrics(self) -> ServingMetrics:
        return self._metrics

    @property
    def active_count(self) -> int:
        with self._step_lock:
            return sum(s is not None for s in self._slots)

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        return self._prefix_cache

    # ------------------------------------------------ resilience surface
    @property
    def max_batch(self) -> int:
        return self._max_batch

    @property
    def effective_max_batch(self) -> int:
        """Slots the scheduler will currently fill (<= max_batch; shrunk
        by the degradation ladder under memory pressure)."""
        with self._step_lock:
            return self._effective_max_batch

    def set_effective_max_batch(self, n: int):
        with self._step_lock:
            self._effective_max_batch = max(1, min(int(n), self._max_batch))

    @property
    def fault_plane(self):
        return self._fault

    def attach_recovery(self, recovery):
        """Wire a recovery protocol (``resilience.EngineSupervisor``) into
        the failure paths: engine failures then replay in-flight requests
        under a retry budget instead of failing them."""
        self._recovery = recovery

    def set_draining(self, draining: bool):
        """While draining, ``submit`` rejects with ``LoadShedError``;
        in-flight requests keep decoding."""
        if draining:
            self._drain_evt.set()
        else:
            self._drain_evt.clear()

    @property
    def draining(self) -> bool:
        return self._drain_evt.is_set()

    def shed_queued(self, min_headroom_s: float) -> int:
        """Degradation-ladder load shedding: reject queued requests whose
        deadline headroom is below ``min_headroom_s`` — under a degraded
        engine they would burn a prefill and miss their deadline anyway."""
        shed = self._queue.shed_low_headroom(time.monotonic(),
                                             min_headroom_s)
        for r in shed:
            self._metrics.on_shed()
            r._finish(RequestState.REJECTED, LoadShedError(
                f"request {r.rid} shed: deadline headroom below "
                f"{min_headroom_s:.2f}s under degraded engine"))
            self._trace_queue_drop(r, RequestState.REJECTED, "load-shed")
        return len(shed)

    def park_for_pressure(self) -> bool:
        """The supervisor's park-before-shed hook: preempting a row into
        the host KV tier.  The tier is not ported yet (ROADMAP.md queue
        1, item 5), so nothing parks and the ladder always advances."""
        return False

    def _kv_quant_info(self) -> Optional[dict]:
        """The ``kv_quant`` section of the metrics snapshot: bytes per
        page of the int8 pools against the fp pools the same config
        would hold.  None (no section) on fp pools."""
        if self._kv_dtype is None:
            return None
        eng = self._engine
        H, D, page, L = (eng._num_heads, eng._head_dim, self._page,
                         eng._num_layers)
        fp_item = eng._cache_dtype.itemsize
        # k+v per layer: int8 payload plus one f32 scale per (page, head)
        payload = 2 * H * page * D
        scale = 2 * H * 4
        q_page = L * (payload + scale)
        fp_page = L * 2 * H * page * D * fp_item
        return {"kv_dtype": self._kv_dtype,
                "bytes_per_page": int(q_page),
                "fp_bytes_per_page": int(fp_page),
                "scale_bytes_per_page": int(L * scale),
                "resident_page_ratio": fp_page / q_page}

    def metrics_snapshot(self) -> dict:
        total = self._pool.num_blocks
        free = self._pool.free_blocks
        resilience = {"effective_max_batch": self.effective_max_batch,
                      "draining": self._drain_evt.is_set(),
                      "faults_injected": self._fault.counts()}
        rec = self._recovery
        if rec is not None:
            resilience.update(rec.health_info())
        else:
            resilience.update({"health_state": "healthy",
                               "health_code": 0})
        # capacity in PAGES (the pool's unit): bytes-derived counts would
        # halve under kv_dtype int8 and misstate admission headroom
        return self._metrics.snapshot(
            resilience=resilience,
            queue_depth=len(self._queue), active=self.active_count,
            max_batch=self._max_batch,
            kv_pool={"total_blocks": int(total), "free_blocks": int(free),
                     "used_blocks": int(total - free),
                     "headroom_pages": int(self._headroom_pages),
                     "occupancy": (total - free) / total if total else 0.0},
            prefix_cache=(self._prefix_cache.stats_snapshot()
                          if self._prefix_cache is not None else None),
            kv_quant=self._kv_quant_info(),
            steplog=self.steplog.summary(),
            # the one device-memory probe (None on the CPU)
            device_memory=memory_stats(self._engine.device),
            journeys=self._journeys.summary())

    # ------------------------------------------------------- trace hooks
    def _trace_end(self, req: Request, state: RequestState):
        """Close the request's trace, finalize its journey (its e2e wall
        partitioned into attribution buckets) and fold the journey into
        the per-tenant metrics."""
        st = _TRACE_STATE.get(state, state.value)
        self.tracer.end(req.rid, st)
        summary = self._journeys.finalize(req.rid, st)
        if summary is not None:
            attained = (state == RequestState.DONE
                        and (req.deadline is None
                             or (req.finished_at or req.arrival)
                             <= req.deadline))
            self._metrics.on_journey(
                tenant=req.tenant, e2e_s=summary["e2e_s"],
                tokens=len(req.tokens), attained=attained,
                buckets=summary["buckets"],
                coverage=summary["coverage"],
                journey_id=summary["journey_id"])

    def _trace_queue_drop(self, req: Request, state: RequestState,
                          reason: str):
        """A request that dies in the queue still gets a full trace: one
        queue_wait span covering its whole life."""
        now = time.monotonic()
        self.tracer.add_span(req.rid, "queue_wait", req.arrival, now,
                             outcome=reason)
        self._trace_end(req, state)

    def _used_pages(self) -> int:
        """Pool pages held by any sequence (slots, scratch, retained
        cache): the step log's resident-KV gauge."""
        return int(self._pool.num_blocks - self._pool.free_blocks)

    def _degraded(self) -> bool:
        return self._effective_max_batch < self._max_batch

    def submit(self, input_ids, config: GenerationConfig = None,
               timeout_s: Optional[float] = None,
               cache_salt: Optional[str] = None,
               tenant: Optional[str] = None) -> List[Request]:
        """Enqueue one request per row of ``input_ids`` ([b, plen] or
        [plen]).  All-or-nothing: admission errors reject the whole
        call.  Returns the per-row ``Request`` handles immediately.
        ``cache_salt`` is the rows' prefix-cache tenant: they share
        cached KV only with requests of the same salt.  ``tenant`` is
        an accounting label (the per-tenant metrics), never a scheduling
        input."""
        if self._closed:
            raise RejectedError("serving engine is closed")
        if self._drain_evt.is_set():
            self._metrics.on_rejected()
            raise LoadShedError("serving engine is draining; retry "
                                "against another replica")
        g = config or GenerationConfig()
        if not self.batchable(g):
            self._metrics.on_rejected()
            raise RejectedError(
                "config not batchable (beams/repetition_penalty); route "
                "through submit_exclusive")
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        rows = []
        for row in ids:
            if row.size == 0:
                row = np.asarray([g.pad_token_id], np.int32)
            if len(row) + g.max_new_tokens > self._max_model_len:
                self._metrics.on_rejected()
                raise RejectedError(
                    f"prompt {len(row)} + max_new {g.max_new_tokens} "
                    f"exceeds max_model_len {self._max_model_len}")
            rows.append(row)
        timeout_s = self._default_timeout if timeout_s is None else timeout_s
        reqs = [Request(row, g, timeout_s=timeout_s, cache_salt=cache_salt,
                        tenant=tenant)
                for row in rows]
        try:
            self._queue.submit_many(reqs)
        except QueueFullError:
            self._metrics.on_rejected_queue_full(len(reqs))
            raise
        self._metrics.on_submitted(len(reqs))
        for req in reqs:
            self.tracer.begin(req.rid, kind="batch",
                              prompt_len=int(req.prompt.size),
                              max_new_tokens=g.max_new_tokens)
            self._journeys.begin(req.rid, self.replica_name, tenant=tenant)
        return reqs

    def submit_exclusive(self, fn,
                         timeout_s: Optional[float] = None) -> Request:
        """Enqueue an arbitrary call to run alone on the scheduler thread,
        FIFO with batch requests: it runs when it reaches the queue head,
        before the next mixed step.  Its return value lands in
        ``req.value``; an exception fails this request only.  The call
        must not use this core's engine (the core owns its sequence
        ids): serve beams or a repetition penalty from another engine,
        such as a dense ``GenerationEngine`` over the same model."""
        if self._closed:
            raise RejectedError("serving engine is closed")
        if self._drain_evt.is_set():
            self._metrics.on_rejected()
            raise LoadShedError("serving engine is draining; retry "
                                "against another replica")
        timeout_s = self._default_timeout if timeout_s is None else timeout_s
        req = Request(None, GenerationConfig(), timeout_s=timeout_s,
                      kind="exclusive", exclusive_fn=fn)
        try:
            self._queue.submit(req)
        except QueueFullError:
            self._metrics.on_rejected_queue_full()
            raise
        self._metrics.on_submitted()
        self.tracer.begin(req.rid, kind="exclusive")
        self._journeys.begin(req.rid, self.replica_name)
        return req

    # ------------------------------------------------------ the step loop
    def run_once(self, wait_s: float = 0.0) -> bool:
        """One scheduler iteration.  Returns True when any request made
        progress; otherwise blocks up to ``wait_s`` for submissions."""
        with self._step_lock:
            return self._run_once_locked(wait_s)

    def _run_once_locked(self, wait_s: float) -> bool:
        now = time.monotonic()
        progressed = False
        for r in self._queue.remove_expired(now):
            self._metrics.on_deadline()
            r._finish(RequestState.CANCELLED, DeadlineExceededError(
                f"request {r.rid} expired after "
                f"{now - r.arrival:.3f}s in queue"))
            self._trace_queue_drop(r, RequestState.CANCELLED,
                                   "deadline-in-queue")
            progressed = True
        for s in list(self._slots):
            if s is not None and s["req"].expired(now):
                self._metrics.on_deadline()
                self._evict(s, RequestState.CANCELLED, DeadlineExceededError(
                    f"request {s['req'].rid} deadline exceeded mid-decode"))
                progressed = True
        while True:
            head = self._queue.peek()
            if head is None or head.kind != "exclusive":
                break
            self._run_exclusive(self._queue.pop())
            progressed = True
        # admission honors the degradation ladder: under memory pressure
        # the supervisor shrinks effective_max_batch below the slot count
        # and the surplus slots stay empty
        while (None in self._slots
               and self.active_count < self._effective_max_batch):
            head = self._queue.peek()
            if head is None or head.kind != "batch":
                break
            req = self._queue.pop()
            if req.expired():
                self._metrics.on_deadline()
                req._finish(RequestState.CANCELLED, DeadlineExceededError(
                    f"request {req.rid} expired in queue"))
                self._trace_queue_drop(req, RequestState.CANCELLED,
                                       "deadline-in-queue")
                continue
            self._admit(req, self._slots.index(None))
            progressed = True
        if self.active_count:
            self._mixed_step()
            progressed = True
        elif not progressed and wait_s > 0:
            self._queue.wait(wait_s)
        return progressed

    # --------------------------------------------------------- admission
    def _plen(self, length: int) -> int:
        # ragged mode pads nothing: reservations are exact
        return max(int(length), 1)

    def _input_fields(self):
        """The mixed step's staged inputs: ``(name, shape, dtype)`` in
        the program's argument order (``samp.*`` are the samp dict)."""
        b, C, P = self._max_batch, self._token_budget, self._max_pages
        fields = [("ids", (b, C), np.int32), ("qlens", (b,), np.int32),
                  ("ctx", (b,), np.int32), ("steps0", (b,), np.int32),
                  ("sample_now", (b,), np.bool_), ("decode", (b,), np.bool_)]
        if self._spec_window > 1:
            fields.append(("spec", (b,), np.bool_))
        fields.append(("tables", (b, P), np.int32))
        fields += [(f"samp.{k}", (b,), dt) for k, dt in _SAMP_FIELDS]
        return fields + [("keys", (b, 2), np.int64), ("scratch", (), np.int32)]

    @staticmethod
    def _program_args(dev, spec_window):
        """The staged device tensors as the program's positional
        arguments after ``params``."""
        samp = {k: dev[f"samp.{k}"] for k, _ in _SAMP_FIELDS}
        head = [dev[n] for n in ("ids", "qlens", "ctx", "steps0",
                                 "sample_now", "decode")]
        if spec_window > 1:
            head.append(dev["spec"])
        return head + [dev["tables"], samp, dev["keys"], dev["scratch"]]

    @staticmethod
    def _fill_samp(h, i, g: GenerationConfig):
        h["samp.temperature"][i] = g.temperature
        h["samp.top_k"][i] = g.top_k or 0
        h["samp.top_p"][i] = g.top_p
        h["samp.min_len"][i] = g.min_length
        h["samp.eos"][i] = -1 if g.eos_token_id is None else g.eos_token_id
        h["samp.do_sample"][i] = g.do_sample
        h["samp.pad"][i] = g.pad_token_id

    def _match_prefix(self, req: Request, tokens: np.ndarray):
        """The radix tree's longest cached prefix of ``tokens`` under the
        request's salt, pinned until ``_release_slot_kv``.  The match is
        capped at ``len(tokens) - 1`` tokens, so a ragged suffix always
        fits the slot's table window."""
        self._fault.fire("prefix.match", rid=req.rid)
        return self._prefix_cache.match(tokens, salt=req.route_salt())

    def _copy_page(self, src: int, dst: int):
        """Copy one physical page across every layer's pools (the
        copy-on-write step for a shared partial tail block): one graph
        for the pool size, ``src`` and ``dst`` staged.  Nothing syncs:
        the step-log record carries the enqueue wall."""
        self._fault.fire("page.copy")
        eng = self._engine
        ckey = ("serve-page-copy", self._pool.num_blocks)
        clog = get_compile_log()
        c0 = clog.count()
        t0 = time.monotonic()
        inputs = eng.program_inputs(ckey, [("src", (1,), np.int32),
                                           ("dst", (1,), np.int32)])
        h = inputs.begin()
        h["src"][0] = src
        h["dst"][0] = dst
        dev = inputs.upload()
        eng.run_paged_program(ckey, lambda: build_page_copy(eng),
                              dev["src"], dev["dst"])
        wall = time.monotonic() - t0
        bts, fl, src_tag = self._cost_model.estimate("page_copy",
                                                     pages_touched=1)
        self.steplog.record(
            "page_copy", wall_s=wall, dispatch_s=wall,
            active_rows=self.active_count,
            resident_kv_pages=self._used_pages(),
            bytes_est=bts, flops_est=fl, cost_source=src_tag,
            compile_events=clog.count() - c0)

    def _stage_prefix(self, sid: int, match, length: int, max_new: int):
        """Map a match onto slot ``sid``'s sequence: copy the partial
        tail into a fresh private block, ``assign`` the shared blocks
        (the sequence takes its own references, so tree eviction never
        yanks them) and reserve fresh pages for the suffix and the new
        tokens.  Under pool pressure the match degrades page by page
        (evicting LRU cache entries first) down to a cold reserve.
        Returns the cached tokens the slot starts from."""
        cache = self._prefix_cache
        pool = self._pool
        page = self._page
        while True:
            cached = match.cached_tokens
            reserve = max(cached + self._plen(length - cached),
                          length + max_new)
            total_pages = -(-reserve // page)
            cache.ensure_free(total_pages - len(match.blocks))
            try:
                cow_dst = None
                if match.partial_block is not None:
                    cow_dst = pool.alloc_block()
                    try:
                        self._copy_page(match.partial_block, cow_dst)
                    except BaseException:
                        pool.unref_block(cow_dst)
                        raise
                    cache.on_cow()
                blocks = list(match.blocks)
                ntok = len(blocks) * page
                if cow_dst is not None:
                    blocks.append(cow_dst)
                    ntok += match.partial_len
                try:
                    if blocks:
                        pool.assign(sid, blocks, ntok)
                finally:
                    if cow_dst is not None:
                        # drop the allocation ref: on success the
                        # sequence holds its own; on failure this frees
                        pool.unref_block(cow_dst)
                pool.reserve(sid, reserve)
                return cached
            except MemoryError:
                pool.free(sid)
                if match.cached_tokens == 0:
                    cache.ensure_free(total_pages)
                    pool.reserve(sid, reserve)
                    return 0
                cache.trim(match, match.cached_tokens - 1)

    def _release_slot_kv(self, sid: int, match, retain_tokens=None,
                         salt=None):
        """The ONE path by which KV blocks leave a slot (admission
        failure, eviction, close): optionally retain the finished
        sequence's pages in the prefix cache (the tree takes its
        references before the sequence drops its own), free the pool
        reservation, unpin the request's match and enforce the cache's
        watermark."""
        cache = self._prefix_cache
        if (cache is not None and retain_tokens is not None
                and len(retain_tokens) > 0):
            cache.insert(retain_tokens, self._pool.block_table(sid),
                         salt=salt)
        self._pool.free(sid)
        if cache is not None:
            if match is not None:
                cache.release(match)
            cache.enforce_watermark()

    def _admit(self, req: Request, sid: int):
        """Stage a request into slot ``sid``: map its cached prefix (if
        the core has a prefix cache), reserve its KV pages and queue the
        uncached suffix as ``pending`` tokens for the next mixed steps,
        starting at ``ctx = cached``.

        A replay (tokens already delivered) re-admits prompt + delivered
        tokens and resumes sampling at step ``emitted``.  Each token
        whose KV the row lacks goes back through the kernel that first
        wrote it: the uncached prompt as ``pending`` chunk rows, which
        sample nothing, then the delivered tokens as decode rows, one a
        step: ``refeed`` unsampled, then ``last_tok``, which samples."""
        admit_t = time.monotonic()
        queued_at = req.requeued_at if req.retries else req.arrival
        self.tracer.add_span(req.rid, "queue_wait", queued_at, admit_t)
        self._metrics.on_queue_wait(admit_t - queued_at)
        c0 = get_compile_log().count()
        g = req.config
        already = req.emitted
        full = (req.prompt if already == 0 else np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)]))
        length = int(full.size)
        budget = g.max_new_tokens - already
        match = None
        try:
            self._fault.fire("kv.alloc", rid=req.rid)
            self._pool.free(sid)
            if self._prefix_cache is not None:
                match = self._match_prefix(req, full)
                cached = self._stage_prefix(sid, match, length, budget)
                prefill_t = time.monotonic()
                self.tracer.add_span(
                    req.rid, "prefix_match", admit_t, prefill_t,
                    cached_tokens=cached, blocks=len(match.blocks),
                    cow=int(match.partial_block is not None))
            else:
                cached = 0
                prefill_t = admit_t
                self._pool.reserve(sid, max(self._plen(length),
                                            length + budget))
        except Exception as e:
            self._admission_failed(req, sid, match, e, admit_t, c0)
            return
        table = np.full((self._max_pages,), self._scratch, np.int32)
        t = self._pool.block_table(sid)[:self._max_pages]
        table[:len(t)] = np.asarray(t, np.int32)
        key = prng.fold_in(prng.PRNGKey(g.seed), req.rid).numpy()
        try:
            # ragged admission stages KV only; the site still fires here
            # so prefill faults route through the admission failure path
            self._fault.fire("prefill.run", rid=req.rid)
        except Exception as e:
            self._admission_failed(
                req, sid, match, e, admit_t, c0,
                prefill_tokens=length - cached,
                prefix_hit_pages=len(match.blocks) if match else 0)
            return
        n_prompt = int(req.prompt.size)
        feed = full[max(cached, n_prompt):]
        req._mark_active()
        self._slots[sid] = {
            "req": req, "sid": sid, "g": g, "length": n_prompt,
            "emitted": already, "table": table, "key": key,
            "match": match, "ctx": cached,
            "pending": full[cached:n_prompt] if cached < n_prompt
            else _NO_TOKENS,
            "last_tok": int(feed[-1]) if already else 0,
            "refeed": feed[:-1] if already else _NO_TOKENS,
            "span_end": prefill_t}

    def _admission_failed(self, req: Request, sid: int, match,
                          err: BaseException, admit_t: float, c0: int,
                          **fields):
        """Pool exhaustion, a failed prefix lookup or page copy, or an
        injected fault at admission: release the slot's KV, record the
        failed ``prefill`` (a span and a step-log record; ``fields`` are
        the suffix and hit pages once the prefix was staged), then let
        recovery decide between a replay and a failure."""
        if not isinstance(err, (MemoryError, InjectedFault)):
            _log.exception("admission of request %d failed", req.rid)
        self._release_slot_kv(sid, match)
        now = time.monotonic()
        self.tracer.add_span(req.rid, "prefill", admit_t, now, slot=sid,
                             outcome="failed")
        self.steplog.record(
            "prefill", wall_s=now - admit_t, host_s=now - admit_t,
            kernel="ragged", active_rows=self.active_count,
            resident_kv_pages=self._used_pages(),
            compile_events=get_compile_log().count() - c0, failed=True,
            retries=req.retries, degraded=self._degraded(), **fields)
        self._admit_failure(req, err)

    # ---------------------------------------------------- failure paths
    def _admit_failure(self, req: Request, err: BaseException):
        """An admission (reservation / prefix / prefill) failed after the
        slot's KV was released.  Route it through the recovery protocol:
        memory pressure feeds the degradation ladder, KV loss restarts
        the engine and replays every in-flight row, and the request
        itself is requeued under its retry budget or failed.  (The
        reference first tries to park a victim into the host KV tier on
        a MemoryError; the port has no tier yet.)"""
        rec = self._recovery
        if getattr(err, "lose_kv", False):
            self._engine.drop_kv_state()
        if rec is not None:
            if isinstance(err, MemoryError):
                # its own ladder — not a crash-streak event
                rec.on_memory_pressure()
            else:
                rec.on_engine_failure(err)
        if self._engine.kv_state_lost():
            self._recover_lost_state(err)
        self._replay_or_fail(req, err)

    def _recover_lost_state(self, err: BaseException):
        """The pools' contents are lost: count an engine restart, replay
        or fail every in-flight row, drop every retained cache page and
        zero the pools in place."""
        self._metrics.on_engine_restart()
        rec = self._recovery
        if rec is not None:
            rec.on_engine_restart()
        # release every slot BEFORE clearing the cache: clear() keeps
        # nodes pinned by live match references, and a node surviving
        # into the zeroed pools would hand replayed rows stale pages
        for s in list(self._slots):
            if s is not None:
                self._replay_or_fail_slot(s, err, kv_intact=False)
        if self._prefix_cache is not None:
            self._prefix_cache.clear()
        # serviced: zero the pools now (no dispatch may come before the
        # next failure, and a stale lost flag would re-enter recovery)
        self._engine.rebuild_kv_state()

    def _replay_or_fail(self, req: Request, err: BaseException):
        """Requeue ``req`` for replay at the queue head if the recovery
        protocol grants a retry; otherwise finish it FAILED (quarantined
        when a retry budget existed and is spent)."""
        rec = self._recovery
        if req.expired():
            self._metrics.on_deadline()
            req._finish(RequestState.CANCELLED, DeadlineExceededError(
                f"request {req.rid} deadline exceeded during recovery"))
            self._trace_end(req, RequestState.CANCELLED)
            return
        if rec is not None and rec.request_should_replay(req, err):
            req._requeue()
            self._metrics.on_retry()
            now = time.monotonic()
            self.tracer.add_span(req.rid, "recovery", now, now,
                                 retry=req.retries,
                                 cause=type(err).__name__)
            self._queue.push_front(req)
            return
        ferr = err
        if rec is not None:
            self._metrics.on_quarantined()
            ferr = QuarantinedError(
                f"request {req.rid} quarantined after {req.retries} "
                f"retries: {err!r}")
        self._metrics.on_failed()
        req._finish(RequestState.FAILED, ferr)
        self._trace_end(req, RequestState.FAILED)

    def _replay_or_fail_slot(self, s: dict, err: BaseException,
                             kv_intact: bool):
        """Slot-holding variant of ``_replay_or_fail``: releases the
        slot's KV first — retaining in the prefix cache the tokens whose
        KV is written when the pages are still valid, so the replay
        computes only the rest."""
        req = s["req"]
        rec = self._recovery
        if req.expired():
            self._metrics.on_deadline()
            self._evict(s, RequestState.CANCELLED, DeadlineExceededError(
                f"request {req.rid} deadline exceeded during recovery"))
            return
        if rec is not None and rec.request_should_replay(req, err):
            self._slots[s["sid"]] = None
            retain = None
            if kv_intact and self._prefix_cache is not None:
                if s["pending"].size:
                    # mid-prefill: the cached prefix plus the chunks
                    # consumed so far; the pending suffix was never
                    # written
                    retain = req.prompt[:s["ctx"]] if s["ctx"] else None
                else:
                    # prompt + the delivered tokens fed so far (the
                    # last token's KV is written by its own decode step)
                    fed = s["emitted"] - 1 - s["refeed"].size
                    retain = np.concatenate(
                        [req.prompt, np.asarray(req.tokens[:fed],
                                                np.int32)])
            self._release_slot_kv(s["sid"], s["match"],
                                  retain_tokens=retain,
                                  salt=req.route_salt())
            req._requeue()
            self._metrics.on_retry()
            now = time.monotonic()
            self.tracer.add_span(req.rid, "recovery", s["span_end"], now,
                                 retry=req.retries,
                                 cause=type(err).__name__)
            self._queue.push_front(req)
            return
        if rec is not None:
            self._metrics.on_quarantined()
            ferr: BaseException = QuarantinedError(
                f"request {req.rid} quarantined after {req.retries} "
                f"retries: {err!r}")
        else:
            ferr = RejectedError(f"in-flight KV state lost: {err!r}")
        self._evict(s, RequestState.FAILED, ferr)

    # -------------------------------------------------- ragged mixed step
    def _mixed_step(self):
        """ONE ragged step whatever the batch composition: decode rows
        feed their last token (query_len 1) and are packed first, prompt
        rows feed their next ``prefill_chunk``-sized slice, all under
        the per-step ``token_budget``."""
        active = [s for s in self._slots if s is not None]
        b = self._max_batch
        C = self._token_budget
        eng = self._engine
        W = self._spec_window
        mkey = ("serve-step", b, C, self._max_pages, self._pool.num_blocks)
        if W > 1:
            mkey = mkey + (W,)
        # every per-step array is written straight into the key's staged
        # buffer (pinned on the card), which one copy moves to the device
        inputs = eng.program_inputs(mkey, self._input_fields())
        h = inputs.begin()
        ids, qlens, ctx = h["ids"], h["qlens"], h["ctx"]
        steps0, sample_now = h["steps0"], h["sample_now"]
        h["tables"].fill(self._scratch)
        h["samp.temperature"].fill(1.0)
        h["samp.top_p"].fill(1.0)
        h["samp.eos"].fill(-1)
        h["scratch"][()] = self._scratch
        decode_rows = [s for s in active if s["pending"].size == 0]
        chunk_rows = [s for s in active if s["pending"].size > 0]
        budget = C
        chunk_taken = {}
        for s in decode_rows:
            i = s["sid"]
            feed = s["refeed"]
            if feed.size:
                # a replay feeds back a delivered token whose KV was
                # lost, through the decode kernel that first wrote it,
                # and samples nothing
                ids[i, 0] = feed[0]
                ctx[i] = s["length"] + s["emitted"] - 1 - feed.size
            else:
                ids[i, 0] = s["last_tok"]
                # the fed token's KV lands at length + emitted - 1
                ctx[i] = s["length"] + s["emitted"] - 1
                sample_now[i] = True
            qlens[i] = 1
            steps0[i] = s["emitted"]
            h["decode"][i] = True
            h["tables"][i] = s["table"]
            h["keys"][i] = s["key"]
            self._fill_samp(h, i, s["g"])
            budget -= 1
        for s in chunk_rows:
            i = s["sid"]
            n = min(self._prefill_chunk, budget, int(s["pending"].size))
            if n <= 0:
                continue        # budget spent: the row waits this step
            ids[i, :n] = s["pending"][:n]
            qlens[i] = n
            ctx[i] = s["ctx"]
            steps0[i] = s["emitted"]
            # only the chunk holding the prompt's last token samples,
            # and a replay's never (its next token follows the
            # delivered ones)
            sample_now[i] = (n == int(s["pending"].size)
                             and s["emitted"] == 0)
            h["tables"][i] = s["table"]
            h["keys"][i] = s["key"]
            self._fill_samp(h, i, s["g"])
            budget -= n
            chunk_taken[i] = n
        drafted = self._pack_drafts(decode_rows, h, budget)
        kind = ("mixed" if chunk_taken and decode_rows else
                ("prefill" if chunk_taken else "decode"))
        draft_tokens = sum(drafted.values())
        prefill_tokens = sum(chunk_taken.values())
        clog = get_compile_log()
        c0 = clog.count()
        t0 = time.monotonic()
        n_emit = None
        try:
            fault = self._fault.fire(
                "decode.step", rids=[s["req"].rid for s in active])
            args = self._program_args(inputs.upload(), W)
            out = eng.run_paged_program(
                mkey, lambda: build_mixed_step(eng, b, C, self._max_pages,
                                               spec_window=W), *args)
            # the one designed sync per step (plus n_emit under
            # speculation)
            if W > 1:
                tok, n_emit, fin_out = (_host(t) for t in out)
            else:
                tok, fin_out = (_host(t) for t in out)
        except Exception as e:
            self._metrics.on_failed(0)
            # only an injection raised before the dispatch provably
            # leaves the pools intact; any other failure may have
            # written them mid-step, so every row's KV is suspect
            injected = isinstance(e, (InjectedFault, InjectedMemoryError))
            if not injected:
                _log.exception("mixed step failed")
            self.steplog.record(
                kind, wall_s=time.monotonic() - t0,
                active_rows=len(active), decode_rows=len(decode_rows),
                chunk_steps=1, prefill_tokens=prefill_tokens,
                prefill_chunk_tokens=prefill_tokens, kernel="ragged",
                resident_kv_pages=self._used_pages(),
                compile_events=clog.count() - c0, faults=injected,
                retries=sum(s["req"].retries for s in active),
                failed=True, degraded=self._degraded(),
                draft_tokens=draft_tokens, spec_rows=len(drafted))
            if getattr(e, "lose_kv", False) or not injected:
                self._engine.drop_kv_state()
            rec = self._recovery
            if rec is not None:
                rec.on_engine_failure(e)
            if self._engine.kv_state_lost():
                self._recover_lost_state(e)
            else:
                for s in list(self._slots):
                    if s is not None:
                        self._replay_or_fail_slot(s, e, kv_intact=True)
            return
        # the step's wall ends with its readback: the device time plus
        # the launch, never the recording below
        t_sync = time.monotonic()
        wall = t_sync - t0
        if not self._decode_warm:
            # one graph for EVERY composition: after this, any capture on
            # the serving-decode site is a recompile
            clog.mark_warm("serving-decode", mkey)
            self._decode_warm = True
        resident = self._used_pages()
        prefix_hits = sum(len(s["match"].blocks) for s in active
                          if s["match"] is not None)
        # injected NaN/inf logits poison the whole row (sampled or
        # mid-chunk): it is quarantined below, the batch goes on
        poisoned = set(fault["nan_rids"]) if fault else set()
        self._step_idx += 1
        emitted_decode = 0
        emitted_prefill = 0
        draft_accepted = 0
        evicted = []
        now = time.monotonic()
        span_name = ("prefill" if self._prefix_cache is None
                     else "suffix_prefill")
        for s in active:
            i = s["sid"]
            req = s["req"]
            if qlens[i] == 0:
                continue            # starved chunk row: untouched
            if i in chunk_taken:
                s["pending"] = s["pending"][chunk_taken[i]:]
                s["ctx"] += chunk_taken[i]
            elif s["refeed"].size:
                s["refeed"] = s["refeed"][1:]
            # a speculative step emits the row's accepted window (at
            # least one token when it sampled)
            t_row = (tok[i:i + 1] if n_emit is None
                     else tok[i, :int(n_emit[i])])
            if not sample_now[i]:
                t_row = t_row[:0]   # mid-prompt chunk or refeed: no emit
            if req.rid in poisoned or (t_row.size and int(t_row.min()) < 0):
                self._metrics.on_quarantined()
                self._evict(s, RequestState.FAILED, QuarantinedError(
                    f"request {req.rid} quarantined: non-finite logits "
                    f"in mixed step {self._step_idx}"))
                evicted.append(req.rid)
                continue
            if i in chunk_taken:
                self.tracer.add_span(
                    req.rid, span_name, s["span_end"], now, slot=i,
                    plen=chunk_taken[i],
                    cached_tokens=int(s["ctx"]) - chunk_taken[i],
                    replay=req.retries)
            else:
                self.tracer.add_span(req.rid, "decode", s["span_end"], now,
                                     step=self._step_idx, chunk_steps=1,
                                     tokens=int(t_row.size))
            s["span_end"] = now
            if not t_row.size:
                continue
            if i in chunk_taken:
                # prefill complete: this chunk held the prompt's last
                # token and sampled the row's first token
                self._metrics.on_prefill(now - req.arrival)
                self._metrics.on_tokens(int(t_row.size))
                emitted_prefill += int(t_row.size)
            else:
                emitted_decode += int(t_row.size)
                if i in drafted:
                    draft_accepted += max(int(t_row.size) - 1, 0)
            req._emit(t_row)
            s["emitted"] += int(t_row.size)
            s["last_tok"] = int(t_row[-1])
            if bool(fin_out[i]) or s["emitted"] >= s["g"].max_new_tokens:
                self._evict(s, RequestState.DONE)
                evicted.append(req.rid)
        if emitted_decode:
            self._metrics.on_tokens(emitted_decode, itl_s=wall)
        if drafted:
            self._metrics.on_spec(rows=len(drafted), proposed=draft_tokens,
                                  accepted=draft_accepted)
        self._metrics.on_step(wall * 1e3, len(active), b)
        self.step_trace.append({
            "step": self._step_idx, "active": [s["req"].rid for s in active],
            "decode_rows": len(decode_rows),
            "prefill_tokens": prefill_tokens,
            "draft_tokens": draft_tokens,
            "draft_accepted": draft_accepted,
            "evicted": evicted, "wall_s": wall})
        # verify rows are priced at their true query_len: each draft
        # token is one more processed position
        n_tokens = len(decode_rows) + prefill_tokens + draft_tokens
        bts, fl, src_tag = self._cost_model.estimate(
            kind, rows=len(active), pages_touched=resident, chunk=1,
            tokens=n_tokens)
        ici, ici_saved = self._cost_model.interconnect(n_tokens)
        end = time.monotonic()
        # the planner fields (planned_tokens, planned_chunk_cap,
        # predicted_wall_s) and the host-tier fields (parked_rows,
        # host_pages) keep their defaults until the SLO scheduler and
        # the host KV tier are ported
        self.steplog.record(
            kind, wall_s=end - t0, dispatch_s=t_sync - t0,
            host_s=end - t_sync, active_rows=len(active),
            decode_rows=len(decode_rows), chunk_steps=1,
            prefill_tokens=prefill_tokens,
            prefill_chunk_tokens=prefill_tokens, kernel="ragged",
            emitted_tokens=emitted_decode + emitted_prefill,
            resident_kv_pages=resident, prefix_hit_pages=prefix_hits,
            bytes_est=bts, flops_est=fl, ici_bytes_est=ici,
            ici_bytes_saved_est=ici_saved, cost_source=src_tag,
            compile_events=clog.count() - c0, faults=fault is not None,
            retries=sum(s["req"].retries for s in active),
            degraded=self._degraded(), draft_tokens=draft_tokens,
            draft_accepted=draft_accepted, spec_rows=len(drafted))
        if self._recovery is not None:
            self._recovery.on_step_ok()

    def _pack_drafts(self, decode_rows, h, budget):
        """Speculative drafts, from leftover budget only, so decode
        packing and prefill pacing are those of ``speculate=False``.  A
        row's drafts stay inside its pool reservation (``k <= remaining
        - 1``) and the window (``k <= W - 1``); sampled rows take
        history-deterministic proposals only.  Writes the drafts into the
        staged ``ids``/``qlens``/``spec`` in place; returns ``{slot:
        k}``."""
        drafted = {}
        if not self._speculate:
            return drafted
        ids, qlens, spec = h["ids"], h["qlens"], h["spec"]
        W = self._spec_window
        for s in decode_rows:
            if budget <= 0:
                break
            if s["refeed"].size:
                continue            # a replay's unsampled feed drafts nothing
            i = s["sid"]
            req = s["req"]
            k_cap = min(W - 1, s["g"].max_new_tokens - s["emitted"] - 1,
                        budget)
            if k_cap <= 0:
                continue
            history = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
            proposal = self._draft_source.propose(
                history, k_cap, salt=req.route_salt(),
                deterministic_only=bool(s["g"].do_sample))
            k_row = min(len(proposal), k_cap)
            if k_row <= 0:
                continue
            ids[i, 1:1 + k_row] = np.asarray(proposal[:k_row], np.int32)
            qlens[i] = 1 + k_row
            spec[i] = True
            budget -= k_row
            drafted[i] = k_row
        return drafted

    # ---------------------------------------------------------- eviction
    def _evict(self, slot: dict, state: RequestState,
               err: Optional[BaseException] = None):
        self._slots[slot["sid"]] = None
        req = slot["req"]
        # retain-on-finish: a DONE row's prompt + emitted tokens but the
        # last (its KV is never written) hold valid KV in the row's
        # pages; donate them to the prefix cache.  A cancelled or failed
        # row may hold partial or garbage KV and is never retained.
        retain = None
        if state == RequestState.DONE and self._prefix_cache is not None:
            retain = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        pages = len(self._pool.block_table(slot["sid"]))
        t0 = time.monotonic()
        self._release_slot_kv(slot["sid"], slot["match"],
                              retain_tokens=retain, salt=req.route_salt())
        wall = time.monotonic() - t0
        bts, fl, src_tag = self._cost_model.estimate("evict",
                                                     pages_touched=pages)
        self.steplog.record(
            "evict", wall_s=wall, host_s=wall,
            active_rows=self.active_count, pages_freed=pages,
            resident_kv_pages=self._used_pages(),
            bytes_est=bts, flops_est=fl, cost_source=src_tag,
            failed=state == RequestState.FAILED, retries=req.retries,
            degraded=self._degraded())
        req._finish(state, err)
        now = time.monotonic()
        self.tracer.add_span(req.rid, "evict", slot["span_end"], now,
                             outcome=_TRACE_STATE.get(state, state.value))
        self._trace_end(req, state)
        if state == RequestState.DONE:
            self._metrics.on_completed(time.monotonic() - req.arrival)
        elif state == RequestState.FAILED:
            self._metrics.on_failed()

    def _run_exclusive(self, req: Request):
        if req.expired():
            self._metrics.on_deadline()
            req._finish(RequestState.CANCELLED, DeadlineExceededError(
                f"request {req.rid} expired in queue"))
            self._trace_queue_drop(req, RequestState.CANCELLED,
                                   "deadline-in-queue")
            return
        start = time.monotonic()
        self.tracer.add_span(req.rid, "queue_wait", req.arrival, start)
        self._metrics.on_queue_wait(start - req.arrival)
        req._mark_active()
        try:
            req.value = req.exclusive_fn()
        except Exception as e:
            self._metrics.on_failed()
            req._finish(RequestState.FAILED, e)
            self.tracer.add_span(req.rid, "exclusive", start,
                                 time.monotonic(), outcome="failed")
            self._trace_end(req, RequestState.FAILED)
            return
        req._finish(RequestState.DONE)
        self._metrics.on_completed(time.monotonic() - req.arrival)
        self.tracer.add_span(req.rid, "exclusive", start, time.monotonic())
        self._trace_end(req, RequestState.DONE)

    # ---------------------------------------------------- thread control
    def start(self) -> "EngineCore":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serving-engine-core", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        backoff = 0.01
        while not self._stop_evt.is_set():
            try:
                self.run_once(wait_s=0.02)
                backoff = 0.01
            except Exception:
                # requests fail individually; the loop must outlive one
                # bad step — but not silently, and not spinning hot
                self._metrics.on_loop_exception()
                _log.exception("serving loop step failed (backing off "
                               "%.3fs)", backoff)
                self._stop_evt.wait(backoff)
                backoff = min(backoff * 2.0, 1.0)

    def stop(self, timeout: float = 10.0) -> bool:
        """Signal and join the loop thread.  True when it is down (or
        was never started)."""
        if self._thread is None:
            return True
        self._stop_evt.set()
        t, self._thread = self._thread, None
        t.join(timeout)
        return not t.is_alive()

    def close(self, timeout: float = 10.0):
        """Stop the loop, cancel everything in flight and release every
        pool reservation (scratch and retained prefixes included)."""
        if self._closed:
            return
        self._closed = True
        stopped = self.stop(timeout)
        if not self._step_lock.acquire(timeout=(max(timeout, 0.1)
                                                if stopped else 2.0)):
            # a step is wedged: unblock consumers without touching the
            # pool the step still owns
            for r in self._queue.drain():
                r._finish(RequestState.REJECTED, RejectedError(
                    "serving engine closed (scheduler wedged)"))
                self._trace_queue_drop(r, RequestState.REJECTED,
                                       "engine-closed")
            for s in list(self._slots):
                if s is not None:
                    s["req"]._finish(RequestState.FAILED, RejectedError(
                        "serving engine closed while a step was wedged"))
                    self._trace_end(s["req"], RequestState.FAILED)
            return
        try:
            for r in self._queue.drain():
                r._finish(RequestState.REJECTED,
                          RejectedError("serving engine closed"))
                self._trace_queue_drop(r, RequestState.REJECTED,
                                       "engine-closed")
            for s in list(self._slots):
                if s is not None:
                    self._evict(s, RequestState.CANCELLED,
                                RejectedError("serving engine closed"))
            if self._prefix_cache is not None:
                self._prefix_cache.clear()
            self._pool.free(self._max_batch)
            # the key's graph and staging buffers go with the core
            self._engine.release_graphs()
        finally:
            self._step_lock.release()
