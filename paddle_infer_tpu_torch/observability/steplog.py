"""StepLog — the step-level flight recorder for the serving scheduler.

Port of ``paddle_infer_tpu/observability/steplog.py``.  Request traces
(``observability/tracing``) attribute one *request's* wall time; this
records what one *scheduler step* cost and why: batch composition,
resident KV pages, the bytes the step analytically must move, and the
measured wall split into device dispatch against host bookkeeping.

``serving.EngineCore`` appends one record per step event (a mixed,
prefill-only or decode-only ragged step, a page copy, an evict) into a
bounded ring with a fixed schema (``SCHEMA_KEYS``, the reference's
names and defaults).  ``to_jsonl()`` exports the ring and ``summary()``
folds it into Prometheus-ready aggregates plus a rolling
model-against-measured error: the analytic bytes estimate is fitted to
measured decode walls by one least-bias scale (Σwall/Σbytes, the one
free parameter a bandwidth model has), then scored by mean absolute
relative error and Pearson correlation.

``StepCostModel`` prices a step.  The reference first asks XLA for the
program's ``cost_analysis()``; the port has no XLA, so its engine has
no ``program_cost`` and every estimate takes the reference's analytic
fallback (``cost_source == "analytic"``): the weight bytes once per
step plus the KV pages the step touches, and 2 FLOPs per parameter per
query token.  On one device the interconnect, MoE and LoRA terms are
zero.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .stable import sorted_tree

# one entry per record field: (key, default).  Every record carries
# every key — consumers (JSONL, /steps, bench) never need .get chains.
_SCHEMA = (
    ("seq", 0),                  # monotone record index (process-local)
    ("ts", 0.0),                 # wall-clock capture time (time.time())
    ("kind", ""),                # prefill | decode | mixed | page_copy
                                 # | evict
    ("kernel", ""),              # ragged | legacy (step-serving records)
    ("wall_s", 0.0),             # whole step event, edge to edge
    ("dispatch_s", 0.0),         # device dispatch + readback sync
    ("host_s", 0.0),             # wall_s - dispatch_s (host bookkeeping)
    ("active_rows", 0),          # occupied slots at capture
    ("decode_rows", 0),          # rows in this fused decode chunk
    ("prefill_tokens", 0),       # uncached suffix tokens prefetched
    ("prefill_chunk_tokens", 0),  # prompt tokens chunked into this
                                  # ragged mixed step
    ("chunk_steps", 0),          # fused scan steps (decode) / 1
    ("emitted_tokens", 0),       # tokens delivered to consumers
    ("resident_kv_pages", 0),    # pool pages in use at capture
    ("prefix_hit_pages", 0),     # pages served from the prefix cache
    ("pages_freed", 0),          # pages released (evict records)
    ("bytes_est", 0.0),          # analytic bytes-moved estimate
    ("flops_est", 0.0),          # analytic FLOPs estimate
    ("ici_bytes_est", 0.0),      # analytic interconnect bytes (mp
                                 # all-reduces; 0 single-device)
    ("ici_bytes_saved_est", 0.0),  # interconnect bytes the quantized
                                   # wire format saved vs fp
    ("cost_source", "none"),     # xla+pages | analytic | none
    ("compile_events", 0),       # CompileLog events during the step
    ("faults", False),           # fault plane fired during the step
    ("retries", 0),              # replayed rows involved in the step
    ("degraded", False),         # effective_max_batch < max_batch
    ("failed", False),           # the step raised / the row failed
    ("draft_tokens", 0),         # speculative draft tokens verified
    ("draft_accepted", 0),       # drafts accepted (extra tokens won)
    ("spec_rows", 0),            # rows that carried drafts this step
    ("adapter_rows", 0),         # rows decoding under a non-identity
                                 # LoRA adapter slot this step
    ("moe_tokens_routed", 0),    # valid token-expert assignments kept
                                 # this step (summed over moe layers)
    ("moe_tokens_dropped", 0),   # valid assignments lost to capacity
                                 # overflow (NEVER silent)
    ("moe_aux_loss", 0.0),       # gate load-balance aux loss (mean
                                 # across moe layers)
    ("planned_tokens", 0),       # tokens the StepPlanner chose to pack
    ("planned_chunk_cap", 0),    # per-row prompt-chunk cap this step
    ("predicted_wall_s", 0.0),   # planner's predicted step wall (0.0
                                 # while the fit is cold)
    ("parked_rows", 0),          # requests parked in the host KV tier
                                 # at capture
    ("host_pages", 0),           # host-tier pages resident at capture
                                 # (parked KV + demoted prefix blocks)
    ("grammar_rows", 0),         # grammar-constrained rows that sampled
                                 # through a mask this step
    ("masked_tokens", 0),        # vocab entries the grammar masks banned
                                 # across those rows this step
)
SCHEMA_KEYS = tuple(k for k, _ in _SCHEMA)


class StepCostModel:
    """Analytic per-step cost estimates for one engine's programs: the
    weight bytes per step plus the bytes of the KV pages a step reads
    or writes.  Sizing constants come from the engine at construction
    time; the weights are summed at the first estimate.  ``pool`` (the
    core's block pool) is taken for the reference's signature: without a
    compiled cost to rescale, nothing here reads its size."""

    def __init__(self, engine, pool=None):
        self._engine = engine
        # one physical page across every layer's K and V pools.  An int8
        # pool prices its 1-byte payload plus the per-page float32
        # scales (one per page per head, k and v); fp pools the item
        # size of their torch dtype
        if getattr(engine, "_kv_dtype", None) == "int8":
            payload_itemsize = 1
            scale_bytes = engine._num_layers * 2 * engine._num_heads * 4
        else:
            payload_itemsize = engine._cache_dtype.itemsize
            scale_bytes = 0
        self._page_kv_bytes = float(
            engine._num_layers * 2 * engine._num_heads
            * engine.page_size * engine._head_dim * payload_itemsize
            + scale_bytes)
        self._weight_bytes: Optional[float] = None
        self._n_params: Optional[float] = None

    @property
    def page_kv_bytes(self) -> float:
        return self._page_kv_bytes

    def _weights(self):
        """``(weight bytes, parameter count)`` of the engine's parameter
        snapshot.  ``named_parameters()`` lists a tied tensor once, as
        the reference's JAX tree holds it once."""
        if self._weight_bytes is None:
            params = list(self._engine._params.values())
            self._weight_bytes = float(
                sum(p.numel() * p.element_size() for p in params))
            self._n_params = float(sum(p.numel() for p in params))
        return self._weight_bytes, self._n_params

    def interconnect(self, tokens: int):
        """``(ici_bytes_est, ici_bytes_saved_est)`` of one step: the port
        serves on one device, so no collective moves a byte (the
        tensor-parallel and expert-parallel terms come with the sharded
        serving plane)."""
        return 0.0, 0.0

    def estimate(self, kind: str, *, rows: int = 1,
                 pages_touched: int = 0, chunk: int = 1,
                 tokens: Optional[int] = None):
        """Return ``(bytes_est, flops_est, cost_source)`` for one step
        event.  ``pages_touched`` is the KV pages the step reads or
        writes (resident pages for a step — every query token re-reads
        its row's share; the reservation for prefill; freed pages for
        evict); ``tokens`` the query tokens the step computes."""
        pages = max(0, int(pages_touched))
        if kind == "evict":
            # host-only: no HBM traffic, but the freed KV bytes are the
            # memory-attribution signal the record exists to carry
            return pages * self._page_kv_bytes, 0.0, "analytic"
        if kind == "page_copy":
            # one page read + one page written, across all layers
            return 2.0 * max(pages, 1) * self._page_kv_bytes, 0.0, \
                "analytic"
        if kind == "mixed":
            # ragged mixed launch: every query token (decode rows
            # contribute 1, prefill rows their chunk) streams its row's
            # resident page window once — price it as query tokens ×
            # per-row resident pages (the even split of the step's
            # resident set across occupied rows)
            per_row_pages = pages / max(rows, 1)
            kv_moved = (max(int(tokens if tokens is not None else rows), 1)
                        * per_row_pages * self._page_kv_bytes)
        elif kind == "decode":
            # every query token re-streams its row's page window, so
            # decode is priced per token: tokens / rows positions per
            # row (a speculative verify row at its true query_len)
            ntok_kv = float(tokens if tokens is not None
                            else rows * chunk)
            kv_moved = (pages * self._page_kv_bytes
                        * max(ntok_kv, 1.0) / max(rows, 1))
        else:
            kv_moved = pages * self._page_kv_bytes
        wb, n_params = self._weights()
        ntok = float(tokens if tokens is not None else rows * chunk)
        steps = chunk if kind == "decode" else 1
        bytes_est = wb * steps + kv_moved
        flops_est = 2.0 * n_params * ntok
        return bytes_est, flops_est, "analytic"


def _model_summary(pairs: List[tuple]) -> Dict:
    """Fit analytic bytes to measured wall with one scale and score it.
    ``pairs`` is [(bytes_est, wall_s), ...] for clean decode steps."""
    n = len(pairs)
    out: Dict = {"n": n, "scale_s_per_byte": None,
                 "mean_abs_rel_err": None, "max_abs_rel_err": None,
                 "pearson_r": None}
    if n < 2:
        return out
    xs = [p[0] for p in pairs]
    ys = [p[1] for p in pairs]
    sx, sy = sum(xs), sum(ys)
    if sx <= 0.0 or sy <= 0.0:
        return out
    scale = sy / sx
    errs = [abs(x * scale - y) / y for x, y in pairs if y > 0.0]
    if errs:
        out["scale_s_per_byte"] = scale
        out["mean_abs_rel_err"] = sum(errs) / len(errs)
        out["max_abs_rel_err"] = max(errs)
    mx, my = sx / n, sy / n
    vxy = sum((x - mx) * (y - my) for x, y in pairs)
    vx = sum((x - mx) ** 2 for x in xs)
    vy = sum((y - my) ** 2 for y in ys)
    if vx > 0.0 and vy > 0.0:
        r = vxy / math.sqrt(vx * vy)
        out["pearson_r"] = min(1.0, max(-1.0, r))
    return out


class StepLog:
    """Bounded ring of per-step records with JSONL export and a rolling
    model-vs-measured summary.  Thread-safe: the scheduler appends from
    its step thread while HTTP handlers read ``records()``/``summary()``.
    """

    def __init__(self, capacity: int = 4096, model_window: int = 1024):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._total = 0
        self._by_kind: Dict[str, int] = {}
        self._bytes_total = 0.0
        self._flops_total = 0.0
        self._ici_bytes_total = 0.0
        self._ici_saved_total = 0.0
        self._compile_total = 0
        self._chunk_tokens_total = 0
        self._draft_tokens_total = 0
        self._draft_accepted_total = 0
        self._moe_routed_total = 0
        self._moe_dropped_total = 0
        self._adapter_rows_total = 0
        self._grammar_rows_total = 0
        self._masked_tokens_total = 0
        self._by_kernel: Dict[str, int] = {}
        # (bytes_est, wall_s) for clean decode chunks — the model fit
        self._model: deque = deque(maxlen=int(model_window))
        # (predicted_wall_s, wall_s) for clean planned steps — scores
        # the StepPlanner's per-step wall prediction
        self._planner: deque = deque(maxlen=int(model_window))
        # (prefill_chunk_tokens, wall_s) for clean prefill-carrying
        # steps — calibrates prefill s/token for admission predictions
        self._prefill: deque = deque(maxlen=int(model_window))

    def record(self, kind: str, **fields) -> dict:
        """Append one record; unknown fields are a programming error
        (the schema is a contract with /steps consumers and the docs
        table), missing fields take their schema defaults."""
        unknown = set(fields) - set(SCHEMA_KEYS)
        if unknown:
            raise ValueError(f"unknown StepLog fields: {sorted(unknown)}")
        rec = dict(_SCHEMA)
        rec.update(fields)
        rec["kind"] = str(kind)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            rec["ts"] = time.time()
            self._ring.append(rec)
            self._total += 1
            self._by_kind[rec["kind"]] = \
                self._by_kind.get(rec["kind"], 0) + 1
            self._bytes_total += float(rec["bytes_est"])
            self._flops_total += float(rec["flops_est"])
            self._ici_bytes_total += float(rec["ici_bytes_est"])
            self._ici_saved_total += float(rec["ici_bytes_saved_est"])
            self._compile_total += int(rec["compile_events"])
            self._chunk_tokens_total += int(rec["prefill_chunk_tokens"])
            self._draft_tokens_total += int(rec["draft_tokens"])
            self._draft_accepted_total += int(rec["draft_accepted"])
            self._moe_routed_total += int(rec["moe_tokens_routed"])
            self._moe_dropped_total += int(rec["moe_tokens_dropped"])
            self._adapter_rows_total += int(rec["adapter_rows"])
            self._grammar_rows_total += int(rec["grammar_rows"])
            self._masked_tokens_total += int(rec["masked_tokens"])
            if rec["kernel"]:
                self._by_kernel[rec["kernel"]] = \
                    self._by_kernel.get(rec["kernel"], 0) + 1
            if rec["kind"] == "decode" and not rec["failed"] \
                    and rec["bytes_est"] > 0.0 and rec["wall_s"] > 0.0:
                self._model.append((float(rec["bytes_est"]),
                                    float(rec["wall_s"])))
            if not rec["failed"] and rec["predicted_wall_s"] > 0.0 \
                    and rec["wall_s"] > 0.0:
                self._planner.append((float(rec["predicted_wall_s"]),
                                      float(rec["wall_s"])))
            if not rec["failed"] and rec["prefill_chunk_tokens"] > 0 \
                    and rec["wall_s"] > 0.0:
                self._prefill.append((int(rec["prefill_chunk_tokens"]),
                                      float(rec["wall_s"])))
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self, limit: Optional[int] = None) -> List[dict]:
        """Most recent ``limit`` records, oldest first (the whole ring
        when limit is None)."""
        with self._lock:
            recs = list(self._ring)
        if limit is not None and limit >= 0:
            recs = recs[-limit:] if limit else []
        return [dict(r) for r in recs]

    def to_jsonl(self, limit: Optional[int] = None) -> str:
        recs = self.records(limit)
        if not recs:
            return ""
        return "\n".join(json.dumps(r, sort_keys=True)
                         for r in recs) + "\n"

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._model.clear()
            self._planner.clear()
            self._prefill.clear()
            self._by_kind = {}
            self._total = 0
            self._bytes_total = 0.0
            self._flops_total = 0.0
            self._ici_bytes_total = 0.0
            self._ici_saved_total = 0.0
            self._compile_total = 0
            self._chunk_tokens_total = 0
            self._draft_tokens_total = 0
            self._draft_accepted_total = 0
            self._moe_routed_total = 0
            self._moe_dropped_total = 0
            self._adapter_rows_total = 0
            self._grammar_rows_total = 0
            self._masked_tokens_total = 0
            self._by_kernel = {}

    def calibration(self) -> Dict:
        """Rolling fits the scheduler plans and admits from: the decode
        Σwall/Σbytes scale, the mean clean decode step wall, and
        prefill seconds per chunked prompt token.  Keys are None until
        there are samples; the scheduler's readiness gates (see
        ``serving.sched.StepCalibration``) decide when to trust them."""
        with self._lock:
            model = list(self._model)
            prefill = list(self._prefill)
        out: Dict = {"scale_s_per_byte": None, "decode_step_s": None,
                     "prefill_s_per_token": None,
                     "n_decode": len(model), "n_prefill": len(prefill)}
        if model:
            sx = sum(p[0] for p in model)
            sy = sum(p[1] for p in model)
            if sx > 0.0 and sy > 0.0:
                out["scale_s_per_byte"] = sy / sx
            out["decode_step_s"] = sy / len(model)
        if prefill:
            st = sum(p[0] for p in prefill)
            sw = sum(p[1] for p in prefill)
            if st > 0 and sw > 0.0:
                out["prefill_s_per_token"] = sw / st
        return out

    def summary(self) -> Dict:
        with self._lock:
            pairs = list(self._model)
            planner = list(self._planner)
            out = {
                "records": self._total,
                "ring": len(self._ring),
                "capacity": self.capacity,
                "by_kind": dict(self._by_kind),
                "by_kernel": dict(self._by_kernel),
                "bytes_est_total": self._bytes_total,
                "flops_est_total": self._flops_total,
                "ici_bytes_est_total": self._ici_bytes_total,
                "ici_bytes_saved_total": self._ici_saved_total,
                "compile_events_total": self._compile_total,
                "prefill_chunk_tokens_total": self._chunk_tokens_total,
                "draft_tokens_total": self._draft_tokens_total,
                "draft_accepted_total": self._draft_accepted_total,
                "moe_tokens_routed_total": self._moe_routed_total,
                "moe_tokens_dropped_total": self._moe_dropped_total,
                "adapter_rows_total": self._adapter_rows_total,
                "grammar_rows_total": self._grammar_rows_total,
                "masked_tokens_total": self._masked_tokens_total,
            }
        out["decode_model"] = _model_summary(pairs)
        # predicted-vs-measured step wall for planner-annotated steps
        errs = [abs(p - w) / w for p, w in planner if w > 0.0]
        out["planner_model"] = {
            "n": len(errs),
            "mean_abs_rel_err": (sum(errs) / len(errs)) if errs else None,
            "max_abs_rel_err": max(errs) if errs else None,
        }
        return sorted_tree(out)
