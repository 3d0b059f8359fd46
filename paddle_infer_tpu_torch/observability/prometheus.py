"""Prometheus text-exposition renderer for the serving metrics snapshot.

``ServingMetrics.snapshot()`` stays the JSON source of truth (nested
dicts, ``None`` for empty percentiles); this module flattens it into
the Prometheus text format (version 0.0.4): one ``# HELP``/``# TYPE``
header per family, one sample line per series, reservoir stats as a
``stat`` label, per-site compile counts as a ``site`` label.  ``None``
values are dropped rather than rendered as NaN so a fresh server
scrapes clean.

Latency distributions (TTFT, ITL, e2e, step wall, queue wait) are
exposed as *native histogram families* — cumulative ``_bucket`` lines
with a terminal ``le="+Inf"``, plus ``_sum``/``_count`` — built from
``observability.histogram`` snapshots under ``snapshot["histograms"]``.
Percentile gauges for those series are gone from the exposition (the
reservoir ``*_recent`` keys stay in the JSON snapshot for bench);
``validate_exposition`` enforces the histogram contract: cumulative
bucket counts, a ``+Inf`` bucket, ``_count`` consistent with it, and
no bare-named samples on a histogram family.

Port of ``paddle_infer_tpu/observability/prometheus.py``, copied whole:
family names, types and help texts are the reference's, so a dashboard
or a benchmark reads both packages alike.  The sections the port's
``EngineCore`` does not fill yet (``moe``, ``adapters``, ``sched``,
``kv_tier``, ``structured``, ``sharding``, ``weight_only``, ``router``,
``fleet``) are absent from its snapshot and render nothing.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# snapshot series key -> (prometheus family, help text) — the series
# still exposed as stat-labelled gauges (reservoir percentiles)
SERIES_FAMILIES = {
    "decode_step_ms": ("serving_decode_step_milliseconds",
                       "One fused decode chunk wall time in ms"),
    "occupancy": ("serving_step_occupancy_ratio",
                  "Active rows / max_batch per decode step"),
}

# reservoir snapshot keys whose Prometheus exposure moved to a native
# histogram family (snapshot["histograms"][value]); the reservoir dicts
# stay in the JSON snapshot for bench but are no longer rendered as
# percentile gauges.
HISTOGRAM_SERIES = {
    "ttft_s": "ttft",
    "inter_token_latency_s": "itl",
    "e2e_latency_s": "e2e",
}


class _Writer:
    def __init__(self):
        self.lines: List[str] = []
        self._seen_series = set()
        self._seen_family = set()

    def family(self, name: str, kind: str, help_text: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if name in self._seen_family:
            return
        self._seen_family.add(name)
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, value, labels: Optional[Dict] = None,
               exemplar: Optional[Dict] = None):
        if value is None:
            return
        if isinstance(value, bool):
            value = int(value)
        lstr = ""
        if labels:
            parts = []
            for k in sorted(labels):
                if not _NAME_RE.match(k):
                    raise ValueError(f"invalid label name {k!r}")
                v = str(labels[k]).replace("\\", "\\\\") \
                    .replace('"', '\\"').replace("\n", "\\n")
                parts.append(f'{k}="{v}"')
            lstr = "{" + ",".join(parts) + "}"
        series = name + lstr
        if series in self._seen_series:
            raise ValueError(f"duplicate series {series}")
        self._seen_series.add(series)
        line = f"{series} {float(value):g}"
        if exemplar:
            # OpenMetrics exemplar suffix: ` # {labels} value` — the
            # journey_id on a tail bucket links a p99 spike straight to
            # the journeys that caused it (GET /journey/<id>)
            exl = ",".join(
                f'{k}="{exemplar[k]}"' for k in sorted(exemplar)
                if k != "value")
            line += f" # {{{exl}}} {float(exemplar.get('value', 0.0)):g}"
        self.lines.append(line)

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def _hist_samples(w: _Writer, family: str, snap: dict,
                  labels: Optional[Dict] = None,
                  exemplars: Optional[Dict] = None):
    """Emit one histogram snapshot (``observability.histogram``
    cumulative-bucket form) as ``_bucket``/``_sum``/``_count`` lines.
    The family's TYPE header must already be declared by the caller —
    with a *literal* name.
    ``labels`` (e.g. ``{"tenant": name}``) ride every line so one
    family carries a bucket group per label-set; ``exemplars`` maps
    ``str(le)`` to an exemplar dict attached to that bucket line."""
    labels = dict(labels or {})
    for le, cum in snap.get("buckets") or []:
        lab = le if isinstance(le, str) else f"{float(le):g}"
        ex = (exemplars or {}).get(le if isinstance(le, str) else str(le))
        w.sample(family + "_bucket", cum, {**labels, "le": lab},
                 exemplar=ex)
    w.sample(family + "_sum", snap.get("sum", 0.0), labels or None)
    w.sample(family + "_count", snap.get("count", 0), labels or None)


def render_prometheus(snapshot: dict,
                      compile_summary: Optional[dict] = None) -> str:
    """Flatten one ``ServingMetrics.snapshot()`` (plus, optionally, a
    ``CompileLog.summary()``) into Prometheus text exposition."""
    w = _Writer()

    w.family("serving_queue_depth", "gauge",
             "Requests waiting in the admission queue")
    w.sample("serving_queue_depth", snapshot.get("queue_depth", 0))
    w.family("serving_active_requests", "gauge",
             "Requests currently occupying a KV slot")
    w.sample("serving_active_requests", snapshot.get("active", 0))
    w.family("serving_max_batch", "gauge",
             "Configured continuous-batching slots")
    w.sample("serving_max_batch", snapshot.get("max_batch", 0))
    w.family("serving_batch_occupancy", "gauge",
             "active / max_batch at snapshot time")
    w.sample("serving_batch_occupancy", snapshot.get("batch_occupancy", 0.0))

    kv = snapshot.get("kv_pool") or {}
    if kv:
        w.family("serving_kv_pool_blocks", "gauge",
                 "KV block pool usage by state")
        w.sample("serving_kv_pool_blocks", kv.get("total_blocks"),
                 {"state": "total"})
        w.sample("serving_kv_pool_blocks", kv.get("used_blocks"),
                 {"state": "used"})
        w.sample("serving_kv_pool_blocks", kv.get("free_blocks"),
                 {"state": "free"})
        w.family("serving_kv_pool_occupancy", "gauge",
                 "used_blocks / total_blocks")
        w.sample("serving_kv_pool_occupancy", kv.get("occupancy"))
        w.family("serving_kv_pool_headroom_pages", "gauge",
                 "Pool pages reserved beyond worst-case live rows, in "
                 "PAGES (prefix-cache retention room; capacity gauges "
                 "are page-denominated so KV quantization cannot skew "
                 "them)")
        w.sample("serving_kv_pool_headroom_pages",
                 kv.get("headroom_pages"))

    kq = snapshot.get("kv_quant") or {}
    if kq:
        w.family("kv_quant_info", "gauge",
                 "Quantized KV pool config as labels (constant 1): "
                 "storage dtype of the paged KV payload")
        w.sample("kv_quant_info", 1, {"kv_dtype": kq.get("kv_dtype",
                                                         "none")})
        w.family("kv_quant_bytes_per_page", "gauge",
                 "HBM bytes per KV page (all layers, payload + scales) "
                 "by pool representation")
        w.sample("kv_quant_bytes_per_page", kq.get("bytes_per_page"),
                 {"repr": "quantized"})
        w.sample("kv_quant_bytes_per_page", kq.get("fp_bytes_per_page"),
                 {"repr": "fp"})
        w.family("kv_quant_scale_bytes_per_page", "gauge",
                 "Per-page float32 scale overhead in bytes (all "
                 "layers, k+v, one scale per page per head)")
        w.sample("kv_quant_scale_bytes_per_page",
                 kq.get("scale_bytes_per_page"))
        w.family("kv_quant_resident_page_ratio", "gauge",
                 "fp_bytes_per_page / bytes_per_page — how many more "
                 "pages fit in the same pool bytes vs the fp pool")
        w.sample("kv_quant_resident_page_ratio",
                 kq.get("resident_page_ratio"))

    wo = snapshot.get("weight_only") or {}
    if wo:
        w.family("weight_only_layers", "gauge",
                 "Linear/MoE sublayers served from weight-only "
                 "quantized payloads")
        w.sample("weight_only_layers", wo.get("layers"))
        w.family("weight_only_qweight_bytes", "gauge",
                 "Resident bytes of quantized weight payloads plus "
                 "their scales")
        w.sample("weight_only_qweight_bytes", wo.get("qweight_bytes"))
        w.family("weight_only_fp_equiv_bytes", "gauge",
                 "Bytes the same weights would occupy at float32")
        w.sample("weight_only_fp_equiv_bytes", wo.get("fp_equiv_bytes"))
        w.family("weight_only_hbm_traffic_ratio", "gauge",
                 "qweight_bytes / fp_equiv_bytes — per-step weight "
                 "HBM traffic relative to the fp checkpoint (bounds "
                 "bs=1 decode)")
        w.sample("weight_only_hbm_traffic_ratio",
                 wo.get("hbm_traffic_ratio"))

    moe = snapshot.get("moe") or {}
    if moe:
        w.family("moe_info", "gauge",
                 "MoE serving plane config as labels (constant 1): "
                 "expert count, routed top-k, gate kind, static "
                 "per-expert capacity, ep degree, expert arithmetic")
        w.sample("moe_info", 1, {
            "experts": moe.get("num_experts", 0),
            "top_k": moe.get("top_k", 0),
            "gate": moe.get("gate", "?"),
            "capacity": moe.get("capacity", 0),
            "ep": moe.get("ep", 1),
            "algo": moe.get("algo", "fp")})
        w.family("moe_expert_hbm_bytes", "gauge",
                 "Resident bytes of the stacked expert payloads across "
                 "all MoE layers (what the ep axis shards)")
        w.sample("moe_expert_hbm_bytes", moe.get("expert_hbm_bytes"))
        w.family("moe_expert_tokens_total", "counter",
                 "Valid token-expert assignments kept, by expert "
                 "(summed over MoE layers)")
        tokens = moe.get("expert_tokens") or []
        if tokens:
            for e, n in enumerate(tokens):
                w.sample("moe_expert_tokens_total", n, {"expert": e})
        else:
            w.sample("moe_expert_tokens_total", 0, {"expert": "none"})
        w.family("moe_tokens_routed_total", "counter",
                 "Valid token-expert assignments kept across all "
                 "experts")
        w.sample("moe_tokens_routed_total", moe.get("tokens_routed", 0))
        w.family("moe_tokens_dropped_total", "counter",
                 "Valid assignments lost to capacity overflow (the "
                 "quality signal behind --capacity_factor)")
        w.sample("moe_tokens_dropped_total",
                 moe.get("tokens_dropped", 0))
        w.family("moe_dropped_ratio", "gauge",
                 "dropped / (routed + dropped) over the process "
                 "lifetime")
        w.sample("moe_dropped_ratio", moe.get("dropped_ratio", 0.0))
        w.family("moe_expert_utilization", "gauge",
                 "Share of routed assignments each expert received")
        util = moe.get("expert_utilization") or []
        if util:
            for e, u in enumerate(util):
                w.sample("moe_expert_utilization", u, {"expert": e})
        else:
            w.sample("moe_expert_utilization", 0.0, {"expert": "none"})
        w.family("moe_utilization_skew", "gauge",
                 "max expert share x num_experts (1.0 = perfectly "
                 "balanced, num_experts = total collapse)")
        w.sample("moe_utilization_skew",
                 moe.get("utilization_skew", 0.0))
        w.family("moe_gate_aux_loss", "gauge",
                 "Gate load-balance auxiliary loss from the most "
                 "recent mixed step (mean across MoE layers)")
        w.sample("moe_gate_aux_loss", moe.get("gate_aux_loss", 0.0))

    ad = snapshot.get("adapters") or {}
    if ad:
        w.family("adapter_info", "gauge",
                 "Multi-LoRA serving plane config as labels (constant "
                 "1): device slot count (slot 0 = identity), the "
                 "deployment's fixed rank, converted target "
                 "projections")
        w.sample("adapter_info", 1, {
            "slots": ad.get("slots", 0),
            "rank": ad.get("rank", 0),
            "layers": ad.get("layers", 0)})
        w.family("adapter_pool_hbm_bytes", "gauge",
                 "Resident bytes of the stacked adapter slot pools "
                 "(A/B factors + scales across all converted layers)")
        w.sample("adapter_pool_hbm_bytes", ad.get("pool_hbm_bytes"))
        w.family("adapter_slots_resident", "gauge",
                 "Device slots currently holding an adapter")
        w.sample("adapter_slots_resident", ad.get("resident", 0))
        w.family("adapter_slots_pinned", "gauge",
                 "Device slots pinned by in-flight rows (unpinned "
                 "residents are the LRU-evictable set)")
        w.sample("adapter_slots_pinned", ad.get("pinned", 0))
        w.family("adapter_cache_hits_total", "counter",
                 "Admission-time acquires served by an already-resident "
                 "slot")
        w.sample("adapter_cache_hits_total", ad.get("hits", 0))
        w.family("adapter_cache_misses_total", "counter",
                 "Acquires that required a host -> device upload "
                 "(free slot or LRU eviction)")
        w.sample("adapter_cache_misses_total", ad.get("misses", 0))
        w.family("adapter_cache_hit_rate", "gauge",
                 "hits / (hits + misses) over the process lifetime")
        w.sample("adapter_cache_hit_rate", ad.get("hit_rate", 0.0))
        w.family("adapter_uploads_total", "counter",
                 "Host -> device adapter uploads (one per miss that "
                 "won a slot)")
        w.sample("adapter_uploads_total", ad.get("uploads", 0))
        w.family("adapter_upload_bytes_total", "counter",
                 "Factor bytes moved host -> device by adapter uploads")
        w.sample("adapter_upload_bytes_total", ad.get("upload_bytes", 0))
        w.family("adapter_evictions_total", "counter",
                 "Resident adapters displaced by the slot LRU")
        w.sample("adapter_evictions_total", ad.get("evictions", 0))
        st = ad.get("store") or {}
        w.family("adapter_store_adapters", "gauge",
                 "Tenant adapters registered in the host-side paged "
                 "store")
        w.sample("adapter_store_adapters", st.get("adapters", 0))
        w.family("adapter_store_pages", "gauge",
                 "Host arena pages by state (the store's KV-pool-style "
                 "residency bound)")
        w.sample("adapter_store_pages", st.get("pages_total"),
                 {"state": "total"})
        w.sample("adapter_store_pages", st.get("pages_used"),
                 {"state": "used"})

    kt = snapshot.get("kv_tier") or {}
    if kt:
        w.family("kv_tier_parked_requests", "gauge",
                 "Active requests currently preemption-parked in the "
                 "host-RAM KV tier")
        w.sample("kv_tier_parked_requests", kt.get("parked_requests", 0))
        w.family("kv_tier_host_pages", "gauge",
                 "Host arena pages by state: capacity, resident "
                 "(parked KV + demoted prefix blocks), lifetime peak")
        w.sample("kv_tier_host_pages", kt.get("host_pages_total"),
                 {"state": "total"})
        w.sample("kv_tier_host_pages", kt.get("host_pages_resident"),
                 {"state": "resident"})
        w.sample("kv_tier_host_pages", kt.get("host_pages_peak"),
                 {"state": "peak"})
        w.family("kv_tier_demoted_blocks", "gauge",
                 "Full prefix-cache pages currently demoted to the "
                 "host tier (promote-on-hit candidates)")
        w.sample("kv_tier_demoted_blocks", kt.get("demoted_blocks", 0))
        w.family("kv_tier_parks_total", "counter",
                 "Active rows preempted into the host tier (park, "
                 "don't drop)")
        w.sample("kv_tier_parks_total", kt.get("parks_total", 0))
        w.family("kv_tier_predictive_parks_total", "counter",
                 "Parks initiated by the predictive admission planner "
                 "(subset of kv_tier_parks_total)")
        w.sample("kv_tier_predictive_parks_total",
                 kt.get("predictive_parks_total", 0))
        w.family("kv_tier_resumes_total", "counter",
                 "Parked rows resumed bitwise back into a device slot")
        w.sample("kv_tier_resumes_total", kt.get("resumes_total", 0))
        w.family("kv_tier_demotes_total", "counter",
                 "Full prefix-cache pages demoted to host on LRU "
                 "eviction")
        w.sample("kv_tier_demotes_total", kt.get("demotes_total", 0))
        w.family("kv_tier_promotes_total", "counter",
                 "Demoted pages promoted back to fresh device blocks "
                 "on a prefix re-hit")
        w.sample("kv_tier_promotes_total", kt.get("promotes_total", 0))
        w.family("kv_tier_swap_out_bytes_total", "counter",
                 "KV bytes moved device -> host by parks and "
                 "demotions (int8 KV pools halve this)")
        w.sample("kv_tier_swap_out_bytes_total",
                 kt.get("swap_out_bytes_total", 0))
        w.family("kv_tier_swap_in_bytes_total", "counter",
                 "KV bytes moved host -> device by resumes and "
                 "promotions")
        w.sample("kv_tier_swap_in_bytes_total",
                 kt.get("swap_in_bytes_total", 0))
        w.family("kv_tier_swap_retries_total", "counter",
                 "Bounded retries across the kv.swap_out / kv.swap_in "
                 "fault sites")
        w.sample("kv_tier_swap_retries_total",
                 kt.get("swap_retries_total", 0))
        w.family("kv_tier_swap_fails_total", "counter",
                 "Swaps abandoned after exhausting bounded retries "
                 "(fell back to the shed/replay ladder)")
        w.sample("kv_tier_swap_fails_total", kt.get("swap_fails_total", 0))

    # constrained decoding (serving/structured/): the snapshot section
    # is EngineCore._structured_snapshot() — grammar cache stats plus
    # the core's violation/incomplete/rejection tallies
    st = snapshot.get("structured") or {}
    if st:
        w.family("grammar_active_rows", "gauge",
                 "Batch rows currently decoding under a grammar FSM")
        w.sample("grammar_active_rows", st.get("active_rows", 0))
        w.family("grammar_cache_entries", "gauge",
                 "Distinct compiled grammars resident in the FSM cache")
        w.sample("grammar_cache_entries", st.get("entries", 0))
        w.family("grammar_cache_hits_total", "counter",
                 "Admissions that reused a cached compiled grammar")
        w.sample("grammar_cache_hits_total", st.get("hits", 0))
        w.family("grammar_cache_misses_total", "counter",
                 "Admissions that compiled a new grammar FSM")
        w.sample("grammar_cache_misses_total", st.get("misses", 0))
        w.family("grammar_compile_seconds_total", "counter",
                 "Host wall seconds spent compiling grammar FSMs "
                 "(always at admission, never under the step lock)")
        w.sample("grammar_compile_seconds_total",
                 st.get("compile_seconds", 0.0))
        w.family("grammar_violations_total", "counter",
                 "Emitted tokens that violated their row's grammar "
                 "(0 by construction — the mask bans them; nonzero "
                 "means the mask path is broken)")
        w.sample("grammar_violations_total", st.get("violations", 0))
        w.family("grammar_incomplete_finishes_total", "counter",
                 "Constrained rows that exhausted max_new_tokens in a "
                 "non-accepting FSM state (finished FAILED with "
                 "GrammarIncompleteError)")
        w.sample("grammar_incomplete_finishes_total",
                 st.get("incomplete", 0))
        w.family("grammar_rejections_total", "counter",
                 "Requests refused at admission for a malformed, "
                 "unsupported or unsatisfiable grammar spec")
        w.sample("grammar_rejections_total", st.get("rejected", 0))

    px = snapshot.get("prefix_cache") or {}
    if px:
        w.family("prefix_cache_queries_total", "counter",
                 "Prefix-cache lookups at admission")
        w.sample("prefix_cache_queries_total", px.get("queries"))
        w.family("prefix_cache_hits_total", "counter",
                 "Lookups that matched at least one cached token")
        w.sample("prefix_cache_hits_total", px.get("hits"))
        w.family("prefix_cache_hit_rate", "gauge",
                 "hits / queries over the process lifetime")
        w.sample("prefix_cache_hit_rate", px.get("hit_rate"))
        w.family("prefix_cache_cached_tokens_total", "counter",
                 "Prompt tokens served from cached KV pages")
        w.sample("prefix_cache_cached_tokens_total",
                 px.get("cached_tokens"))
        w.family("prefix_cache_prompt_tokens_total", "counter",
                 "Prompt tokens seen by prefix-cache lookups")
        w.sample("prefix_cache_prompt_tokens_total",
                 px.get("prompt_tokens"))
        w.family("prefix_cache_token_ratio", "gauge",
                 "cached_tokens / prompt_tokens (cached-token ratio)")
        w.sample("prefix_cache_token_ratio", px.get("token_ratio"))
        w.family("prefix_cache_peeks_total", "counter",
                 "Read-only longest-match probes (fleet router "
                 "affinity; no pins, no LRU movement)")
        w.sample("prefix_cache_peeks_total", px.get("peeks"))
        w.family("prefix_cache_inserts_total", "counter",
                 "Finished sequences retained into the radix tree")
        w.sample("prefix_cache_inserts_total", px.get("inserts"))
        w.family("prefix_cache_evicted_blocks_total", "counter",
                 "Cached blocks evicted (LRU / watermark / clear)")
        w.sample("prefix_cache_evicted_blocks_total",
                 px.get("evicted_blocks"))
        w.family("prefix_cache_cow_copies_total", "counter",
                 "Copy-on-write page copies for shared partial tails")
        w.sample("prefix_cache_cow_copies_total", px.get("cow_copies"))
        w.family("prefix_cache_blocks", "gauge",
                 "KV blocks currently retained by the radix tree")
        w.sample("prefix_cache_blocks", px.get("cached_blocks"))
        w.family("prefix_cache_nodes", "gauge",
                 "Full-page nodes currently in the radix tree")
        w.sample("prefix_cache_nodes", px.get("nodes"))

    res = snapshot.get("resilience") or {}
    if res:
        w.family("engine_health_state", "gauge",
                 "Engine health state machine, one-hot by state label "
                 "(healthy/degraded/draining/down)")
        current = res.get("health_state", "healthy")
        for state in ("healthy", "degraded", "draining", "down"):
            w.sample("engine_health_state", int(state == current),
                     {"state": state})
        w.family("serving_effective_max_batch", "gauge",
                 "Slots the degradation ladder currently allows "
                 "(<= serving_max_batch)")
        w.sample("serving_effective_max_batch",
                 res.get("effective_max_batch"))
        w.family("engine_restarts_total", "counter",
                 "Engine restarts after KV state loss (pools rebuilt, "
                 "in-flight rows replayed)")
        w.sample("engine_restarts_total", res.get("engine_restarts", 0))
        w.family("request_retries_total", "counter",
                 "Requests requeued for replay after an engine failure")
        w.sample("request_retries_total", res.get("request_retries", 0))
        w.family("watchdog_trips_total", "counter",
                 "Supervisor step-watchdog trips (hung or overlong "
                 "scheduler steps)")
        w.sample("watchdog_trips_total", res.get("watchdog_trips", 0))
        w.family("requests_quarantined_total", "counter",
                 "Poison requests quarantined (retry budget spent or "
                 "non-finite logits)")
        w.sample("requests_quarantined_total",
                 res.get("requests_quarantined", 0))
        w.family("requests_shed_total", "counter",
                 "Queued requests shed by the degradation ladder "
                 "(insufficient deadline headroom)")
        w.sample("requests_shed_total", res.get("requests_shed", 0))
        w.family("engine_loop_exceptions_total", "counter",
                 "Exceptions escaping a scheduler loop iteration")
        w.sample("engine_loop_exceptions_total",
                 res.get("loop_exceptions", 0))
        faults = res.get("faults_injected") or {}
        w.family("faults_injected_total", "counter",
                 "Faults injected by the fault plane, by site "
                 "(0 everywhere in production)")
        if faults:
            for site in sorted(faults):
                w.sample("faults_injected_total", faults[site],
                         {"site": site})
        else:
            w.sample("faults_injected_total", 0, {"site": "none"})

    counters = snapshot.get("counters") or {}
    for key in sorted(counters):
        name = f"serving_{key}_total"
        w.family(name, "counter", f"Lifetime count of {key} events")
        w.sample(name, counters[key])

    w.family("serving_tokens_per_second", "gauge",
             "Sliding-window decode throughput")
    w.sample("serving_tokens_per_second",
             snapshot.get("tokens_per_second", 0.0))

    spec = snapshot.get("speculation") or {}
    if spec:
        w.family("serving_spec_acceptance_rate", "gauge",
                 "Accepted / proposed draft tokens over the process "
                 "lifetime (in-engine speculative decoding)")
        w.sample("serving_spec_acceptance_rate",
                 spec.get("acceptance_rate", 0.0))
        w.family("serving_spec_wasted_ratio", "gauge",
                 "Rejected / proposed draft tokens — verify-lane work "
                 "that produced no emitted tokens")
        w.sample("serving_spec_wasted_ratio",
                 spec.get("wasted_ratio", 0.0))

    # native histogram families — family names are literal (not looped
    # from a dict)
    hists = snapshot.get("histograms") or {}
    if (hists.get("ttft") or {}).get("buckets"):
        w.family("serving_ttft_seconds", "histogram",
                 "Time to first token in seconds")
        _hist_samples(w, "serving_ttft_seconds", hists["ttft"])
    if (hists.get("itl") or {}).get("buckets"):
        w.family("serving_inter_token_latency_seconds", "histogram",
                 "Per-token latency inside a fused decode chunk in "
                 "seconds")
        _hist_samples(w, "serving_inter_token_latency_seconds",
                      hists["itl"])
    if (hists.get("e2e") or {}).get("buckets"):
        w.family("serving_e2e_latency_seconds", "histogram",
                 "Request end-to-end latency in seconds")
        _hist_samples(w, "serving_e2e_latency_seconds", hists["e2e"])
    if (hists.get("step_wall") or {}).get("buckets"):
        w.family("serving_step_wall_seconds", "histogram",
                 "One scheduler step (fused decode chunk or prefill) "
                 "wall time in seconds")
        _hist_samples(w, "serving_step_wall_seconds", hists["step_wall"])
    if (hists.get("queue_wait") or {}).get("buckets"):
        w.family("serving_queue_wait_seconds", "histogram",
                 "Admission-queue wait before a slot was granted in "
                 "seconds")
        _hist_samples(w, "serving_queue_wait_seconds",
                      hists["queue_wait"])

    mem = snapshot.get("device_memory") or {}
    mem_kinds = {k: v for k, v in mem.items()
                 if isinstance(v, (int, float))
                 and ("bytes" in k or "size" in k)}
    if mem_kinds:
        w.family("device_memory_bytes", "gauge",
                 "Device allocator memory_stats(), byte-valued keys "
                 "by kind")
        for k in sorted(mem_kinds):
            w.sample("device_memory_bytes", mem_kinds[k], {"kind": k})

    sl = snapshot.get("steplog") or {}
    if sl:
        w.family("steplog_records_total", "counter",
                 "StepLog flight-recorder records by step kind")
        by_kind = sl.get("by_kind") or {}
        if by_kind:
            for kind in sorted(by_kind):
                w.sample("steplog_records_total", by_kind[kind],
                         {"kind": kind})
        else:
            w.sample("steplog_records_total", 0, {"kind": "none"})
        w.family("steplog_steps_by_kernel_total", "counter",
                 "StepLog scheduler-step records by serving kernel "
                 "(ragged mixed step vs legacy per-shape programs)")
        by_kernel = sl.get("by_kernel") or {}
        if by_kernel:
            for kernel in sorted(by_kernel):
                w.sample("steplog_steps_by_kernel_total",
                         by_kernel[kernel], {"kernel": kernel})
        else:
            w.sample("steplog_steps_by_kernel_total", 0,
                     {"kernel": "none"})
        w.family("steplog_prefill_chunk_tokens_total", "counter",
                 "Prompt tokens prefilled through ragged mixed-step "
                 "chunks (chunked-prefill progress)")
        w.sample("steplog_prefill_chunk_tokens_total",
                 sl.get("prefill_chunk_tokens_total", 0))
        w.family("steplog_bytes_estimated_total", "counter",
                 "Analytic bytes-moved attributed across all recorded "
                 "steps")
        w.sample("steplog_bytes_estimated_total",
                 sl.get("bytes_est_total", 0.0))
        w.family("steplog_draft_tokens_total", "counter",
                 "Draft tokens packed into verify rows across recorded "
                 "mixed steps")
        w.sample("steplog_draft_tokens_total",
                 sl.get("draft_tokens_total", 0))
        w.family("steplog_draft_accepted_total", "counter",
                 "Draft tokens accepted by the verify pass across "
                 "recorded mixed steps")
        w.sample("steplog_draft_accepted_total",
                 sl.get("draft_accepted_total", 0))
        w.family("steplog_moe_tokens_routed_total", "counter",
                 "Valid token-expert assignments kept across recorded "
                 "mixed steps (StepLog view of the MoE plane)")
        w.sample("steplog_moe_tokens_routed_total",
                 sl.get("moe_tokens_routed_total", 0))
        w.family("steplog_moe_tokens_dropped_total", "counter",
                 "Valid assignments lost to capacity overflow across "
                 "recorded mixed steps")
        w.sample("steplog_moe_tokens_dropped_total",
                 sl.get("moe_tokens_dropped_total", 0))
        w.family("steplog_adapter_rows_total", "counter",
                 "Batch rows that ran with a non-identity LoRA adapter "
                 "slot across recorded mixed steps")
        w.sample("steplog_adapter_rows_total",
                 sl.get("adapter_rows_total", 0))
        w.family("steplog_grammar_rows_total", "counter",
                 "Batch rows that sampled through a grammar mask "
                 "across recorded mixed steps")
        w.sample("steplog_grammar_rows_total",
                 sl.get("grammar_rows_total", 0))
        w.family("steplog_masked_tokens_total", "counter",
                 "Vocabulary entries banned by grammar masks across "
                 "recorded mixed steps (summed over constrained rows)")
        w.sample("steplog_masked_tokens_total",
                 sl.get("masked_tokens_total", 0))
        model = sl.get("decode_model") or {}
        w.family("steplog_model_abs_rel_error", "gauge",
                 "Mean absolute relative error of the fitted step-cost "
                 "model over recent decode steps")
        w.sample("steplog_model_abs_rel_error",
                 model.get("mean_abs_rel_err"))
        w.family("steplog_model_pearson_r", "gauge",
                 "Pearson correlation between the analytic bytes "
                 "estimate and measured decode step wall")
        w.sample("steplog_model_pearson_r", model.get("pearson_r"))

    sc = snapshot.get("sched") or {}
    if sc:
        w.family("sched_policy_info", "gauge",
                 "Active SLO admission policy as labels (constant 1)")
        w.sample("sched_policy_info", 1, {
            "policy": sc.get("policy", "fifo"),
            "reorders": str(bool(sc.get("reorders"))).lower()})
        w.family("sched_predictive_sheds_total", "counter",
                 "Queued requests shed because their predicted "
                 "completion already missed the deadline")
        w.sample("sched_predictive_sheds_total",
                 sc.get("predictive_sheds", 0))
        planner = sc.get("planner") or {}
        w.family("sched_planner_plans_total", "counter",
                 "Mixed steps planned by the StepPlanner")
        w.sample("sched_planner_plans_total", planner.get("plans", 0))
        w.family("sched_planner_chunk_limited_total", "counter",
                 "Planned steps whose prompt-chunk cap was shrunk "
                 "below the static prefill_chunk to fit the ITL SLO")
        w.sample("sched_planner_chunk_limited_total",
                 planner.get("chunk_limited_steps", 0))
        pm = (snapshot.get("steplog") or {}).get("planner_model") or {}
        w.family("sched_planner_pred_wall_abs_rel_err", "gauge",
                 "Mean absolute relative error of the planner's "
                 "predicted step wall vs measured, recent steps")
        w.sample("sched_planner_pred_wall_abs_rel_err",
                 pm.get("mean_abs_rel_err"))
        slack = sc.get("slack_err") or {}
        w.family("sched_slack_pred_err_seconds", "gauge",
                 "Mean absolute error of the slack policy's predicted "
                 "completion time vs actual, recent completed requests")
        w.sample("sched_slack_pred_err_seconds",
                 slack.get("mean_abs_err_s"))
        w.family("sched_last_min_slack_seconds", "gauge",
                 "Smallest predicted deadline slack among queued "
                 "requests at the last admission-policy pass")
        w.sample("sched_last_min_slack_seconds",
                 sc.get("last_min_slack_s"))

    sh = snapshot.get("sharding") or {}
    if sh:
        axes = sh.get("mesh_axes") or {}
        w.family("serving_mesh_info", "gauge",
                 "Serving mesh topology as labels (constant 1): "
                 "mp/dp/ep degrees, device count, quantized-allreduce "
                 "wire format")
        w.sample("serving_mesh_info", 1, {
            "mp": axes.get("mp", 1), "dp": axes.get("dp", 1),
            "ep": axes.get("ep", 1),
            "devices": sh.get("devices", 1),
            "quantized_allreduce": sh.get("quantized_allreduce") or "off"})
        w.family("serving_shard_sharded_params", "gauge",
                 "Served parameters placed with at least one "
                 "mesh-sharded dimension")
        w.sample("serving_shard_sharded_params",
                 sh.get("sharded_params", 0))
        w.family("serving_shard_replicated_params", "gauge",
                 "Served parameters silently replicated because a "
                 "stamped TP axis does not divide their dimension "
                 "(TP-coverage regressions)")
        w.sample("serving_shard_replicated_params",
                 sh.get("replicated_params", 0))
        col = sh.get("collectives") or {}
        w.family("collective_bytes_total", "counter",
                 "Analytic interconnect bytes moved by collectives, "
                 "by op and wire dtype (ring model)")
        by_op = col.get("by_op_dtype") or {}
        if by_op:
            for op in sorted(by_op):
                for dt in sorted(by_op[op]):
                    w.sample("collective_bytes_total", by_op[op][dt],
                             {"op": op, "dtype": dt})
        else:
            w.sample("collective_bytes_total", 0,
                     {"op": "none", "dtype": "none"})
        w.family("collective_bytes_saved_total", "counter",
                 "Interconnect bytes saved by quantized collective "
                 "wire formats vs their full-precision equivalent")
        w.sample("collective_bytes_saved_total",
                 col.get("bytes_saved_total", 0.0))

    rt = snapshot.get("router") or {}
    if rt:
        reps = rt.get("replicas") or []
        w.family("router_replica_info", "gauge",
                 "Fleet replica topology as labels (constant 1): "
                 "live and configured role per replica")
        for rep in reps:
            w.sample("router_replica_info", 1, {
                "replica": rep.get("name", "?"),
                "role": rep.get("role", "mixed"),
                "configured_role": rep.get("configured_role", "mixed")})
        w.family("router_dispatched_total", "counter",
                 "Requests dispatched by the fleet router, by replica")
        for rep in reps:
            w.sample("router_dispatched_total", rep.get("dispatched", 0),
                     {"replica": rep.get("name", "?")})
        w.family("router_affinity_hits_total", "counter",
                 "Dispatches placed by a confirmed prefix-affinity "
                 "match, by replica")
        for rep in reps:
            w.sample("router_affinity_hits_total",
                     rep.get("affinity_hits", 0),
                     {"replica": rep.get("name", "?")})
        w.family("router_affinity_hit_rate", "gauge",
                 "affinity_hits / dispatched over the fleet lifetime")
        w.sample("router_affinity_hit_rate",
                 rt.get("affinity_hit_rate", 0.0))
        w.family("router_handoffs_total", "counter",
                 "Cross-replica KV page handoffs completed "
                 "(prefill -> decode migrations)")
        w.sample("router_handoffs_total", rt.get("handoffs", 0))
        w.family("router_replica_handoffs_total", "counter",
                 "Handoffs by replica and direction (in = imported KV, "
                 "out = exported KV)")
        for rep in reps:
            name = rep.get("name", "?")
            w.sample("router_replica_handoffs_total",
                     rep.get("handoffs_out", 0),
                     {"replica": name, "direction": "out"})
            w.sample("router_replica_handoffs_total",
                     rep.get("handoffs_in", 0),
                     {"replica": name, "direction": "in"})
        w.family("router_requeued_total", "counter",
                 "Admissions reclaimed from non-serving replicas and "
                 "rerouted (health-gated drain rerouting)")
        w.sample("router_requeued_total", rt.get("requeued", 0))
        w.family("router_no_replica_rejects_total", "counter",
                 "Submissions rejected because no replica was serving")
        w.sample("router_no_replica_rejects_total",
                 rt.get("no_replica_rejects", 0))
        w.family("router_pending_handoffs", "gauge",
                 "Requests registered for prefill -> decode handoff "
                 "whose chunk boundary has not arrived yet")
        w.sample("router_pending_handoffs",
                 rt.get("pending_handoffs", 0))
        w.family("router_inflight_requests", "gauge",
                 "Requests the router currently tracks across all "
                 "replicas")
        w.sample("router_inflight_requests", rt.get("inflight", 0))
        w.family("router_replica_health_code", "gauge",
                 "Replica health state code (0 healthy, 1 degraded, "
                 "2 draining, 3 down)")
        for rep in reps:
            w.sample("router_replica_health_code",
                     (rep.get("health") or {}).get("code", 0),
                     {"replica": rep.get("name", "?")})
        w.family("router_replica_active_requests", "gauge",
                 "Requests occupying a KV slot, by replica")
        for rep in reps:
            w.sample("router_replica_active_requests",
                     rep.get("active", 0),
                     {"replica": rep.get("name", "?")})
        w.family("router_replica_queue_depth", "gauge",
                 "Admission-queue depth, by replica")
        for rep in reps:
            w.sample("router_replica_queue_depth", rep.get("queued", 0),
                     {"replica": rep.get("name", "?")})
        w.family("router_replica_predicted_load_bytes", "gauge",
                 "Analytic bytes the replica's next scheduler step "
                 "would move (StepCostModel; the load-balance signal)")
        for rep in reps:
            w.sample("router_replica_predicted_load_bytes",
                     rep.get("predicted_load_bytes", 0.0),
                     {"replica": rep.get("name", "?")})
        w.family("router_role_flips_total", "counter",
                 "Elastic role flips applied, by replica")
        for rep in reps:
            w.sample("router_role_flips_total", rep.get("role_flips", 0),
                     {"replica": rep.get("name", "?")})
        w.family("router_shadow_nodes", "gauge",
                 "Full-page nodes in the router's shadow prefix index "
                 "across all replicas")
        w.sample("router_shadow_nodes",
                 (rt.get("shadow") or {}).get("nodes", 0))
        w.family("router_prefill_fraction", "gauge",
                 "Windowed prefill-token fraction the elastic role "
                 "policy observes (absent until the window fills)")
        w.sample("router_prefill_fraction",
                 (rt.get("elastic") or {}).get("prefill_fraction"))

    # fleet-wide request journeys (observability/journey.py): the
    # snapshot section is JourneyStore.summary()
    jn = snapshot.get("journeys") or {}
    if jn:
        w.family("journeys_total", "counter",
                 "Finished request journeys (one per request, stitched "
                 "across every replica it touched)")
        w.sample("journeys_total", jn.get("count", 0))
        w.family("journey_hops_total", "counter",
                 "Cross-replica handoff hops recorded across all "
                 "finished journeys")
        w.sample("journey_hops_total", jn.get("hops_total", 0))
        w.family("journey_live_requests", "gauge",
                 "Journeys still in flight (not yet finalized)")
        w.sample("journey_live_requests", jn.get("live", 0))
        w.family("journey_attribution_coverage", "gauge",
                 "Mean fraction of journey e2e wall attributed to a "
                 "named bucket (1 - other/e2e); below 0.97 means the "
                 "attribution engine is losing time")
        w.sample("journey_attribution_coverage",
                 jn.get("attribution_coverage", 0.0))
        w.family("journey_attribution_seconds_total", "counter",
                 "Aggregate journey wall seconds by attribution bucket "
                 "(queue_wait/sched_reorder/adapter_wait/prefill_compute"
                 "/handoff/parked/resume/decode_compute/detok/"
                 "replay_retry/other)")
        bs = jn.get("bucket_seconds") or {}
        if bs:
            for b in sorted(bs):
                w.sample("journey_attribution_seconds_total", bs[b],
                         {"bucket": b})
        else:
            w.sample("journey_attribution_seconds_total", 0.0,
                     {"bucket": "none"})

    # per-tenant SLO accounting (ServingMetrics.on_journey)
    tn = snapshot.get("tenants") or {}
    if tn:
        w.family("tenant_requests_total", "counter",
                 "Finished requests by accounting tenant")
        for name in sorted(tn):
            w.sample("tenant_requests_total",
                     tn[name].get("requests", 0), {"tenant": name})
        w.family("tenant_slo_attained_total", "counter",
                 "Requests that finished DONE within their deadline, "
                 "by tenant")
        for name in sorted(tn):
            w.sample("tenant_slo_attained_total",
                     tn[name].get("attained", 0), {"tenant": name})
        w.family("tenant_slo_attainment", "gauge",
                 "attained / requests per tenant over the process "
                 "lifetime")
        for name in sorted(tn):
            w.sample("tenant_slo_attainment",
                     tn[name].get("attainment", 0.0), {"tenant": name})
        w.family("tenant_tokens_total", "counter",
                 "Tokens delivered by finished requests, by tenant")
        for name in sorted(tn):
            w.sample("tenant_tokens_total",
                     tn[name].get("tokens", 0), {"tenant": name})
        w.family("tenant_parked_seconds_total", "counter",
                 "Wall seconds tenants' requests spent parked in the "
                 "host KV tier")
        for name in sorted(tn):
            w.sample("tenant_parked_seconds_total",
                     tn[name].get("parked_seconds", 0.0),
                     {"tenant": name})
        w.family("tenant_e2e_seconds", "histogram",
                 "Request end-to-end latency by tenant in seconds; "
                 "tail buckets carry journey_id exemplars")
        for name in sorted(tn):
            _hist_samples(w, "tenant_e2e_seconds",
                          tn[name].get("e2e") or {},
                          labels={"tenant": name},
                          exemplars=tn[name].get("exemplars"))
        w.family("tenant_attribution_seconds_total", "counter",
                 "Journey wall seconds by tenant and attribution "
                 "bucket")
        for name in sorted(tn):
            buckets = tn[name].get("buckets") or {}
            for b in sorted(buckets):
                w.sample("tenant_attribution_seconds_total",
                         buckets[b], {"tenant": name, "bucket": b})

    # fleet-mode /metrics: per-replica key stats with a replica label
    # (a fleet server merges each handle's snapshot into this section)
    fl = snapshot.get("fleet") or {}
    if fl:
        reps = fl.get("replicas") or []
        w.family("fleet_replica_submitted_total", "counter",
                 "Requests submitted, by replica")
        for rep in reps:
            w.sample("fleet_replica_submitted_total",
                     rep.get("submitted", 0),
                     {"replica": rep.get("replica", "?")})
        w.family("fleet_replica_completed_total", "counter",
                 "Requests completed, by replica")
        for rep in reps:
            w.sample("fleet_replica_completed_total",
                     rep.get("completed", 0),
                     {"replica": rep.get("replica", "?")})
        w.family("fleet_replica_tokens_total", "counter",
                 "Tokens generated, by replica")
        for rep in reps:
            w.sample("fleet_replica_tokens_total",
                     rep.get("tokens_generated", 0),
                     {"replica": rep.get("replica", "?")})
        w.family("fleet_replica_queue_depth", "gauge",
                 "Admission-queue depth at snapshot time, by replica")
        for rep in reps:
            w.sample("fleet_replica_queue_depth", rep.get("queued", 0),
                     {"replica": rep.get("replica", "?")})
        w.family("fleet_replica_active_requests", "gauge",
                 "Requests occupying a KV slot at snapshot time, by "
                 "replica")
        for rep in reps:
            w.sample("fleet_replica_active_requests",
                     rep.get("active", 0),
                     {"replica": rep.get("replica", "?")})

    for key, (family, help_text) in SERIES_FAMILIES.items():
        series = snapshot.get(key)
        if not isinstance(series, dict):
            continue
        w.family(family + "_count", "counter",
                 f"Lifetime sample count for: {help_text}")
        w.sample(family + "_count", series.get("count", 0))
        w.family(family, "gauge",
                 help_text + " (mean is lifetime; *_recent stats cover "
                 "the tail reservoir window)")
        for stat in ("mean", "p50_recent", "p99_recent", "max_recent"):
            w.sample(family, series.get(stat), {"stat": stat})

    if compile_summary:
        w.family("compile_count_total", "counter",
                 "XLA compilations observed since process start")
        w.sample("compile_count_total",
                 compile_summary.get("compile_count", 0))
        by_site = compile_summary.get("compile_count_by_site") or {}
        if by_site:
            w.family("compile_count_by_site", "counter",
                     "XLA compilations per jit cache site")
            for site in sorted(by_site):
                w.sample("compile_count_by_site", by_site[site],
                         {"site": site})
        w.family("recompile_count_total", "counter",
                 "Signatures compiled more than once (blown caches)")
        w.sample("recompile_count_total",
                 compile_summary.get("recompile_count", 0))
        w.family("recompile_storm", "gauge",
                 "1 when any signature compiled more than once")
        w.sample("recompile_storm",
                 compile_summary.get("recompile_storm", False))
        w.family("post_warmup_decode_compiles_total", "counter",
                 "Decode-loop compilations after warmup (design "
                 "invariant: must stay 0)")
        w.sample("post_warmup_decode_compiles_total",
                 compile_summary.get("post_warmup_decode_compiles", 0))
        w.family("compile_wall_seconds_total", "counter",
                 "Wall time spent in observed first-call compilations")
        w.sample("compile_wall_seconds_total",
                 compile_summary.get("compile_wall_s_total", 0.0))

    return w.render()


def validate_exposition(text: str) -> List[str]:
    """Syntax check a text exposition; returns a list of problems
    (empty = valid) — kept here so the renderer and its validator
    evolve together.

    Beyond name/label/value syntax and series dedup, histogram families
    are checked semantically: every bucket group must carry a terminal
    ``le="+Inf"`` bucket, cumulative counts must be non-decreasing in
    ascending ``le`` order, a ``_count`` sample must equal the ``+Inf``
    bucket, bare base-named samples are rejected, and a family declared
    ``TYPE histogram`` with no ``_bucket`` samples at all is invalid.

    Labeled multi-series families are first-class: duplicate detection
    normalizes the label set (sorted by label name), so two samples of
    the same family whose labels differ only in ORDER are still flagged
    as duplicates.  OpenMetrics exemplar suffixes
    (``... # {journey_id="j42"} 1.25``) are accepted on any sample and
    syntax-checked, then stripped before the sample itself is parsed."""
    problems = []
    seen_series = set()
    typed = set()
    kinds: Dict[str, str] = {}
    # (family, labels-minus-le) -> [(le_float, cum_count, line_no)]
    hist_buckets: Dict[Tuple[str, tuple], list] = {}
    hist_counts: Dict[Tuple[str, tuple], float] = {}
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)(\s+\d+)?$")
    label_re = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"$')
    exemplar_re = re.compile(r"^\{([^}]*)\}\s+(\S+)(\s+\S+)?$")
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(f"line {i}: bad TYPE line: {line!r}")
            else:
                typed.add(parts[2])
                kinds[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            problems.append(f"line {i}: unknown comment {line!r}")
            continue
        if " # " in line:
            # OpenMetrics exemplar: <sample> # {label="v",...} <value>
            line, ex = line.split(" # ", 1)
            em = exemplar_re.match(ex)
            if em is None:
                problems.append(f"line {i}: malformed exemplar {ex!r}")
            else:
                for pair in _split_labels(em.group(1)):
                    if not label_re.match(pair):
                        problems.append(
                            f"line {i}: bad exemplar label {pair!r}")
                try:
                    float(em.group(2))
                except ValueError:
                    problems.append(
                        f"line {i}: bad exemplar value "
                        f"{em.group(2)!r}")
        m = sample_re.match(line)
        if m is None:
            problems.append(f"line {i}: unparseable sample {line!r}")
            continue
        name, _, labels, value = m.group(1), m.group(2), m.group(3), \
            m.group(4)
        base = name
        for suffix in ("_count", "_sum", "_bucket"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                base = name[:-len(suffix)]
        if base not in typed and name not in typed:
            problems.append(f"line {i}: sample {name} has no TYPE")
        le_raw = None
        other_labels = []
        all_labels = []
        if labels:
            for pair in _split_labels(labels):
                lm = label_re.match(pair)
                if not lm:
                    problems.append(f"line {i}: bad label {pair!r}")
                    continue
                all_labels.append(pair)
                if lm.group(1) == "le":
                    le_raw = lm.group(2)
                else:
                    other_labels.append(pair)
        # normalize the label-set so reordered duplicates still collide
        key = (name, tuple(sorted(all_labels)))
        if key in seen_series:
            problems.append(f"line {i}: duplicate series {name}{{"
                            f"{labels or ''}}}")
        seen_series.add(key)
        try:
            fval = float(value)
        except ValueError:
            fval = None
            if value not in ("NaN", "+Inf", "-Inf"):
                problems.append(f"line {i}: bad value {value!r}")
        if kinds.get(base) == "histogram":
            group = (base, tuple(sorted(other_labels)))
            if name == base:
                problems.append(
                    f"line {i}: histogram {base} has a bare sample "
                    f"(only _bucket/_sum/_count are valid)")
            elif name.endswith("_bucket"):
                if le_raw is None:
                    problems.append(
                        f"line {i}: histogram bucket {name} missing "
                        f"le label")
                else:
                    try:
                        le_v = math.inf if le_raw in ("+Inf", "Inf") \
                            else float(le_raw)
                    except ValueError:
                        problems.append(
                            f"line {i}: unparseable le={le_raw!r} on "
                            f"{name}")
                    else:
                        if fval is not None:
                            hist_buckets.setdefault(group, []).append(
                                (le_v, fval, i))
            elif name.endswith("_count") and fval is not None:
                hist_counts[group] = fval
    for fam, kind in kinds.items():
        if kind != "histogram":
            continue
        groups = [g for g in hist_buckets if g[0] == fam]
        if not groups:
            problems.append(f"histogram {fam} declares TYPE but has no "
                            f"_bucket samples")
            continue
        for g in groups:
            pts = sorted(hist_buckets[g], key=lambda t: t[0])
            if not math.isinf(pts[-1][0]):
                problems.append(
                    f'histogram {fam} is missing the le="+Inf" bucket')
            prev = None
            for le_v, cum, ln in pts:
                if prev is not None and cum < prev:
                    problems.append(
                        f"line {ln}: histogram {fam} buckets are not "
                        f"cumulative (count decreases at le={le_v:g})")
                prev = cum
            if g in hist_counts and math.isinf(pts[-1][0]) \
                    and hist_counts[g] != pts[-1][1]:
                problems.append(
                    f"histogram {fam}: _count {hist_counts[g]:g} != "
                    f"+Inf bucket {pts[-1][1]:g}")
    return problems


def _split_labels(body: str) -> List[str]:
    """Split 'a="x",b="y"' respecting escaped quotes."""
    out, cur, in_q, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def family_names(text: str) -> List[str]:
    """Metric family names declared by TYPE lines."""
    return [ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")]
