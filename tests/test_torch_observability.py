"""Port parity: ``observability/`` (tracer, journeys, histograms, step log
and cost model, Prometheus, evidence) and its wiring into the ragged
``EngineCore``.

* Each test of ``tests/test_observability.py``, ``tests/test_steplog.py``
  and ``tests/test_journey.py`` on the port's modules, on the reference
  tests' tiny GPT (vocab 96, hidden 32, 2 layers, page 8).  Left out:
  ``test_instrument_jit_times_first_calls_only`` (JAX's jit;
  ``test_torch_compilelog.py`` covers the port's log) and the fleet /
  park journey, which waits for the port's fleet and host KV tier.
  ``test_tenant_label_isolation`` runs on one core.
* Module parity: the same samples give equal ``Histogram`` snapshots and
  quantiles, the same intervals equal attribution buckets, the same
  snapshot dict the same exposition text in both packages.
* Core parity: the JAX ``EngineCore`` (its ``program_cost`` pinned to
  None, so both cost models are analytic) and the port's, on the same
  weights and requests — greedy and sampled, with the prefix cache, with
  speculation — give equal step-log records but for the clock fields
  (``ts``, ``wall_s``, ``dispatch_s``, ``host_s``, ``predicted_wall_s``)
  and the planner's (``planned_tokens``, ``planned_chunk_cap``: the port
  has no SLO scheduler yet, so they keep their defaults) and
  ``compile_events`` (each package counts its own compile log's events:
  XLA compilations against the program's first call), equal span
  name sequences per request, and equal Prometheus family sets but for
  the reference's ``sched_*`` families (the scheduler's section).
  Under the resilience tests' fault script the failed step records and
  the ``recovery`` spans match.
* ``StepCostModel.page_kv_bytes`` prices fp32, bf16 and int8 pools.

Request ids key the sampling streams (``fold_in(key, rid)``), so runs
that compare the packages pin both rid counters.
"""
import itertools
import json
import logging
import time

import numpy as np
import pytest
import torch

from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.observability import histogram as jhistogram
from paddle_infer_tpu.observability import journey as jjourney
from paddle_infer_tpu.observability import prometheus as jprometheus
from paddle_infer_tpu.observability.steplog import \
    StepCostModel as JCostModel
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import EngineSupervisor as JSupervisor
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu.serving.resilience import faultplane as jfaultplane
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.observability import (Span, StepLog, Trace,
                                                  Tracer, capture_bundle,
                                                  family_names,
                                                  render_prometheus,
                                                  signature_of,
                                                  sorted_tree,
                                                  validate_exposition)
from paddle_infer_tpu_torch.observability.compilelog import CompileLog
from paddle_infer_tpu_torch.observability.histogram import (Histogram,
                                                            log_bounds,
                                                            quantile)
from paddle_infer_tpu_torch.observability.journey import (BUCKETS,
                                                          JourneyStore,
                                                          attribute)
from paddle_infer_tpu_torch.observability.steplog import (SCHEMA_KEYS,
                                                          StepCostModel)
from paddle_infer_tpu_torch.profiler.statistic import memory_stats
from paddle_infer_tpu_torch.serving import (EngineCore, EngineSupervisor,
                                            FaultPlane, RequestState)
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.serving.metrics import ServingMetrics

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_resilience import SCRIPT, _workload
from test_torch_speculation import _pair, _pinned_globals

PAGE = 8
CORE_SHAPE = dict(max_batch=3, max_model_len=48, token_budget=16,
                  prefill_chunk=16)
# the step-log fields read off a clock, and those the SLO scheduler
# fills in the reference (the port keeps their schema defaults)
CLOCK_FIELDS = ("ts", "wall_s", "dispatch_s", "host_s", "predicted_wall_s")
PLANNER_FIELDS = ("planned_tokens", "planned_chunk_cap")
# each package's compile log counts its own events: the JAX one every
# XLA compilation inside the step (the step's eager ops too), the port's
# the first call or graph capture of the step's program
BY_DESIGN = ("compile_events",)


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _rid_counters():
    """Tests pin the rid counters; put both back after each."""
    saved = jrequest._rid_counter, trequest._rid_counter
    yield
    jrequest._rid_counter, trequest._rid_counter = saved


@pytest.fixture(scope="module")
def pair():
    """The reference tests' tiny GPT in JAX, and the port's on the same
    weights."""
    with _pinned_globals():
        return _pair("gpt")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture
def make_core(model):
    cores = []

    def make(**kw):
        for k, v in CORE_SHAPE.items():
            kw.setdefault(k, v)
        eng = PagedGenerationEngine(model, page_size=PAGE,
                                    kv_dtype=kw.pop("kv_dtype", None),
                                    device="cpu")
        core = EngineCore(eng, device="cpu", **kw)
        cores.append(core)
        return core

    yield make
    for c in cores:
        c.close()


def _drive(core, reqs, max_iters=400):
    for _ in range(max_iters):
        if all(r.done for r in reqs):
            return
        core.run_once()
    raise AssertionError("requests did not finish")


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(0, 96, (n,)).astype(np.int32)


# ------------------------------------------------------------------ tracer
def test_span_nesting_and_ordering():
    tr = Tracer()
    tr.begin(1, kind="test")
    with tr.span(1, "outer"):
        with tr.span(1, "inner_a"):
            pass
        with tr.span(1, "inner_b"):
            pass
    tr.end(1)
    spans = tr.get(1).ordered()
    assert [s.name for s in spans] == ["outer", "inner_a", "inner_b"]
    outer, a, b = spans
    assert outer.depth == 0 and outer.parent is None
    assert a.depth == 1 and a.parent == outer.sid
    assert b.depth == 1 and b.parent == outer.sid
    assert a.start <= b.start
    assert all(s.end is not None for s in spans)


def test_tracer_ring_eviction():
    tr = Tracer(ring_size=3)
    for rid in range(5):
        tr.begin(rid)
        tr.add_span(rid, "w", 0.0, 1.0)
        tr.end(rid)
    assert tr.live_count() == 0
    assert [t.rid for t in tr.completed()] == [2, 3, 4]
    assert tr.get(0) is None and tr.get(4) is not None


def test_add_span_on_completed_trace():
    tr = Tracer()
    tr.begin(7)
    tr.end(7, "done")
    assert tr.add_span(7, "detokenize", 1.0, 2.0) is not None
    assert "detokenize" in [s.name for s in tr.get(7).spans]
    assert tr.add_span(999, "x", 0, 1) is None


def test_coverage_interval_union():
    t = Trace(1)
    t.begin = 0.0
    t.add(Span("a", 0.0, 5.0))
    t.add(Span("b", 4.0, 8.0))
    t.add(Span("c", 9.0, 10.0))
    t.add(Span("nested", 0.0, 10.0, parent=1, depth=1))  # ignored
    t.finish = 10.0
    assert t.coverage() == pytest.approx(0.9)
    assert t.duration() == pytest.approx(10.0)


def test_chrome_export_round_trip():
    """The reference also parses the export with its profiler's
    ``chrome_trace_stats``, which the port does not have: the events'
    durations and arguments are checked directly."""
    tr = Tracer()
    tr.begin(42, kind="batch")
    tr.add_span(42, "queue_wait", 1.0, 1.5)
    tr.add_span(42, "decode", 1.5, 1.75, tokens=4)
    tr.end(42)
    blob = json.loads(json.dumps(tr.get(42).to_chrome()))
    evs = blob["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "request 42"
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert xs["queue_wait"]["dur"] == pytest.approx(0.5e6)
    assert xs["decode"]["dur"] == pytest.approx(0.25e6)
    assert xs["decode"]["args"]["tokens"] == 4
    assert all(e["tid"] == 42 for e in evs)


def test_trace_summaries_shape():
    tr = Tracer()
    tr.begin(5, kind="batch", prompt_len=8)
    tr.add_span(5, "queue_wait", time.monotonic(), time.monotonic())
    tr.end(5, "done")
    (s,) = tr.summaries()
    assert s["request_id"] == 5 and s["state"] == "done"
    assert s["meta"]["prompt_len"] == 8 and s["spans"] == 1


# -------------------------------------------------------- recompile detector
def test_signature_of_discriminates_shapes():
    a = np.zeros((2, 3), np.float32)
    b = np.zeros((2, 4), np.float32)
    assert signature_of((a,)) != signature_of((b,))
    assert signature_of((a,)) == signature_of((np.ones((2, 3), np.float32),))
    assert signature_of((a.astype(np.int32),)) != signature_of((a,))
    assert signature_of(({"y": 1, "x": a}, None)) == \
        signature_of(({"x": a, "y": 1}, None))


def test_compile_log_counts_and_warmup(caplog):
    log = CompileLog()
    key = ("serve-step", 4)
    log.record("serving-decode", key, ("sig1",), 0.1)
    assert log.compile_count == 1
    assert log.post_warmup_decode_compiles == 0
    assert not log.recompile_storm
    log.mark_warm("serving-decode", key)
    assert log.is_warm("serving-decode", key)
    with caplog.at_level(logging.WARNING,
                         logger="paddle_infer_tpu_torch.observability"):
        log.record("serving-decode", key, ("sig2",), 0.2)
    assert log.post_warmup_decode_compiles == 1
    assert log.post_warmup_compiles == 1
    assert any("recompile after warmup" in r.message for r in caplog.records)
    log.record("serving-decode", key, ("sig1",), 0.1)
    assert log.recompile_storm
    s = log.summary()
    assert s["compile_count"] == 3
    assert s["compile_count_by_site"] == {"serving-decode": 3}
    assert s["recompile_count"] == 1
    assert s["post_warmup_decode_compiles"] == 2
    assert s["compile_wall_s_total"] == pytest.approx(0.4)
    assert not log.is_warm("serving-decode", ("serve-step", 8))
    log.reset()
    assert log.compile_count == 0 and not log.is_warm("serving-decode", key)


# -------------------------------------------------------------- prometheus
def _fabricated_snapshot(metrics_cls=ServingMetrics):
    m = metrics_cls()
    m.on_submitted(2)
    m.on_prefill(0.05)
    m.on_tokens(4, itl_s=0.01)
    m.on_step(2.5, active=1, max_batch=4)
    m.on_completed(0.3)
    return m.snapshot(queue_depth=1, active=1, max_batch=4,
                      kv_pool={"total_blocks": 16, "used_blocks": 4,
                               "free_blocks": 12, "occupancy": 0.25})


COMPILE_SUMMARY = {
    "compile_count": 3, "compile_count_by_site": {"serving-decode": 1},
    "recompile_count": 0, "recompile_storm": False,
    "post_warmup_compiles": 0, "post_warmup_decode_compiles": 0,
    "compile_wall_s_total": 1.25}


def test_render_prometheus_valid_and_complete():
    text = render_prometheus(_fabricated_snapshot(), COMPILE_SUMMARY)
    assert validate_exposition(text) == []
    fams = family_names(text)
    assert "serving_ttft_seconds" in fams
    assert "serving_kv_pool_blocks" in fams
    assert "post_warmup_decode_compiles_total" in fams
    assert "# TYPE serving_ttft_seconds histogram" in text
    assert 'serving_ttft_seconds_bucket{le="+Inf"} 1' in text
    assert "serving_ttft_seconds_count 1" in text
    assert 'serving_ttft_seconds{stat=' not in text
    assert 'serving_decode_step_milliseconds{stat="p50_recent"}' in text
    assert 'compile_count_by_site{site="serving-decode"} 1' in text
    assert "serving_submitted_total 2" in text


def test_render_drops_none_values():
    text = render_prometheus(ServingMetrics().snapshot())
    assert validate_exposition(text) == []
    assert "None" not in text and "nan" not in text.lower()


def test_validate_exposition_catches_garbage():
    assert validate_exposition("# TYPE foo banana\nfoo 1\n")
    assert validate_exposition("foo 1\n")
    assert validate_exposition("# TYPE foo gauge\nfoo 1\nfoo 2\n")
    assert validate_exposition("# TYPE foo gauge\nfoo{bad-label=\"x\"} 1\n")
    assert validate_exposition("# TYPE foo gauge\nfoo notanumber\n")


def test_metrics_to_prometheus_convenience():
    m = ServingMetrics()
    m.on_submitted()
    assert "serving_submitted_total 1" in m.to_prometheus()


# ---------------------------------------------------------------- evidence
def test_capture_bundle_writes_manifest(tmp_path):
    tracer = Tracer()
    tracer.begin(1, kind="batch")
    tracer.add_span(1, "queue_wait", 0.0, 0.5)
    tracer.end(1)
    steplog = StepLog()
    steplog.record("decode", wall_s=0.01, bytes_est=1e6)

    class FakeCore:
        def __init__(self):
            self.tracer = tracer
            self.steplog = steplog

        def metrics_snapshot(self):
            return _fabricated_snapshot()

    out = tmp_path / "bundle"
    manifest = capture_bundle(str(out), core=FakeCore(),
                              kernel_summary="kernels: none\n",
                              extra={"note": "test"})
    for name in ("manifest.json", "device_probe.json", "compile_log.json",
                 "metrics.json", "metrics.prom", "traces.json",
                 "traces.chrome.json", "kernel_summary.txt", "extra.json",
                 "steps.jsonl", "steps_summary.json"):
        assert (out / name).exists(), name
        assert name in manifest["files"]
    assert manifest["missing"] == []
    assert json.loads((out / "steps.jsonl").read_text()
                      .splitlines()[0])["kind"] == "decode"
    with open(out / "traces.json") as f:
        assert json.load(f)["traces"][0]["request_id"] == 1
    assert validate_exposition((out / "metrics.prom").read_text()) == []
    m2 = capture_bundle(str(tmp_path / "b2"))
    assert any("metrics" in miss for miss in m2["missing"])
    assert any("traces" in miss for miss in m2["missing"])


def test_device_probe_without_a_card_names_no_gpu(tmp_path):
    """Without a card the probe records the CPU and says no GPU was
    probed; it never pretends to have found one."""
    if torch.cuda.is_available():
        pytest.skip("probes the path without a card")
    capture_bundle(str(tmp_path))
    probe = json.loads((tmp_path / "device_probe.json").read_text())
    assert probe["platform"] == "cpu" and probe["device_count"] == 0
    assert "not probed" in probe["gpu"]
    assert "memory_stats" not in probe and "error" not in probe
    assert memory_stats() is None and memory_stats("cpu") is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_memory_stats_and_probe_on_the_card(cuda_device, tmp_path):
    stats = memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_reserved", "bytes_limit"}
    assert stats["bytes_limit"] > 0
    assert memory_stats("cpu") is None
    capture_bundle(str(tmp_path))
    probe = json.loads((tmp_path / "device_probe.json").read_text())
    assert probe["platform"] == "gpu"
    assert probe["device_kind"] == torch.cuda.get_device_name(0)


# ------------------------------------------------------- lock regressions
class _LockProbe:
    def __init__(self, real):
        self.real = real
        self.entered = 0

    def __enter__(self):
        self.entered += 1
        return self.real.__enter__()

    def __exit__(self, *exc):
        return self.real.__exit__(*exc)


def test_recompile_storm_read_is_locked():
    log = CompileLog()
    log._lock = probe = _LockProbe(log._lock)
    assert log.recompile_storm is False
    assert probe.entered == 1


def test_metrics_reset_uses_instance_lock():
    m = ServingMetrics()
    m.on_submitted(2)
    m._lock = probe = _LockProbe(m._lock)
    m.reset()
    assert probe.entered == 1
    assert m.snapshot(queue_depth=0, active=0,
                      max_batch=1)["counters"]["submitted"] == 0


# --------------------------------------------------- byte stability
def _assert_sorted_everywhere(obj, path="$"):
    if isinstance(obj, dict):
        keys = list(obj)
        want = sorted(keys, key=lambda x: (str(type(x)), str(x)))
        assert keys == want, f"unsorted keys at {path}: {keys}"
        for k, v in obj.items():
            _assert_sorted_everywhere(v, f"{path}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _assert_sorted_everywhere(v, f"{path}[{i}]")


def test_sorted_tree_canonicalizes():
    a = sorted_tree({"b": 1, "a": {"z": (1, 2), "y": [{"q": 0, "p": 1}]}})
    b = sorted_tree({"a": {"y": [{"p": 1, "q": 0}], "z": [1, 2]}, "b": 1})
    assert json.dumps(a) == json.dumps(b)
    _assert_sorted_everywhere(a)
    assert list(sorted_tree({3: "x", "a": "y", 1: "z"})) == [1, 3, "a"]
    assert sorted_tree(a) == a


def test_metrics_snapshot_byte_stable():
    snap = _fabricated_snapshot()
    _assert_sorted_everywhere(snap)
    assert list(_fabricated_snapshot()) == list(snap)


def test_steplog_and_compilelog_summaries_byte_stable():
    log = StepLog()
    log.record("decode", wall_s=0.0015, decode_rows=2)
    log.record("prefill", wall_s=0.009, prefill_tokens=64)
    _assert_sorted_everywhere(log.summary())
    clog = CompileLog()
    clog.record("serving-decode", ("serve-step", 4), "sig", 0.5)
    _assert_sorted_everywhere(clog.summary())


# --------------------------------------------------------------- histogram
def test_log_bounds_are_1_2_5_series():
    bs = log_bounds(1e-3, 1.0)
    assert bs[0] == pytest.approx(1e-3)
    assert bs[-1] == pytest.approx(1.0)
    mantissas = {round(b / (10 ** np.floor(np.log10(b))), 6) for b in bs}
    assert mantissas <= {1.0, 2.0, 5.0}
    assert all(a < b for a, b in zip(bs, bs[1:]))


def test_histogram_cumulative_and_exact_counts():
    h = Histogram(bounds=[0.1, 0.2, 0.5, 1.0])
    samples = [0.05, 0.1, 0.15, 0.3, 0.7, 2.0, 2.0]
    for s in samples:
        h.observe(s)
    snap = h.snapshot()
    assert [c for _, c in snap["buckets"]] == [2, 3, 4, 5, 7]
    assert snap["buckets"][-1][0] == "+Inf"
    assert snap["count"] == len(h) == 7
    assert snap["sum"] == pytest.approx(sum(samples))


def test_histogram_quantile_tracks_numpy_percentile():
    samples = np.random.RandomState(7).lognormal(mean=-4.0, sigma=1.0,
                                                 size=4000)
    h = Histogram()
    for s in samples:
        h.observe(float(s))
    for q in (0.5, 0.9, 0.99):
        ref = float(np.percentile(samples, q * 100))
        assert h.quantile(q) == pytest.approx(ref, rel=1.5), q


def test_histogram_quantile_edge_cases():
    assert quantile(None, 0.5) is None
    assert quantile({"buckets": [], "sum": 0.0, "count": 0}, 0.5) is None
    h = Histogram(bounds=[1.0, 2.0])
    h.observe(50.0)
    assert h.quantile(0.99) == pytest.approx(2.0)
    json.dumps(h.snapshot())


def test_validate_exposition_histogram_contract():
    ok = ("# TYPE h histogram\n"
          'h_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 3\n'
          "h_sum 0.5\nh_count 3\n")
    assert validate_exposition(ok) == []
    bad = ok.replace('h_bucket{le="0.1"} 1', 'h_bucket{le="0.1"} 7')
    assert any("cumulative" in p for p in validate_exposition(bad))
    bad = ("# TYPE h histogram\n"
           'h_bucket{le="0.1"} 1\nh_sum 0.5\nh_count 1\n')
    assert any("+Inf" in p for p in validate_exposition(bad))
    assert validate_exposition(ok.replace("h_count 3", "h_count 9"))
    assert any("bare" in p for p in validate_exposition(ok + "h 1\n"))


# ----------------------------------------------------------------- steplog
def test_steplog_schema_defaults_and_rejection():
    sl = StepLog()
    rec = sl.record("decode", wall_s=0.01, decode_rows=2)
    assert set(rec) == set(SCHEMA_KEYS)
    assert rec["seq"] == 1 and rec["kind"] == "decode"
    assert rec["cost_source"] == "none" and rec["bytes_est"] == 0.0
    with pytest.raises(ValueError, match="unknown StepLog fields"):
        sl.record("decode", walls=0.01)


def test_steplog_schema_is_the_references():
    from paddle_infer_tpu.observability import steplog as jsteplog
    from paddle_infer_tpu_torch.observability import steplog as tsteplog

    assert tsteplog._SCHEMA == jsteplog._SCHEMA


def test_steplog_ring_bound_and_jsonl():
    sl = StepLog(capacity=8)
    for i in range(20):
        sl.record("decode", wall_s=0.001 * (i + 1), bytes_est=1.0)
    assert len(sl) == 8
    assert [r["seq"] for r in sl.records()] == list(range(13, 21))
    assert len(sl.records(limit=3)) == 3
    assert sl.records(limit=0) == []
    lines = sl.to_jsonl(limit=5).splitlines()
    assert len(lines) == 5
    assert all(set(json.loads(ln)) == set(SCHEMA_KEYS) for ln in lines)
    assert sl.to_jsonl().endswith("\n")
    assert StepLog().to_jsonl() == ""
    s = sl.summary()
    assert s["records"] == 20 and s["ring"] == 8 and s["capacity"] == 8
    assert s["by_kind"] == {"decode": 20}
    assert s["bytes_est_total"] == pytest.approx(20.0)


def test_steplog_model_fit_and_clear():
    sl = StepLog()
    for b in (1e6, 2e6, 3e6, 5e6):
        sl.record("decode", wall_s=b * 2e-9, bytes_est=b)
    sl.record("decode", wall_s=9.9, bytes_est=4e6, failed=True)
    sl.record("decode", wall_s=9.9, bytes_est=0.0)
    m = sl.summary()["decode_model"]
    assert m["n"] == 4
    assert m["scale_s_per_byte"] == pytest.approx(2e-9)
    assert m["mean_abs_rel_err"] == pytest.approx(0.0, abs=1e-9)
    assert m["pearson_r"] == pytest.approx(1.0)
    cal = sl.calibration()
    assert cal["scale_s_per_byte"] == pytest.approx(2e-9)
    assert cal["n_decode"] == 4
    sl.clear()
    assert len(sl) == 0
    assert sl.summary()["decode_model"]["n"] == 0
    assert sl.record("evict")["seq"] > 4


def test_steplog_model_degenerate_cases():
    sl = StepLog()
    sl.record("decode", wall_s=0.01, bytes_est=1e6)
    assert sl.summary()["decode_model"]["scale_s_per_byte"] is None
    sl.record("decode", wall_s=0.02, bytes_est=1e6)
    m = sl.summary()["decode_model"]
    assert m["scale_s_per_byte"] is not None
    assert m["pearson_r"] is None


def test_render_prometheus_steplog_and_device_memory():
    m = ServingMetrics()
    m.on_prefill(0.05)
    m.on_tokens(4, itl_s=0.01)
    m.on_step(2.0, active=1, max_batch=2)
    m.on_queue_wait(0.003)
    m.on_completed(0.2)
    sl = StepLog()
    sl.record("decode", wall_s=0.01, bytes_est=1e6, cost_source="analytic")
    sl.record("decode", wall_s=0.03, bytes_est=2e6, cost_source="analytic")
    snap = m.snapshot(steplog=sl.summary(),
                      device_memory={"bytes_in_use": 4096,
                                     "num_allocs": 3})
    text = render_prometheus(snap)
    assert validate_exposition(text) == []
    for fam in ("serving_ttft_seconds", "serving_inter_token_latency_seconds",
                "serving_e2e_latency_seconds", "serving_step_wall_seconds",
                "serving_queue_wait_seconds"):
        assert f"# TYPE {fam} histogram" in text, fam
        assert f'{fam}_bucket{{le="+Inf"}}' in text, fam
    assert 'steplog_records_total{kind="decode"} 2' in text
    assert "steplog_bytes_estimated_total 3e+06" in text
    assert "steplog_model_abs_rel_error" in text
    assert 'device_memory_bytes{kind="bytes_in_use"} 4096' in text
    assert "num_allocs" not in text


# ------------------------------------------------- cost model + integration
def test_cost_model_estimates(make_core):
    core = make_core(max_batch=2)
    cm = StepCostModel(core._engine, core._pool)
    # 2 layers * (K+V) * 4 heads * page 8 * head_dim 8 * fp32
    assert cm.page_kv_bytes == pytest.approx(2 * 2 * 4 * 8 * 8 * 4)
    b, f, src = cm.estimate("evict", pages_touched=3)
    assert (b, f, src) == (3 * cm.page_kv_bytes, 0.0, "analytic")
    b, f, src = cm.estimate("page_copy", pages_touched=1)
    assert (b, src) == (2 * cm.page_kv_bytes, "analytic")
    b, f, src = cm.estimate("decode", rows=2, pages_touched=4, chunk=4)
    assert src == "analytic" and b > 0 and f > 0
    assert cm.interconnect(16) == (0.0, 0.0)


def test_steplog_records_every_bench_style_step(make_core):
    """A bench-style run gives one record per step with nonzero
    ``bytes_est``, the decode model fits, and the snapshot renders to a
    valid exposition with at least 5 histogram families."""
    core = make_core(max_batch=2)
    rng = np.random.RandomState(0)
    g = GenerationConfig(max_new_tokens=6)
    for n in (8, 16, 8, 16):
        (r,) = core.submit(rng.randint(0, 96, (n,)).astype(np.int32), g)
        _drive(core, [r])
    recs = core.steplog.records()
    assert {"prefill", "decode", "evict"} <= {r["kind"] for r in recs}
    steps = [r for r in recs if r["kind"] in ("prefill", "decode", "mixed")]
    assert len(steps) == core._step_idx
    for r in steps:
        assert r["bytes_est"] > 0 and r["flops_est"] > 0, r
        assert r["cost_source"] == "analytic"
        assert r["dispatch_s"] <= r["wall_s"] + 1e-9
        assert r["wall_s"] == pytest.approx(r["dispatch_s"] + r["host_s"])
        assert r["chunk_steps"] == 1 and r["kernel"] == "ragged"
    model = core.steplog.summary()["decode_model"]
    assert model["n"] >= 2 and model["scale_s_per_byte"] > 0
    assert model["mean_abs_rel_err"] is not None

    snap = core.metrics_snapshot()
    assert snap["steplog"]["records"] == len(recs)
    assert "device_memory" not in snap        # no allocator on the CPU
    hists = snap["histograms"]
    assert {"ttft", "itl", "e2e", "step_wall", "queue_wait"} <= set(hists)
    assert all(h["count"] > 0 for k, h in hists.items()
               if k in ("ttft", "e2e", "step_wall", "queue_wait"))
    text = render_prometheus(snap)
    assert validate_exposition(text) == []
    n_hist = sum(1 for ln in text.splitlines()
                 if ln.startswith("# TYPE") and ln.endswith(" histogram"))
    assert n_hist >= 5


def test_traces_cover_each_request(make_core):
    """Every finished trace's spans chain edge to edge (coverage >= 0.95,
    as the reference's engine test holds) and every journey's buckets
    sum to its e2e with coverage >= 0.97."""
    core = make_core()
    g = GenerationConfig(max_new_tokens=6)
    reqs = [core.submit(_prompt(s, n), g)[0]
            for s, n in ((1, 30), (2, 5), (3, 17), (4, 9))]
    _drive(core, reqs)
    for r in reqs:
        tr = core.tracer.get(r.rid)
        assert tr.state == "done" and tr.coverage() >= 0.95, tr.to_dict()
        j = core._journeys.get(r.rid)
        assert abs(sum(j["buckets"].values()) - j["e2e_s"]) < 1e-5
        assert j["coverage"] >= 0.97
    assert core._journeys.summary()["count"] == len(reqs)


def test_page_kv_bytes_by_pool_dtype(model, pair):
    """fp32 and bf16 pools price their torch item size, int8 pools one
    byte plus the slot-0 scales; fp32 and int8 equal the reference's."""
    L, H, D = 2, 4, 8
    fp = L * 2 * H * PAGE * D
    want = {None: fp * 4, torch.bfloat16: fp * 2,
            "int8": fp + L * 2 * H * 4}
    for key, bytes_ in want.items():
        eng = PagedGenerationEngine(
            model, page_size=PAGE, device="cpu",
            kv_dtype="int8" if key == "int8" else None,
            cache_dtype=key if isinstance(key, torch.dtype) else None)
        assert StepCostModel(eng, None).page_kv_bytes == bytes_, key
    jm = pair[0]
    for kv in (None, "int8"):
        jeng = JEngine(jm, page_size=PAGE, kv_dtype=kv)
        teng = PagedGenerationEngine(model, page_size=PAGE, kv_dtype=kv,
                                     device="cpu")
        jcm = JCostModel(jeng, jeng.serving_pool(8))
        assert StepCostModel(teng).page_kv_bytes == jcm.page_kv_bytes


def test_weight_bytes_equal_the_references(model, pair):
    """The GPT head reads the word embedding (one tensor in both
    packages), so both count it once: ``named_parameters()`` and the
    JAX tree hold the same tensors."""
    jeng = JEngine(pair[0], page_size=PAGE)
    teng = PagedGenerationEngine(model, page_size=PAGE, device="cpu")
    jw = JCostModel(jeng, jeng.serving_pool(8))._weights()
    assert StepCostModel(teng)._weights() == jw


# ------------------------------------------------------- journey: attribute
def test_attribute_partitions_exactly():
    intervals = [
        (0.0, 2.0, "queue_wait", 4),
        (1.5, 4.0, "prefill_compute", 3),
        (4.5, 6.0, "decode_compute", 3),
        (5.0, 5.5, "parked", 5),
    ]
    out = attribute(intervals, 0.0, 7.0)
    assert set(out) == set(BUCKETS)
    assert abs(sum(out.values()) - 7.0) < 1e-12
    assert out["queue_wait"] == pytest.approx(2.0)
    assert out["prefill_compute"] == pytest.approx(2.0)
    assert out["decode_compute"] == pytest.approx(1.0)
    assert out["parked"] == pytest.approx(0.5)
    assert out["other"] == pytest.approx(1.5)


def test_attribute_clips_to_window():
    out = attribute([(-5.0, 20.0, "decode_compute", 3)], 1.0, 3.0)
    assert out["decode_compute"] == pytest.approx(2.0)
    assert sum(out.values()) == pytest.approx(2.0)


def test_tenant_label_isolation(make_core):
    """Tenants are accounting labels: each tenant's series carry exactly
    its own label, untenanted traffic lands under ``default``, and every
    exemplar journey id maps back to a journey of that tenant."""
    core = make_core()
    store = core._journeys
    g = GenerationConfig(max_new_tokens=6)
    reqs = [core.submit(_prompt(11), g, tenant="gold")[0],
            core.submit(_prompt(12), g, tenant="free")[0],
            core.submit(_prompt(13), g)[0]]
    _drive(core, reqs)
    snap = core.metrics_snapshot()
    tn = snap.get("tenants") or {}
    assert set(tn) == {"gold", "free", "default"}
    for name in tn:
        assert tn[name]["requests"] == 1
        assert tn[name]["tokens"] > 0
        assert tn[name]["parked_seconds"] == 0.0
    text = render_prometheus(snap)
    assert validate_exposition(text) == []
    for name in ("gold", "free", "default"):
        assert f'tenant_requests_total{{tenant="{name}"}} 1' in text
    for name, t in tn.items():
        assert t["exemplars"], f"tenant {name} has no exemplar"
        for ex in t["exemplars"].values():
            j = store.get(ex["journey_id"])
            assert j is not None
            assert (j["tenant"] or "default") == name
    s = store.summary()
    assert s["count"] == 3 and s["hops_total"] == 0
    assert s["attribution_coverage"] >= 0.97


def test_tenant_never_enters_scheduling_or_the_cache(make_core):
    """The same prompts with and without tenant labels give the same
    streams, and a tenant label shares cached KV like no label does."""
    runs = []
    for tenants in ((None, None), ("gold", "free")):
        trequest._rid_counter = itertools.count(70)
        core = make_core(enable_prefix_cache=True)
        g = GenerationConfig(max_new_tokens=5)
        reqs = []
        for t in tenants:
            (r,) = core.submit(_prompt(21, 20), g, tenant=t)
            _drive(core, [r])
            reqs.append(r)
        runs.append(([r.tokens for r in reqs],
                     core.prefix_cache.stats_snapshot()["hits"]))
    assert runs[0] == runs[1] and runs[0][1] == 1


# ------------------------------------------------------ module parity
def test_histogram_equals_the_references():
    samples = np.random.RandomState(3).lognormal(-3.0, 1.5, 500)
    th, jh = Histogram(), jhistogram.Histogram()
    for s in samples:
        th.observe(float(s))
        jh.observe(float(s))
    assert th.snapshot() == jh.snapshot()
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert log_bounds(1e-3, 10.0) == jhistogram.log_bounds(1e-3, 10.0)


def test_attribute_equals_the_references():
    rs = np.random.RandomState(4)
    names = list(BUCKETS[:-1])
    for _ in range(20):
        ivals = []
        for _ in range(8):
            a = float(rs.uniform(-1.0, 9.0))
            ivals.append((a, a + float(rs.uniform(0.0, 3.0)),
                          names[rs.randint(len(names))],
                          int(rs.randint(2, 6))))
        assert attribute(ivals, 0.0, 10.0) == \
            jjourney.attribute(ivals, 0.0, 10.0)


def test_render_prometheus_equals_the_references():
    """The same snapshot dict renders to the same text: a fabricated
    one from each package's metrics, with every section the renderer
    reads filled."""
    from paddle_infer_tpu.serving.metrics import \
        ServingMetrics as JMetrics

    for cls in (ServingMetrics, JMetrics):
        snap = _fabricated_snapshot(cls)
        m = cls()
        m.on_journey("gold", 0.4, 5, True, {"queue_wait": 0.1,
                                            "decode_compute": 0.3},
                     1.0, "j7")
        snap.update({
            "tenants": m.snapshot()["tenants"],
            "steplog": StepLog().summary(),
            "journeys": JourneyStore().summary(),
            "device_memory": {"bytes_in_use": 10, "bytes_limit": 99},
            "prefix_cache": {"queries": 3, "hits": 1, "cached_blocks": 2},
            "kv_quant": {"kv_dtype": "int8", "bytes_per_page": 64,
                         "fp_bytes_per_page": 256,
                         "scale_bytes_per_page": 8,
                         "resident_page_ratio": 4.0}})
        assert render_prometheus(snap, COMPILE_SUMMARY) == \
            jprometheus.render_prometheus(snap, COMPILE_SUMMARY)


# ------------------------------------------------------- core parity
def _run_core(core, G, rid_mod):
    """The resilience tests' workload (a warm-up request, then 8 at once:
    repeats of a cached prompt, a longer prompt sharing its pages, 2
    sampled rows, unrelated prompts) on ``core``; returns its step-log
    records, span names per rid, streams and snapshot."""
    rid_mod._rid_counter = itertools.count(300)
    prompts, cfgs = _workload()
    try:
        (w,) = core.submit(_prompt(79), G(max_new_tokens=4))
        _drive(core, [w])
        reqs = [core.submit(p, G(**kw))[0] for p, kw in zip(prompts, cfgs)]
        _drive(core, reqs, max_iters=800)
        spans = {r.rid: [s.name for s in core.tracer.get(r.rid).ordered()]
                 for r in [w] + reqs}
        return {"records": core.steplog.records(), "spans": spans,
                "streams": [list(r.tokens) for r in reqs],
                "snapshot": core.metrics_snapshot()}
    finally:
        core.close()


def _comparable(rec):
    return {k: v for k, v in rec.items()
            if k not in CLOCK_FIELDS + PLANNER_FIELDS + BY_DESIGN}


def _families(snap):
    text = render_prometheus(snap, COMPILE_SUMMARY)
    assert validate_exposition(text) == []
    return {f for f in family_names(text) if not f.startswith("sched_")}


CORE_CASES = {
    "plain": dict(),
    "prefix": dict(enable_prefix_cache=True,
                   prefix_cache_headroom_pages=8),
    "spec": dict(speculate=True, num_draft_tokens=3,
                 draft_source="ngram"),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_core_records_spans_and_families_equal_jax(pair, monkeypatch,
                                                   case):
    jm, tm = pair
    kw = dict(CORE_SHAPE, **CORE_CASES[case])
    with _pinned_globals():
        jeng = JEngine(jm, page_size=PAGE)
        # both cost models analytic: the JAX engine offers no XLA cost
        monkeypatch.setattr(jeng, "program_cost", None)
        want = _run_core(JCore(jeng, **kw), JGen, jrequest)
        got = _run_core(EngineCore(PagedGenerationEngine(
            tm, page_size=PAGE, device="cpu"), device="cpu", **kw),
            GenerationConfig, trequest)
    assert got["streams"] == want["streams"]
    jrecs, trecs = want["records"], got["records"]
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    for t, j in zip(trecs, jrecs):
        assert _comparable(t) == _comparable(j), (t, j)
        assert t["cost_source"] == "analytic"
    assert {r["kind"] for r in trecs} >= {"evict", "prefill"} | (
        {"page_copy"} if case == "prefix" else set())
    if case == "spec":
        assert sum(r["draft_tokens"] for r in trecs) > 0
    assert got["spans"] == want["spans"]
    assert _families(got["snapshot"]) == _families(want["snapshot"])
    sched = {f for f in family_names(render_prometheus(want["snapshot"]))
             if f.startswith("sched_")}
    assert sched and not any(f.startswith("sched_") for f in family_names(
        render_prometheus(got["snapshot"])))


def _supervised(core, sup, G, rid_mod):
    rid_mod._rid_counter = itertools.count(300)
    prompts, cfgs = _workload()
    try:
        (w,) = core.submit(_prompt(79), G(max_new_tokens=4))
        _drive(sup, [w])
        reqs = [core.submit(p, G(**kw))[0] for p, kw in zip(prompts, cfgs)]
        _drive(sup, reqs, max_iters=800)
        recovery = {r.rid: [(s.attrs["retry"], s.attrs["cause"])
                            for s in core.tracer.get(r.rid).ordered()
                            if s.name == "recovery"]
                    for r in [w] + reqs}
        failed = [r for r in core.steplog.records() if r["failed"]]
        return {"recovery": recovery, "failed": failed,
                "states": [r.state.value for r in reqs],
                "snapshot": core.metrics_snapshot()}
    finally:
        sup.close()


def test_failed_records_and_recovery_spans_equal_jax(pair, monkeypatch):
    """Under the resilience tests' fault script (every site, KV intact
    and lost, a poisoned row): the failed step, admission and evict
    records and the recovery spans are the JAX core's."""
    jm, tm = pair
    kw = dict(CORE_SHAPE, enable_prefix_cache=True,
              prefix_cache_headroom_pages=8)
    sup_kw = dict(max_retries=3, crash_threshold=10, recover_after=4,
                  backoff_base_s=0.0)
    with _pinned_globals():
        jeng = JEngine(jm, page_size=PAGE)
        monkeypatch.setattr(jeng, "program_cost", None)
        jcore = JCore(jeng, fault_plane=jfaultplane.FaultPlane.from_spec(
            SCRIPT), **kw)
        want = _supervised(jcore, JSupervisor(jcore, **sup_kw), JGen,
                           jrequest)
        tcore = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                                 device="cpu"),
                           fault_plane=FaultPlane.from_spec(SCRIPT),
                           device="cpu", **kw)
        got = _supervised(tcore, EngineSupervisor(tcore, **sup_kw),
                          GenerationConfig, trequest)
    assert got["states"] == want["states"]
    assert got["recovery"] == want["recovery"]
    assert sum(len(v) for v in got["recovery"].values()) >= 4
    assert [r["kind"] for r in got["failed"]] == \
        [r["kind"] for r in want["failed"]]
    for t, j in zip(got["failed"], want["failed"]):
        if t["kind"] == "prefill":
            # a failed admission's hit pages: the reference reads its
            # match after releasing it (always 0), the port before
            assert t["prefix_hit_pages"] >= j["prefix_hit_pages"] == 0
            t = dict(t, prefix_hit_pages=0)
        assert _comparable(t) == _comparable(j), (t, j)
    assert any(t["prefix_hit_pages"] for t in got["failed"])
    # one failed record per failed step and per failed admission, and
    # the quarantined row's evict
    assert len(got["failed"]) >= 6
    res = got["snapshot"]["resilience"]
    text = render_prometheus(got["snapshot"])
    assert validate_exposition(text) == []
    assert f"engine_restarts_total {res['engine_restarts']}" in text
    for site, n in res["faults_injected"].items():
        assert f'faults_injected_total{{site="{site}"}} {n}' in text
    assert _families(got["snapshot"]) == _families(want["snapshot"])


def test_step_records_count_the_runs_first_calls(make_core):
    """``compile_events`` counts the compile log's events inside each
    step: the first mixed step holds the serve step's one first call,
    every later one none, and nothing is recorded after warm-up."""
    from paddle_infer_tpu_torch.observability import get_compile_log

    log = get_compile_log()
    log.reset()
    core = make_core()
    g = GenerationConfig(max_new_tokens=4)
    reqs = [core.submit(_prompt(s, 10), g)[0] for s in (41, 42)]
    _drive(core, reqs)
    steps = [r for r in core.steplog.records()
             if r["kind"] in ("mixed", "prefill", "decode")]
    assert [r["compile_events"] for r in steps] == \
        [1] + [0] * (len(steps) - 1)
    assert log.summary()["post_warmup_decode_compiles"] == 0
