"""Observability of the port (``paddle_infer_tpu/observability/``):

  ``tracing``     span-based per-request traces (queue wait → prefill
                  chunks → decode steps → evict) with a bounded ring of
                  completed traces and Chrome-trace export;
  ``compilelog``  the process-wide graph-capture (CPU: first-call) log
                  behind the one-graph-per-key invariant;
  ``prometheus``  text-exposition renderer and validator for the serving
                  metrics snapshot;
  ``steplog``     step-level flight recorder: one schema-fixed record
                  per scheduler step event with its analytic bytes/FLOPs
                  and the dispatch-against-host wall split, plus the
                  rolling model-against-measured fit;
  ``histogram``   log-bucketed lock-safe latency histograms rendered as
                  native Prometheus ``_bucket``/``_sum``/``_count``
                  families;
  ``journey``     request journeys: each finished request's e2e wall
                  partitioned into named attribution buckets;
  ``evidence``    one-shot bundle capture (device probe with the
                  allocator counters, compile log, trace sample, step
                  ring, metrics snapshot).
"""
from .compilelog import (CompileEvent, CompileLog, get_compile_log,
                         instrument_first_calls, signature_of)
from .evidence import capture_bundle
from .histogram import Histogram
from .journey import BUCKETS as JOURNEY_BUCKETS
from .journey import JourneyStore
from .prometheus import (family_names, render_prometheus,
                         validate_exposition)
from .stable import sorted_tree
from .steplog import StepCostModel, StepLog
from .tracing import Span, Trace, Tracer

__all__ = [
    "CompileEvent",
    "CompileLog",
    "get_compile_log",
    "instrument_first_calls",
    "signature_of",
    "Span",
    "Trace",
    "Tracer",
    "JourneyStore",
    "JOURNEY_BUCKETS",
    "Histogram",
    "StepLog",
    "StepCostModel",
    "render_prometheus",
    "validate_exposition",
    "family_names",
    "capture_bundle",
    "sorted_tree",
]
