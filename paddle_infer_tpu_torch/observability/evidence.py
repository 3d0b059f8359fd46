"""One-shot evidence bundle capture.

Port of ``paddle_infer_tpu/observability/evidence.py``: everything a
run's record needs goes into ONE directory in one call — device probe,
compile (graph-capture) log, kernel summary, a serving trace sample
(request spans and their Chrome export), the step log, the metrics
snapshot in both JSON and Prometheus text — plus a ``manifest.json``
naming every file, so "is the evidence complete" is a one-directory
check.  Callable from a live server for a production snapshot.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time
from typing import Optional

from .compilelog import get_compile_log
from .prometheus import render_prometheus


def _device_probe() -> dict:
    """The card the process runs on, through ``torch.cuda``: name,
    compute capability, memory, power limit and the allocator counters.
    Without a card the probe records the host CPU and says that no GPU
    was probed."""
    import torch

    probe = {"captured_at": time.time(), "torch_version": torch.__version__}
    try:
        if not torch.cuda.is_available():
            probe.update({"platform": "cpu",
                          "device_kind": platform.processor()
                          or platform.machine(),
                          "device_count": 0,
                          "gpu": "not probed: no CUDA device available"})
            return probe
        from ..profiler.statistic import memory_stats

        props = torch.cuda.get_device_properties(0)
        probe.update({
            "platform": "gpu",
            "cuda_version": torch.version.cuda,
            "device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(min(torch.cuda.device_count(), 16))],
            "capability": list(torch.cuda.get_device_capability(0)),
            "memory_total_bytes": int(props.total_memory),
            "power_limit_w": _power_limit_w(),
            "memory_stats": memory_stats(0)})
    except Exception as e:
        probe["error"] = repr(e)
    return probe


def _power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, as ``nvidia-smi`` reports
    it (``torch.cuda`` exposes the draw, not the limit), or None where
    it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10, check=True)
        return float(out.stdout.splitlines()[0])
    except Exception:
        return None


def capture_bundle(out_dir: str, *, core=None, snapshot: Optional[dict] = None,
                   kernel_summary: Optional[str] = None,
                   trace_limit: int = 8,
                   extra: Optional[dict] = None) -> dict:
    """Write the evidence bundle into ``out_dir`` and return the
    manifest.  ``core`` (a ``serving.EngineCore``) supplies the metrics
    snapshot and trace sample when given; ``snapshot`` overrides or
    substitutes for it.  Every section is best-effort: a missing piece
    is recorded in the manifest as absent, never raises."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"captured_at": time.time(), "files": {}, "missing": []}

    def write(name: str, payload, text: bool = False):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            if text:
                f.write(payload)
            else:
                json.dump(payload, f, indent=1, default=repr)
        manifest["files"][name] = os.path.getsize(path)

    write("device_probe.json", _device_probe())

    log = get_compile_log()
    write("compile_log.json", {
        "summary": log.summary(),
        "events": [e.to_dict() for e in log.events()]})

    if snapshot is None and core is not None:
        try:
            snapshot = core.metrics_snapshot()
        except Exception as e:
            manifest["missing"].append(f"metrics: {e!r}")
    if snapshot is not None:
        write("metrics.json", snapshot)
        try:
            write("metrics.prom",
                  render_prometheus(snapshot, log.summary()), text=True)
        except Exception as e:
            manifest["missing"].append(f"metrics.prom: {e!r}")
    else:
        manifest["missing"].append("metrics: no core or snapshot given")

    steplog = getattr(core, "steplog", None)
    if steplog is not None:
        write("steps.jsonl", steplog.to_jsonl(limit=512), text=True)
        write("steps_summary.json", steplog.summary())
    else:
        manifest["missing"].append("steps: no steplog available")

    tracer = getattr(core, "tracer", None)
    if tracer is not None:
        done = tracer.completed()[-trace_limit:]
        write("traces.json", {
            "summaries": tracer.summaries()[-trace_limit:],
            "traces": [t.to_dict() for t in done]})
        merged = {"traceEvents": []}
        for t in done:
            merged["traceEvents"].extend(t.to_chrome()["traceEvents"])
        write("traces.chrome.json", merged)
    else:
        manifest["missing"].append("traces: no tracer available")

    if kernel_summary is not None:
        write("kernel_summary.txt", kernel_summary, text=True)
    else:
        manifest["missing"].append("kernel_summary: not captured")

    if extra:
        write("extra.json", extra)

    write("manifest.json", manifest)
    return manifest
