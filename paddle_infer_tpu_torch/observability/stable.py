"""Canonical rendering for observability payloads.

Port of ``paddle_infer_tpu/observability/stable.py`` (unchanged).

Every snapshot/summary dict this package (and the serving metrics
plane) hands to serialization is passed through :func:`sorted_tree`
first, so the JSON bodies of a metrics snapshot, a step-log summary
and the evidence bundle are byte-stable: two replicas with identical
state render identical bytes regardless of the insertion history of the
underlying dicts, without ``sort_keys=True`` at every dump site.

Keys are ordered by ``str()`` so mixed-type keys (int site ids next to
string names) still sort deterministically where ``json.dumps(...,
sort_keys=True)`` would raise.
"""
from __future__ import annotations

__all__ = ["sorted_tree"]


def sorted_tree(obj):
    """Recursively rebuild ``obj`` with dict keys in sorted order.
    Lists/tuples keep their element order (sequences are
    semantically ordered); tuples become lists, matching what JSON
    serialization does anyway."""
    if isinstance(obj, dict):
        return {k: sorted_tree(obj[k])
                for k in sorted(obj, key=lambda x: (str(type(x)), str(x)))}
    if isinstance(obj, (list, tuple)):
        return [sorted_tree(v) for v in obj]
    return obj
