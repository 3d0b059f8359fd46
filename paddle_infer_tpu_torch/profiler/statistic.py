"""The device-memory probe of ``paddle_infer_tpu/profiler/statistic.py``.

Only ``memory_stats()`` is ported: the serving snapshot's
``device_memory`` section and the evidence bundle's device probe read
it.  The reference returns XLA's allocator counters; here the caching
allocator's (``torch.cuda.memory_stats``) and the driver's
(``torch.cuda.mem_get_info``) fill the same keys, so the
``device_memory_bytes{kind=...}`` gauge has the same kinds in both
packages.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["memory_stats"]


def memory_stats(device=None) -> Optional[dict]:
    """The card's allocator counters under the reference's keys:
    ``bytes_in_use`` (tensors allocated now), ``peak_bytes_in_use``
    (their peak since the process started or the peak was reset),
    ``bytes_reserved`` (held by the caching allocator) and
    ``bytes_limit`` (the card's memory) of ``device`` (the current card
    when None).  None for a CPU device or without a card, as the
    reference's on a backend whose allocator exposes no counters."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(total)}
