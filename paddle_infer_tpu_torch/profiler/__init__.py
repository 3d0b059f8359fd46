"""Profiling helpers of the port: the device-memory probe."""
from .statistic import memory_stats

__all__ = ["memory_stats"]
