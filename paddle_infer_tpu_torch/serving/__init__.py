"""Continuous-batching serving plane of the port (ragged path), with
its fault tolerance (``resilience``)."""
from .engine_core import EngineCore
from .metrics import ServingMetrics
from .request import (DeadlineExceededError, LoadShedError,
                      QuarantinedError, QueueFullError, RejectedError,
                      Request, RequestQueue, RequestState)
from .resilience import (EngineSupervisor, FaultPlane, FaultSpec,
                         HealthMonitor, HealthState)

__all__ = ["EngineCore", "ServingMetrics", "DeadlineExceededError",
           "LoadShedError", "QuarantinedError", "QueueFullError",
           "RejectedError", "Request", "RequestQueue", "RequestState",
           "EngineSupervisor", "FaultPlane", "FaultSpec", "HealthMonitor",
           "HealthState"]
