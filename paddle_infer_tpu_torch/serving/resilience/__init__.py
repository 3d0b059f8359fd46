"""Fault tolerance for the serving engine: deterministic fault
injection (FaultPlane), supervised recovery (EngineSupervisor) and the
health state machine.  Port of ``paddle_infer_tpu/serving/resilience/``
over the port's ragged ``EngineCore``."""
from .faultplane import (FaultPlane, FaultSpec, InjectedFault,
                         InjectedMemoryError, NULL_PLANE, SITES)
from .health import HealthMonitor, HealthState
from .supervisor import EngineSupervisor

__all__ = ["FaultPlane", "FaultSpec", "InjectedFault",
           "InjectedMemoryError", "NULL_PLANE", "SITES",
           "HealthMonitor", "HealthState", "EngineSupervisor"]
