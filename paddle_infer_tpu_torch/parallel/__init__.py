"""The one-device subset of fleet (``DistributedStrategy``,
``fleet.init``, ``FleetTrainStep``)."""
from . import fleet
from .fleet import DistributedStrategy, FleetTrainStep

__all__ = ["DistributedStrategy", "FleetTrainStep", "fleet"]
