"""Coordinator: scheduling, leases, and both wire services in one process."""

from distributedmandelbrot_tpu_torch.coordinator.app import Coordinator
from distributedmandelbrot_tpu_torch.coordinator.clock import (Clock, ManualClock,
                                                         MonotonicClock)
from distributedmandelbrot_tpu_torch.coordinator.dataserver import DataServer
from distributedmandelbrot_tpu_torch.coordinator.distributer import Distributer
from distributedmandelbrot_tpu_torch.coordinator.embed import EmbeddedCoordinator
from distributedmandelbrot_tpu_torch.coordinator.scheduler import (Lease,
                                                             TileScheduler)

__all__ = ["Coordinator", "Clock", "ManualClock", "MonotonicClock",
           "DataServer", "Distributer", "EmbeddedCoordinator", "Lease",
           "TileScheduler"]
