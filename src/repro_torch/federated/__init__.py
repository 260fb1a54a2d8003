"""Federated rounds: plans, the trainer, the buffered-async engine."""
from repro_torch.federated.arrivals import ArrivalSim, EventSchedule  # noqa: F401
from repro_torch.federated.async_engine import (  # noqa: F401
    AsyncEngine,
    AsyncState,
    BufferedAsyncServerUpdate,
    build_async_engine,
    staleness_weight,
)
from repro_torch.federated.plan import CohortSharding  # noqa: F401
from repro_torch.launch.mesh import make_cohort_mesh  # noqa: F401

__all__ = [
    "ArrivalSim",
    "AsyncEngine",
    "AsyncState",
    "BufferedAsyncServerUpdate",
    "CohortSharding",
    "EventSchedule",
    "build_async_engine",
    "make_cohort_mesh",
    "staleness_weight",
]
