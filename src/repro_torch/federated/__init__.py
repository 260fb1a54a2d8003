"""Federated rounds: plans, the trainer, the buffered-async engine."""
from repro_torch.federated.arrivals import ArrivalSim, EventSchedule  # noqa: F401
from repro_torch.federated.async_engine import (  # noqa: F401
    AsyncEngine,
    AsyncState,
    BufferedAsyncServerUpdate,
    build_async_engine,
    staleness_weight,
)

__all__ = [
    "ArrivalSim",
    "AsyncEngine",
    "AsyncState",
    "BufferedAsyncServerUpdate",
    "EventSchedule",
    "build_async_engine",
    "staleness_weight",
]
