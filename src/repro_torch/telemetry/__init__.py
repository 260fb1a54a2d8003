"""Observability: round telemetry, the trace sink, phase timing.

A sibling of ``repro_torch.federated``: the round plan imports only
``telemetry.round``'s tensor helpers from here; everything host-side (sink,
timer, JSONL reader) lives behind this namespace.
"""
from repro_torch.telemetry.round import (HEAT_BUCKETS, STALENESS_BUCKETS,
                                         RoundTelemetry, drop_stats,
                                         heat_histogram, split_rounds,
                                         staleness_histogram,
                                         telemetry_to_host, tree_agg_rows,
                                         tree_sq_per_client, tree_sq_sum,
                                         union_ids_vec, valid_feature_ids)
from repro_torch.telemetry.sink import TraceSink, read_events
from repro_torch.telemetry.timer import PhaseTimer

__all__ = [
    "HEAT_BUCKETS",
    "PhaseTimer",
    "RoundTelemetry",
    "STALENESS_BUCKETS",
    "TraceSink",
    "drop_stats",
    "heat_histogram",
    "read_events",
    "split_rounds",
    "staleness_histogram",
    "telemetry_to_host",
    "tree_agg_rows",
    "tree_sq_per_client",
    "tree_sq_sum",
    "union_ids_vec",
    "valid_feature_ids",
]
