"""Round telemetry: what a federated round did to which rows.

FedSubAvg's claim is about which rows move and how they are weighted;
losses and comm bytes alone cannot show it. :class:`RoundTelemetry` holds
one round's counters, computed by the round step itself from the tensors it
consumed (``build_round_step(telemetry=True)`` puts it under
``metrics["telemetry"]``), so the numbers describe the round that ran:

``dropped_ids`` / ``dropped_mass`` / ``dropped_per_client``
    ``unique_ids_padded`` drops the largest ids when a client's distinct
    feature count exceeds its sub-id capacity. ``dropped_ids`` counts the
    distinct ids lost, ``dropped_mass`` the batch occurrences referencing
    them.
``union_size`` / ``shard_union_sizes`` / ``agg_rows``
    Distinct ids across the cohort's submodels; per-shard union sizes on a
    cohort-sharded round (one per rank; ``None`` unsharded); and the valid
    rows of the aggregated RowSparse update (after top-k).
``delta_norm_pre`` / ``delta_norm_post``
    L2 of the transported update stack before and after wire compression
    (top-k, int8).
``heat_hist``
    Histogram of the union ids' heat in log2 buckets: the paper's hot/cold
    split as a per-round metric.
``density``
    ``union_size / V``.
``staleness_hist`` / ``buffer_occupancy``
    Buffered-async engine only (:mod:`repro_torch.federated.async_engine`):
    the staleness of a fire's aggregated arrivals, and the deltas in flight
    at the fire. ``None`` on every synchronous path.

Fields that do not apply to a layout are ``None``; the scalar drop counters
are zero where there is no capacity contract (dense transport), so the
JSONL schema stays the same. Every counter is a plain tensor op on the
round's device; none launches a kernel of its own.

Heat buckets follow the documented contract exactly: bucket ``b`` holds
heats in ``[2^b, 2^{b+1})``, the exponent read by ``torch.frexp``. A
rounded ``log2`` can fall one ulp short at a power of two (JAX on the CPU
puts 8,192 in bucket 12 and 32,768 in bucket 14); this module does not.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.sparse.rowsparse import (count_unique_ids, is_rowsparse,
                                          membership, unique_ids_padded)

#: log2 heat buckets: bucket b holds union ids with heat in [2^b, 2^{b+1})
#: (bucket 0 also holds h <= 1); 16 buckets cover cohorts of 65k clients.
HEAT_BUCKETS = 16

#: linear staleness buckets: bucket s counts buffered arrivals dispatched s
#: server versions ago (the last bucket absorbs the tail).
STALENESS_BUCKETS = 16


class RoundTelemetry(NamedTuple):
    """One round's counters (see the module docstring)."""

    dropped_ids: Any            # i32 scalar: distinct ids dropped by capacity
    dropped_mass: Any           # f32 scalar: batch occurrences of dropped ids
    dropped_per_client: Any     # (K,) i32 | None (per-client layouts only)
    union_size: Any             # i32 scalar: distinct ids across submodels
    agg_rows: Any               # i32 scalar | None: aggregated RowSparse rows
    shard_union_sizes: Any      # (ranks,) i32 | None (cohort-sharded rounds only)
    delta_norm_pre: Any         # f32 scalar: L2 of the raw update stack
    delta_norm_post: Any        # f32 scalar: L2 after top-k / int8
    heat_hist: Any              # (HEAT_BUCKETS,) f32 over touched union ids
    density: Any                # f32 scalar: union_size / V
    staleness_hist: Any = None  # (STALENESS_BUCKETS,) f32 | None: per fire
    buffer_occupancy: Any = None  # i32 scalar | None: in-flight deltas at fire


def valid_feature_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Ids outside ``[0, vocab)`` become -1 (the padding convention)."""
    ids = ids.to(torch.int32)
    return torch.where((ids >= 0) & (ids < vocab), ids, -1)


def drop_stats(feats: torch.Tensor, sub_ids: torch.Tensor, vocab: int):
    """Capacity-overflow accounting against the sub-id contract.

    ``feats``: raw feature ids, ``(K, M)`` per client or flat ``(M,)``;
    ``sub_ids``: the -1-padded sub-ids the step consumed, ``(K, R)`` or
    ``(R,)`` to match. Returns ``(dropped, mass)``, per client ``(K,)`` or
    scalars: distinct ids the capacity dropped (int32), and the valid
    feature occurrences referencing a dropped id (float32). Exact when
    ``sub_ids`` came from ``unique_ids_padded`` over the same ``feats``;
    zero when the capacity fit.
    """
    if sub_ids.dim() == 2:
        f = valid_feature_ids(feats.reshape(feats.shape[0], -1), vocab)
    else:
        f = valid_feature_ids(feats.reshape(-1), vocab)
    distinct = count_unique_ids(f)
    kept = (sub_ids >= 0).sum(dim=-1, dtype=torch.int32)
    dropped = torch.clamp(distinct - kept, min=0)
    covered = membership(f, sub_ids)
    mass = ((f >= 0) & ~covered).sum(dim=-1, dtype=torch.float32)
    return dropped, mass


def union_ids_vec(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Sorted distinct valid ids of ``ids`` (capacity ``min(V, ids.numel())``,
    -1 padded)."""
    flat = ids.reshape(-1)
    cap = min(int(vocab), int(flat.shape[0])) if vocab else 0
    return unique_ids_padded(valid_feature_ids(flat, vocab), max(cap, 1))


def heat_histogram(heat: torch.Tensor, ids: torch.Tensor,
                   nbuckets: int = HEAT_BUCKETS) -> torch.Tensor:
    """Histogram of ``heat`` gathered at the valid ids of ``ids``.

    Bucket ``b`` counts ids whose heat lies in ``[2^b, 2^{b+1})`` (``b = 0``
    also holds ``h <= 1``; the last bucket everything above); padding ids
    fall in no bucket. The bucket is the exact binary exponent of
    ``max(h, 1)``.
    """
    heat = heat.to(torch.float32)
    h = heat[torch.clamp(ids, 0, heat.shape[0] - 1).long()]
    _, exp = torch.frexp(torch.clamp(h, min=1.0))     # h = m * 2^exp, m in [0.5, 1)
    b = torch.clamp(exp.long() - 1, 0, nbuckets - 1)
    b = torch.where(ids >= 0, b, nbuckets)             # pads -> the dropped slot
    hist = torch.zeros(nbuckets + 1, dtype=torch.float32, device=heat.device)
    return hist.index_add_(0, b, torch.ones_like(h))[:nbuckets]


def staleness_histogram(staleness: torch.Tensor,
                        nbuckets: int = STALENESS_BUCKETS) -> torch.Tensor:
    """Histogram of buffered arrivals' staleness ``(M,)``: bucket ``s``
    counts staleness exactly ``s``, the last bucket ``>= nbuckets - 1``;
    negative entries fall in no bucket."""
    s = staleness.to(torch.int64)
    b = torch.where(s >= 0, torch.clamp(s, max=nbuckets - 1), nbuckets)
    hist = torch.zeros(nbuckets + 1, dtype=torch.float32, device=s.device)
    return hist.index_add_(0, b, torch.ones(b.shape, device=s.device))[:nbuckets]


def _payloads(tree: Dict) -> List[torch.Tensor]:
    """Leaf payloads (RowSparse rows) in sorted name order: the JAX
    package's order for the same tree, so sums accumulate alike."""
    return [tree[k].rows if is_rowsparse(tree[k]) else tree[k] for k in sorted(tree)]


def tree_sq_sum(tree: Dict) -> torch.Tensor:
    """Sum of squares over every leaf (RowSparse rows; their padding rows
    are zero by construction), in float32."""
    leaves = _payloads(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.square(x.to(torch.float32)).sum()
    return total


def tree_sq_per_client(tree: Dict, k: int) -> torch.Tensor:
    """Per-client sum of squares ``(K,)`` of a stacked update tree."""
    leaves = _payloads(tree)
    total = torch.zeros((k,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.square(x.to(torch.float32)).reshape(k, -1).sum(-1)
    return total


def tree_agg_rows(tree: Dict) -> Optional[torch.Tensor]:
    """Valid rows summed over the RowSparse leaves of an aggregated update;
    ``None`` when no leaf is RowSparse."""
    counts = [(tree[k].ids >= 0).sum(dtype=torch.int32)
              for k in sorted(tree) if is_rowsparse(tree[k])]
    if not counts:
        return None
    total = counts[0]
    for c in counts[1:]:
        total = total + c
    return total


def _host(v: torch.Tensor):
    return v.item() if v.dim() == 0 else v.tolist()


def telemetry_to_host(tel: RoundTelemetry) -> Dict[str, Any]:
    """One round's telemetry as plain Python (JSONL-ready; None kept)."""
    return {name: None if v is None else _host(v.detach().cpu())
            for name, v in tel._asdict().items()}


def split_rounds(tel: RoundTelemetry, n: int) -> List[Dict[str, Any]]:
    """Split a stacked telemetry (every field with a leading axis ``n``)
    into ``n`` host dicts."""
    host = {name: None if v is None else v.detach().cpu()
            for name, v in tel._asdict().items()}
    return [{name: None if a is None else _host(a[r]) for name, a in host.items()}
            for r in range(n)]


def stack_rounds(tels: List[RoundTelemetry]) -> RoundTelemetry:
    """Stack per-round telemetries along a new leading axis (``None``
    fields stay ``None``)."""
    return RoundTelemetry(*[None if vs[0] is None else torch.stack(vs)
                            for vs in zip(*tels)])
