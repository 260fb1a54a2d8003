"""Per-leaf heat semantics and cohort reductions for parameter dicts.

A model's parameters mix feature-keyed leaves (lookup tables whose rows have
their own heat counts) and dense leaves touched by every client. ``HeatSpec``
tags each leaf of the flat parameter dict with its feature space, or None.
Cohort stacks are dicts of ``(K, ...)`` tensors, one row per client.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.heat import heat_correction_factors

#: ``(space_name, row_axis)``: axis ``row_axis`` of the leaf is keyed by the
#: feature space ``space_name``; None for a dense leaf
Space = Optional[Tuple[str, int]]


@dataclass(frozen=True)
class HeatSpec:
    """Maps each parameter name to its feature space (or None)."""

    leaf_spaces: Dict[str, Space]


def correct_dense_leaf(leaf: torch.Tensor, space: Space,
                       heat_counts: Dict[str, torch.Tensor],
                       total: float) -> torch.Tensor:
    """Broadcast ``N / n_m`` onto one dense leaf tagged ``(space, axis)``.

    Identity for untagged leaves (e.g. a bias) or spaces without stats. The
    single source of the broadcast: ``correct_update_tree`` and the sparse
    plane's dense leaves both call it.
    """
    if space is None or space[0] not in heat_counts:
        return leaf
    name, axis = space
    factors = heat_correction_factors(heat_counts[name], total).to(leaf.dtype)
    shape = [1] * leaf.dim()
    shape[axis] = leaf.shape[axis]
    return leaf * factors.reshape(shape)


def correct_update_tree(update: Dict[str, torch.Tensor], heat_spec: HeatSpec,
                        heat_counts: Dict[str, torch.Tensor],
                        total: float) -> Dict[str, torch.Tensor]:
    """The FedSubAvg correction ``N / n_m`` on every leaf (Algorithm 1 line
    9); dense leaves pass through (their count is N)."""
    return {name: correct_dense_leaf(leaf, heat_spec.leaf_spaces.get(name),
                                     heat_counts, total)
            for name, leaf in update.items()}


def cohort_sum(deltas: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Sum over the cohort axis 0 of every stacked leaf."""
    return {name: d.sum(dim=0) for name, d in deltas.items()}


def cohort_mean(deltas: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mean over the cohort axis 0 of every stacked leaf."""
    return {name: d.mean(dim=0) for name, d in deltas.items()}


def masked_cohort_mean(deltas: Dict[str, torch.Tensor],
                       involvement: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean over only the clients that involve each row (the exact form of
    submodel averaging). ``involvement``: ``(K, rows)`` 0/1, client k touched
    row r; each leaf is ``(K, rows, ...)``."""

    def mean(d):
        inv = involvement.reshape(tuple(involvement.shape)
                                  + (1,) * (d.dim() - 2)).to(d.dtype)
        return (d * inv).sum(dim=0) / torch.clamp(inv.sum(dim=0), min=1.0)

    return {name: mean(d) for name, d in deltas.items()}
