"""Per-leaf heat semantics for parameter dicts.

A model's parameters mix feature-keyed leaves (lookup tables whose rows have
their own heat counts) and dense leaves touched by every client. ``HeatSpec``
tags each leaf of the flat parameter dict with its feature space, or None.
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

    Identity for untagged leaves (e.g. a bias) or spaces without stats.
    """
    if space is None or space[0] not in heat_counts:
        return leaf
    name, axis = space
    factors = heat_correction_factors(heat_counts[name], total).to(leaf.dtype)
    shape = [1] * leaf.dim()
    shape[axis] = leaf.shape[axis]
    return leaf * factors.reshape(shape)
