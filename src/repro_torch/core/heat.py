"""Feature heat statistics (paper §2): the exact estimator.

"Heat" of a feature m is ``n_m``, the number of clients whose local data
involve m. FedSubAvg multiplies parameter m's aggregated update by
``N / n_m``. Heat is static over training, computed once from the dataset.
The private estimators of App. F (``estimate_heat_*``) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def heat_correction_factors(counts: torch.Tensor, total: float,
                            min_count: float = 1.0) -> torch.Tensor:
    """FedSubAvg per-row correction ``N / n_m`` in float32.

    Rows no client involves (n_m = 0) get factor 0 — they never receive a
    non-zero update, and 0 avoids inf propagation.
    """
    counts = counts.to(torch.float32)
    safe = torch.clamp(counts, min=min_count)
    # tensor / tensor: ``float / tensor`` would round through a reciprocal
    factors = torch.div(torch.tensor(total, dtype=torch.float32,
                                     device=counts.device), safe)
    return torch.where(counts > 0, factors, torch.zeros_like(factors))


@dataclass(frozen=True)
class HeatStats:
    """Binds a feature space to its heat counts (numpy, host side)."""

    counts: np.ndarray       # (num_features,) float
    total: float             # N (or sum of weights in the weighted case)
    name: str = "vocab"

    @property
    def n_min(self) -> float:
        nz = self.counts[self.counts > 0]
        return float(nz.min()) if nz.size else 0.0

    @property
    def n_max(self) -> float:
        return float(self.counts.max()) if self.counts.size else 0.0

    def dispersion(self) -> float:
        """Parameter heat dispersion n_max / n_min (paper §2)."""
        nmin = self.n_min
        return float("inf") if nmin == 0 else self.n_max / nmin

    def coverage(self) -> float:
        """Fraction of features involved by at least one client."""
        return float((self.counts > 0).mean())
