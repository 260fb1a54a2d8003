"""Feature heat statistics (paper §2) and their private estimation (App. F).

"Heat" of a feature m is ``n_m``, the number of clients whose local data
involve m. FedSubAvg multiplies parameter m's aggregated update by
``N / n_m`` (weighted, App. D.4: ``sum_i w_i / sum_{j: m in S(j)} w_j``).
Heat is static over training, computed once from the dataset: exactly, by
secure aggregation (exact by construction) or under local differential
privacy by randomized response.

The estimators are numpy and bit-identical to ``repro/core/heat.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

#: client rows per draw of randomized response: the draw is the one-shot
#: ``rng.random((n, m))`` stream, held in ``RR_CHUNK_ROWS * m`` doubles
RR_CHUNK_ROWS = 256


def client_indicator(feature_ids, num_features: int) -> np.ndarray:
    """0/1 vector: does this client involve feature m? (the App. F vector)."""
    v = np.zeros((num_features,), dtype=np.int64)
    ids = np.asarray(feature_ids).reshape(-1)
    ids = ids[(ids >= 0) & (ids < num_features)]
    v[np.unique(ids)] = 1
    return v


def compute_heat_exact(client_feature_ids: Sequence, num_features: int,
                       weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """n_m for every feature; weighted: the sum of the involving weights."""
    out = np.zeros((num_features,), dtype=np.float64)
    for i, ids in enumerate(client_feature_ids):
        ind = client_indicator(ids, num_features)
        w = 1.0 if weights is None else float(weights[i])
        out += w * ind
    return out


def estimate_heat_secure_agg(indicators: np.ndarray,
                             rng: Optional[np.random.Generator] = None,
                             modulus: int = 1 << 32,
                             return_masked: bool = False):
    """Secure-aggregation simulation: pairwise additive masks that cancel.

    Client i adds the mask of each pair (i, j), j > i, and subtracts that of
    each pair (j, i), j < i, mod ``modulus``; the server's sum of the masked
    vectors is the exact heat. A pair's mask comes from
    ``SeedSequence((i, j))`` (``rng=None``, a stream pinned across
    processes) or ``SeedSequence((salt, i, j))`` with one 63-bit salt drawn
    from ``rng``. ``return_masked=True`` also returns the masked per-client
    vectors (what the server sees).

    ``modulus`` must be a power of two no larger than 2**63 (the uint64 sum
    is then congruent mod ``modulus``) and must exceed the client count (or
    a feature every client holds would wrap).
    """
    if modulus <= 0 or modulus & (modulus - 1) or modulus > (1 << 63):
        raise ValueError(
            f"modulus must be a power of two <= 2**63, got {modulus}: the "
            "uint64 wraparound arithmetic is only congruent mod a divisor "
            "of 2**64")
    n, m = indicators.shape
    if modulus <= n:
        raise ValueError(
            f"modulus {modulus} must exceed the client count {n}: the true "
            "heat reaches n for a feature every client holds and would wrap")
    salt = (None if rng is None
            else (int(rng.integers(0, 1 << 63, dtype=np.uint64)),))
    vecs = indicators.astype(np.uint64) % modulus
    for i in range(n):
        for j in range(i + 1, n):
            seed = (i, j) if salt is None else salt + (i, j)
            pair_rng = np.random.default_rng(np.random.SeedSequence(seed))
            mask = pair_rng.integers(0, modulus, size=m, dtype=np.uint64)
            vecs[i] = (vecs[i] + mask) % modulus
            vecs[j] = (vecs[j] - mask) % modulus
    acc = vecs.sum(axis=0, dtype=np.uint64)
    est = (acc % modulus).astype(np.float64)
    return (est, vecs) if return_masked else est


def estimate_heat_randomized_response(
        indicators: np.ndarray, flip_prob: float,
        rng: Optional[np.random.Generator] = None,
        weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Unbiased heat estimate under randomized response (Warner 1965).

    Each client reports its true bit with probability ``1 - p`` and the
    flipped bit with ``p``; ``(c - p N) / (1 - 2p)`` is unbiased for the
    count from ``c`` reported ones. With ``weights`` the server sums
    ``w_i * reported_i`` and subtracts ``p W``, ``W = sum w_i`` (App. D.4
    composed with App. F: the weights never touch a raw bit).

    ``indicators`` may be bool or integer 0/1. The flips are drawn
    ``RR_CHUNK_ROWS`` clients at a time, the same stream as one
    ``rng.random((n, m))``, and the weighted sum runs client by client, in
    the order numpy's one-shot ``sum(axis=0)`` adds rows: the result equals
    the reference bit for bit without its two ``(n, m)`` 8-byte arrays.
    """
    if not 0.0 <= flip_prob < 0.5:
        raise ValueError(f"flip_prob must be in [0, 0.5), got {flip_prob}")
    rng = rng or np.random.default_rng(0)
    n, m = indicators.shape
    w = None if weights is None else np.asarray(weights, np.float64)
    acc = np.zeros(m, np.int64 if w is None else np.float64)
    for lo in range(0, n, RR_CHUNK_ROWS):
        hi = min(lo + RR_CHUNK_ROWS, n)
        flips = rng.random((hi - lo, m)) < flip_prob
        reported = flips != indicators[lo:hi].astype(bool, copy=False)
        if w is None:
            acc += reported.sum(axis=0)
        else:
            # the carried sum goes first: rows are added in client order
            acc = np.concatenate([acc[None], w[lo:hi, None] * reported]).sum(axis=0)
    if w is None:
        return (acc.astype(np.float64) - flip_prob * n) / (1.0 - 2.0 * flip_prob)
    return (acc - flip_prob * w.sum()) / (1.0 - 2.0 * flip_prob)


def clamp_heat_estimate(est, total: float, min_count: float = 1.0) -> np.ndarray:
    """Clamp a private heat estimate into ``[min_count, total]``.

    A noisy estimate <= 0 for a feature some client holds would meet the
    correction's ``counts > 0`` gate and zero that row's update; the true
    heat of any involved feature lies in ``[1, N]``. Exact heat is never
    clamped: its zero means cold.
    """
    return np.clip(np.asarray(est, np.float64), min_count, total)


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
