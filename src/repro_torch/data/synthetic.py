"""Synthetic federated datasets with controlled feature-heat dispersion.

Pure numpy, bit-identical to ``repro/data/synthetic.py`` for the same seed:
the generator consumes its ``np.random.default_rng(seed)`` stream in the
same order. MovieLens is reproduced as a statistically matched synthetic:
client counts and samples per client follow the published dataset, feature
popularity is Zipf-distributed, and labels come from a planted latent model.
Only the MovieLens-like generator (the LR task) is ported so far.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.heat import HeatStats


@dataclass
class FederatedDataset:
    name: str
    task: str                       # lr | lstm | din | lm
    num_clients: int
    num_features: int
    client_data: Dict[str, np.ndarray]    # leaves (N, max_samples, ...)
    sample_counts: np.ndarray             # (N,)
    heat: HeatStats
    test_data: Dict[str, np.ndarray]
    feature_key: str = "features"         # which leaf carries feature ids

    def stats(self) -> Dict:
        return {
            "clients": self.num_clients,
            "samples": int(self.sample_counts.sum()),
            "samples_per_client": float(self.sample_counts.mean()),
            "dispersion": self.heat.dispersion(),
            "coverage": self.heat.coverage(),
        }


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def _pad_stack(rows, max_len, fill=0):
    out = np.full((len(rows), max_len) + rows[0].shape[1:], fill, dtype=rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r[:max_len]
    return out


def _heat_from_ids(per_client_ids, num_features) -> HeatStats:
    counts = np.zeros(num_features, np.float64)
    for ids in per_client_ids:
        u = np.unique(ids[ids >= 0])
        counts[u] += 1
    return HeatStats(counts=counts, total=float(len(per_client_ids)))


def make_movielens_like(num_clients: int = 300, num_items: int = 200,
                        mean_samples: int = 40, zipf_a: float = 1.2,
                        seed: int = 0, test_frac: float = 0.2) -> FederatedDataset:
    """LR over one-hot(gender, age, movie, gender x movie, age x movie).

    ``num_features = 9 + 10 * num_items``. MovieLens-1M's published size is
    6,040 users and 3,706 rated movies with about 1.0M ratings
    (``mean_samples=165``), which gives 37,069 features.
    """
    rng = np.random.default_rng(seed)
    m = num_items
    num_features = 9 + 10 * m       # 2 gender + 7 age + M + 2M + 7M
    pop = _zipf_probs(m, zipf_a)

    q = rng.normal(0, 1.2, m)                       # movie quality
    g_aff = rng.normal(0, 0.5, (2, m))              # gender x movie affinity
    a_aff = rng.normal(0, 0.5, (7, m))              # age x movie affinity

    feats, labels, counts = [], [], []
    test_feats, test_labels = [], []
    for _ in range(num_clients):
        g = rng.integers(0, 2)
        a = rng.integers(0, 7)
        n = max(5, int(rng.poisson(mean_samples)))
        movies = rng.choice(m, size=n, p=pop)
        logit = q[movies] + g_aff[g, movies] + a_aff[a, movies] + rng.normal(0, 0.5, n)
        lab = (logit > 0).astype(np.int32)
        f = np.stack([
            np.full(n, g),
            np.full(n, 2 + a),
            9 + movies,
            9 + m + g * m + movies,
            9 + 3 * m + a * m + movies,
        ], axis=1).astype(np.int32)
        n_test = max(1, int(n * test_frac))
        test_feats.append(f[:n_test])
        test_labels.append(lab[:n_test])
        feats.append(f[n_test:])
        labels.append(lab[n_test:])
        counts.append(n - n_test)

    max_len = max(counts)
    data = {
        "features": _pad_stack(feats, max_len, fill=-1),
        "label": _pad_stack(labels, max_len, fill=0),
    }
    heat = _heat_from_ids([f.reshape(-1) for f in feats], num_features)
    return FederatedDataset(
        name="movielens_like", task="lr", num_clients=num_clients,
        num_features=num_features, client_data=data,
        sample_counts=np.array(counts), heat=heat,
        test_data={"features": np.concatenate(test_feats),
                   "label": np.concatenate(test_labels)},
    )
