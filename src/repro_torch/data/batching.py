"""Cohort batching (numpy): a FederatedDataset plus sampled client ids become
the stacked minibatch arrays the round step consumes.

For K clients, I local iterations and local batch B the cohort batch has
leaves ``(K, I, B, ...)``. Both functions consume the caller's numpy
``Generator`` in the same order as ``repro/data/batching.py``, so the same
seed draws the same cohorts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.data.synthetic import FederatedDataset


def sample_cohort_batch(ds: FederatedDataset, client_ids: np.ndarray,
                        local_iters: int, local_batch: int,
                        rng: np.random.Generator) -> Dict[str, np.ndarray]:
    out = {key: [] for key in ds.client_data}
    out["sample_mask"] = []
    for c in client_ids:
        n = int(ds.sample_counts[c])
        idx = rng.integers(0, max(n, 1), size=(local_iters, local_batch))
        for key, arr in ds.client_data.items():
            out[key].append(arr[c][idx])
        out["sample_mask"].append(np.ones((local_iters, local_batch), np.float32)
                                  * (n > 0))
    return {key: np.stack(v) for key, v in out.items()}


def pooled_batches(ds: FederatedDataset, iters: int, batch: int,
                   rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Batches sampled from the pooled training set, leaves ``(I, B, ...)``."""
    counts = ds.sample_counts.astype(np.int64)
    # every valid (client, sample) pair in client-major order, built without
    # a Python loop over the ~1M samples of a paper-scale dataset
    client = np.repeat(np.arange(ds.num_clients), counts)
    starts = np.cumsum(counts) - counts
    sample = np.arange(client.size) - np.repeat(starts, counts)
    pick = rng.integers(0, client.size, size=iters * batch)
    c, j = client[pick], sample[pick]
    out = {}
    for key, arr in ds.client_data.items():
        out[key] = arr[c, j].reshape(iters, batch, *arr.shape[2:])
    out["sample_mask"] = np.ones((iters, batch), np.float32)
    return out
