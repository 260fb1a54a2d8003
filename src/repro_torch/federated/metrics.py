"""Evaluation metrics (numpy): binary accuracy, AUC, and comm-cost summaries
of the sparse submodel update plane."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with averaged tied ranks; NaN on single-class labels."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    pos, neg = scores[labels], scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    allv = np.concatenate([pos, neg])
    _, inv, cnt = np.unique(allv, return_inverse=True, return_counts=True)
    end = np.cumsum(cnt)                       # 1-indexed last rank per group
    ranks = (end - (cnt - 1) / 2.0)[inv]       # average rank of each element
    r_pos = ranks[: len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg)))


def accuracy(labels: np.ndarray, scores: np.ndarray) -> float:
    return float(((scores > 0) == (np.asarray(labels) > 0.5)).mean())


def comm_summary(comm_log: Sequence) -> Dict[str, float]:
    """Totals over a list of ``repro_torch.sparse.comm.CommStats`` rounds.

    ``up_ratio`` / ``down_ratio`` are dense-baseline over sparse-plane bytes:
    > 1 means the sparse plane saved wire traffic.
    """
    if not comm_log:
        return {"rounds": 0, "bytes_up_sparse": 0.0, "bytes_up_dense": 0.0,
                "bytes_down_sparse": 0.0, "bytes_down_dense": 0.0,
                "mean_density": 1.0, "up_ratio": 1.0, "down_ratio": 1.0}
    up_s = sum(c.bytes_up_sparse for c in comm_log)
    up_d = sum(c.bytes_up_dense for c in comm_log)
    dn_s = sum(c.bytes_down_sparse for c in comm_log)
    dn_d = sum(c.bytes_down_dense for c in comm_log)
    return {
        "rounds": len(comm_log),
        "bytes_up_sparse": up_s, "bytes_up_dense": up_d,
        "bytes_down_sparse": dn_s, "bytes_down_dense": dn_d,
        "mean_density": float(np.mean([c.density for c in comm_log])),
        "up_ratio": up_d / max(up_s, 1.0),
        "down_ratio": dn_d / max(dn_s, 1.0),
    }
