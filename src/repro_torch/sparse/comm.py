"""Communication-cost accounting for federated rounds (host arithmetic).

Prices a round in bytes — dense baseline vs the sparse plane, uplink and
downlink — from static shapes plus the actual non-padding id counts, so the
numbers are exact, and prices an update tree's wire bytes and a sharded
round's combine. Same formulas as ``repro/sparse/comm.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.sparse.compress import QuantRows
from repro_torch.sparse.rowsparse import is_rowsparse

_ID_BYTES = 4          # int32 row ids
_SCALE_BYTES = 4       # f32 per-row dequant scale


class CommMeta(NamedTuple):
    """Static byte geometry of one model: full tree bytes, the dense leaves
    the sparse plane still ships whole, bytes and elements of one row summed
    over the sparse-plane tables."""

    dense_bytes: float
    sparse_static_bytes: float
    row_payload_bytes: float
    row_elems: int


def model_comm_meta(params: Dict[str, torch.Tensor],
                    sparse_paths: Set[str]) -> CommMeta:
    """:class:`CommMeta` of a flat parameter dict; ``sparse_paths`` names the
    leaves riding the sparse plane."""
    dense_bytes = sparse_static = row_payload = 0.0
    row_elems = 0
    for name, leaf in params.items():
        nbytes = float(leaf.numel()) * leaf.element_size()
        dense_bytes += nbytes
        if name in sparse_paths:
            row_payload += nbytes / leaf.shape[0]
            row_elems += leaf.numel() // leaf.shape[0]
        else:
            sparse_static += nbytes
    return CommMeta(dense_bytes, sparse_static, row_payload, row_elems)


@dataclass
class CommStats:
    """Bytes on the wire for one federated round of ``clients`` clients.

    The dense baseline is the I=1 dense protocol at equal local compute:
    ``clients * model_bytes * local_iters`` each way.
    """

    round: int
    clients: int
    bytes_up_dense: float
    bytes_up_sparse: float
    bytes_down_dense: float
    bytes_down_sparse: float
    rows_total: int              # sum over clients of dense feature rows
    rows_sent: int               # sum over clients of submodel (valid) rows

    @property
    def density(self) -> float:
        return self.rows_sent / max(self.rows_total, 1)

    @property
    def up_ratio(self) -> float:
        return self.bytes_up_dense / max(self.bytes_up_sparse, 1.0)

    def as_dict(self) -> Dict[str, float]:
        return {
            "round": self.round, "clients": self.clients,
            "bytes_up_dense": self.bytes_up_dense,
            "bytes_up_sparse": self.bytes_up_sparse,
            "bytes_down_dense": self.bytes_down_dense,
            "bytes_down_sparse": self.bytes_down_sparse,
            "density": self.density, "up_ratio": self.up_ratio,
        }


def _row_payload_bytes(shape: Sequence[int], itemsize: int) -> int:
    """Bytes of one row of a (V, ...) leaf."""
    n = 1
    for d in shape[1:]:
        n *= int(d)
    return max(n, 1) * itemsize


def _valid_rows(ids: torch.Tensor) -> int:
    return int((ids >= 0).sum())


def _sub_leaves(tree: Any) -> list:
    """The leaves of a container (dict values in key order, list and tuple
    items), RowSparse and QuantRows kept whole; ``None`` has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _sub_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in _sub_leaves(x)]
    return [tree]


def leaf_wire_bytes(leaf: Any) -> float:
    """On-wire bytes of one update leaf in its current representation.

    RowSparse and QuantRows leaves ship their valid rows with an int32 id
    each (QuantRows at 1 byte an element plus an f32 scale a row); tensors
    and numpy arrays ship whole; a Python scalar as numpy holds it; a
    container is the sum of its leaves (0 bytes when empty).
    """
    if isinstance(leaf, QuantRows):
        per_row = _row_payload_bytes((0,) + tuple(leaf.q.shape[leaf.ids.dim():]), 1)
        return _valid_rows(leaf.ids) * (_ID_BYTES + per_row + _SCALE_BYTES)
    if is_rowsparse(leaf):
        per_row = _row_payload_bytes((0,) + tuple(leaf.rows.shape[leaf.ids.dim():]),
                                     leaf.rows.element_size())
        return _valid_rows(leaf.ids) * (_ID_BYTES + per_row)
    if isinstance(leaf, torch.Tensor):
        return float(leaf.numel()) * leaf.element_size()
    if isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
        return float(np.prod(leaf.shape)) * leaf.dtype.itemsize
    sub = _sub_leaves(leaf)
    if len(sub) == 1 and sub[0] is leaf:        # atomic scalar (int/float)
        arr = np.asarray(leaf)
        return float(np.prod(arr.shape)) * arr.dtype.itemsize
    return float(sum(leaf_wire_bytes(l) for l in sub))


def tree_wire_bytes(tree: Any) -> float:
    """Total on-wire bytes of an update tree (RowSparse/QuantRows aware)."""
    return sum((leaf_wire_bytes(leaf) for leaf in _sub_leaves(tree)), 0.0)


def sharded_combine_bytes(meta: CommMeta, vocab: int, union_capacity: int,
                          num_shards: int, mode: str, *, num_tables: int = 1,
                          count_gather_ids: bool = False) -> Dict[str, float]:
    """Predicted cross-rank combine bytes of one cohort-sharded sparse round.

    The comm-plane half of ``repro_torch.analysis.hlo_audit.comm_drift``:
    per rank and per collective kind, the combine that
    ``combine_rowsparse_partials`` makes, priced from the same
    :class:`CommMeta` that prices the client wire. ``mode`` is the resolved
    combine ("psum": an all-reduce of the densified ``(V, row)`` partial;
    "union": an all-gather of every rank's ``union_capacity`` ids and
    rows); ``count_gather_ids`` adds the flat path's ``used_ids``
    all-gather. The dense non-table leaves ride an all-reduce; payloads are
    priced as f32. The loss and sub-row scalars (4 B each) are not priced:
    the drift check's absolute tolerance absorbs them. On a vocabulary
    split over ``model`` a rank combines its slice: ``vocab`` is then the
    slice's rows and ``meta`` the rank's parameters (the ``data`` axis of
    ``plan.tp_collective_budget(sparse=True)``, less its loss).
    """
    out = {"all-reduce": 0.0, "all-gather": 0.0}
    row_bytes = float(meta.row_elems) * 4.0
    if mode == "psum":
        out["all-reduce"] += float(vocab) * row_bytes
    elif mode == "union":
        out["all-gather"] += float(num_shards) * float(union_capacity) * (
            float(num_tables) * _ID_BYTES + row_bytes)
    else:
        raise ValueError(f"unknown combine mode: {mode!r}")
    out["all-reduce"] += float(meta.sparse_static_bytes)
    if count_gather_ids:
        out["all-gather"] += float(num_shards) * float(union_capacity) * _ID_BYTES
    return out


def round_comm_stats(rnd: int, dense_model_bytes: float,
                     sparse_static_bytes: float, row_payload_bytes: float,
                     valid_ids_per_client: np.ndarray, num_features: int,
                     int8: bool = False, row_elems: Optional[int] = None,
                     uplink_rows_per_client: Optional[np.ndarray] = None,
                     downlink_rows_per_client: Optional[np.ndarray] = None,
                     local_iters: int = 1) -> CommStats:
    """Price one round from host-side metadata (exact, no estimation).

    ``valid_ids_per_client`` are the per-client submodel sizes;
    ``uplink_rows_per_client`` (top-k can shrink it) and
    ``downlink_rows_per_client`` (the rows actually shipped) default to
    them. A full-table download ships no per-row ids.
    """
    k = len(valid_ids_per_client)
    rows_sent = int(np.asarray(valid_ids_per_client).sum())
    rows_up = (rows_sent if uplink_rows_per_client is None
               else int(np.asarray(uplink_rows_per_client).sum()))
    down = np.asarray(valid_ids_per_client if downlink_rows_per_client is None
                      else downlink_rows_per_client)
    rows_down = int(down.sum())
    id_bytes_down = float((np.where(down < num_features, down, 0)).sum()) * _ID_BYTES
    up_row = row_payload_bytes
    if int8:
        up_row = float(row_elems if row_elems is not None
                       else row_payload_bytes / 4.0) + _SCALE_BYTES
    sparse_up = k * sparse_static_bytes + rows_up * (_ID_BYTES + up_row)
    sparse_down = (k * sparse_static_bytes + rows_down * row_payload_bytes
                   + id_bytes_down)
    dense_bytes = k * dense_model_bytes * max(int(local_iters), 1)
    return CommStats(
        round=rnd, clients=k,
        bytes_up_dense=dense_bytes,
        bytes_up_sparse=sparse_up,
        bytes_down_dense=dense_bytes,
        bytes_down_sparse=sparse_down,
        rows_total=k * num_features,
        rows_sent=rows_sent,
    )
