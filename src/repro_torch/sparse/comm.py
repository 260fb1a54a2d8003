"""Communication-cost accounting for federated rounds (host arithmetic).

Prices a round in bytes — dense baseline vs the sparse plane, uplink and
downlink — from static shapes plus the actual non-padding id counts, so the
numbers are exact. Same formulas as ``repro/sparse/comm.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Set

import numpy as np
import torch

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
