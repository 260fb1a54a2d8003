"""Server-side aggregation over row-sparse cohort updates.

The FedSubAvg server step on the sparse plane is a segment-sum: every client
contributes ``(ids_i, rows_i)``; the server sums rows landing on the same
feature id, scales by ``1/K`` (cohort mean) and fuses the heat correction
``N / n_m`` — one pass over the non-zeros, never touching cold rows.

Union backends of ``aggregate_rowsparse``:

``cuda``    the ``union_segsum`` kernel (CUDA tensors only; raises otherwise)
``bitmap``  plain PyTorch: mark touched rows in a (V,) bitmap, rank them by
            cumsum — the kernel's own algorithm (``union_segsum_torch``)
``sort``    plain PyTorch: sort + searchsorted, O(T log T), for huge V
``auto``    ``cuda`` for CUDA tensors; ``bitmap`` or ``sort`` by V for CPU
            tensors

Every backend drops ids outside ``[0, V)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.aggregate import HeatSpec, correct_dense_leaf
from repro_torch.kernels.heat_scatter import rowsparse_scatter
from repro_torch.kernels.union_segsum import union_segsum, union_segsum_torch
from repro_torch.sparse.encode import DEFAULT_SPARSE_SPACES
from repro_torch.sparse.rowsparse import (RowSparse, is_rowsparse, remap_ids,
                                          unique_ids_padded)

#: beyond this many table rows the O(V) bitmap loses to the sort backend
_BITMAP_MAX_ROWS = 1 << 22


def heat_factor_at(heat: torch.Tensor, ids: torch.Tensor, total: float,
                   scale: float = 1.0) -> torch.Tensor:
    """Per-row ``(N / n_m) * scale`` gathered at ``ids`` (0 for cold/pad rows)."""
    h = heat.to(torch.float32)[torch.clamp(ids, min=0).long()]
    t = torch.tensor(total, dtype=torch.float32, device=h.device)
    f = torch.where(h > 0, torch.div(t, torch.clamp(h, min=1.0)), 0.0)
    return torch.where(ids >= 0, f * scale, 0.0)


def correct_rowsparse(rs: RowSparse, heat: Optional[torch.Tensor], total: float,
                      scale: float = 1.0) -> RowSparse:
    """Scale a RowSparse by ``scale * N / n_m`` (heat given) or by ``scale``
    with padding rows zeroed (heat None — the FedAvg baseline)."""
    if heat is not None:
        factor = heat_factor_at(heat, rs.ids, total, scale)
    else:
        factor = torch.where(rs.ids >= 0, scale, 0.0)
    bshape = tuple(factor.shape) + (1,) * (rs.rows.dim() - rs.ids.dim())
    return RowSparse(rs.ids, rs.rows * factor.reshape(bshape), rs.num_rows)


def _resolve_backend(backend: str, num_rows: int, device: torch.device) -> str:
    if backend != "auto":
        return backend
    if device.type == "cuda":
        return "cuda"
    return "bitmap" if num_rows <= _BITMAP_MAX_ROWS else "sort"


def aggregate_rowsparse(stacked: RowSparse, heat: Optional[torch.Tensor] = None,
                        total: float = 1.0, scale: float = 1.0,
                        union_capacity: Optional[int] = None,
                        union_backend: str = "auto") -> RowSparse:
    """Segment-sum a stacked cohort ``RowSparse`` into its union-id rows.

    ``stacked``: ids ``(K, R)``, rows ``(K, R, ...)``. Returns an unbatched
    RowSparse on the cohort's union ids (capacity ``min(V, K*R)`` unless
    given), rows scaled by ``scale`` and, with ``heat``, by the fused
    FedSubAvg correction ``total / n_m``. The dense ``(V, D)`` update is
    never materialised.
    """
    k, r = stacked.ids.shape
    v = stacked.num_rows
    cap = union_capacity or min(v, k * r)
    flat_ids = stacked.ids.reshape(-1)
    flat_rows = stacked.rows.reshape((k * r,) + tuple(stacked.rows.shape[2:]))
    backend = _resolve_backend(union_backend, v, flat_ids.device)
    if backend == "cuda":
        if not flat_ids.is_cuda:
            raise ValueError("union_backend='cuda' needs CUDA tensors; got "
                             f"{flat_ids.device}")
        return RowSparse(*union_segsum(flat_ids, flat_rows, heat, total, cap, v,
                                       scale=scale), v)
    if backend == "bitmap":
        return RowSparse(*union_segsum_torch(flat_ids, flat_rows, heat, total,
                                             cap, v, scale=scale), v)
    if backend == "sort":
        valid = (flat_ids >= 0) & (flat_ids < v)
        ids = torch.where(valid, flat_ids, -1)
        union = unique_ids_padded(ids, cap)
        # ids dropped over capacity sort after every union id: slot == cap
        pos = torch.where(valid, remap_ids(ids, union), cap).long()
        summed = torch.zeros((cap + 1,) + tuple(flat_rows.shape[1:]),
                             dtype=torch.float32, device=flat_ids.device)
        summed = summed.index_add_(0, pos, flat_rows.to(torch.float32))[:cap]
        return correct_rowsparse(RowSparse(union, summed, v), heat, total, scale)
    raise ValueError(f"unknown union backend {union_backend!r}")


def aggregate_rowsparse_dense(stacked: RowSparse, heat: torch.Tensor,
                              total: float, scale: float = 1.0,
                              backend: str = "auto") -> torch.Tensor:
    """Cohort aggregation to a *dense* corrected update ``(V, ...)``.

    ``backend="cuda"`` runs the ``rowsparse_scatter`` kernel (CUDA tensors
    only); ``"union"`` segment-sums into the union and scatters once;
    ``"auto"`` picks ``cuda`` for CUDA tensors and ``union`` otherwise.
    """
    if backend == "auto":
        backend = "cuda" if stacked.ids.is_cuda else "union"
    if backend == "cuda":
        if not stacked.ids.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors; got "
                             f"{stacked.ids.device}")
        k, r = stacked.ids.shape
        out = rowsparse_scatter(stacked.ids.reshape(-1),
                                stacked.rows.reshape(k * r, -1),
                                heat.to(torch.float32), total, stacked.num_rows,
                                scale=scale)
        return out.reshape((stacked.num_rows,) + tuple(stacked.rows.shape[2:]))
    if backend == "union":
        return aggregate_rowsparse(stacked, heat, total, scale).to_dense()
    raise ValueError(f"unknown dense aggregation backend {backend!r}")


def sparse_cohort_aggregate(updates: Dict, heat_spec: HeatSpec,
                            heat_counts: Dict[str, torch.Tensor], total: float,
                            num_clients_in_cohort: int, correct: bool = True,
                            spaces: Sequence[str] = DEFAULT_SPARSE_SPACES,
                            union_backend: str = "auto") -> Dict:
    """Cohort aggregation of an update dict mixing RowSparse and dense leaves.

    RowSparse leaves ``(K, R)`` become union leaves; dense leaves ``(K, ...)``
    become cohort means, corrected when they carry a feature space. With
    ``correct=False`` this is sparse FedAvg on the same execution path.
    """
    scale = 1.0 / float(num_clients_in_cohort)
    out = {}
    for name, leaf in updates.items():
        space = heat_spec.leaf_spaces.get(name)
        if is_rowsparse(leaf):
            heat = None
            if correct and space is not None and space[0] in heat_counts:
                heat = heat_counts[space[0]]
            out[name] = aggregate_rowsparse(leaf, heat, total, scale,
                                            union_backend=union_backend)
        else:
            mean = leaf.mean(dim=0)
            out[name] = (correct_dense_leaf(mean, space, heat_counts, total)
                         if correct else mean)
    return out


def apply_rowsparse(table: torch.Tensor, rs: RowSparse,
                    scale: float = 1.0) -> torch.Tensor:
    """``table += scale * rs`` by ``index_add_``, without densifying.

    Updates ``table`` in place (one table copy per round saved) and returns
    it. Padding slots add an exact zero to row 0.
    """
    valid = rs.ids >= 0
    add = (rs.rows * scale).to(table.dtype)
    mask = valid.reshape(valid.shape + (1,) * (add.dim() - valid.dim()))
    return table.index_add_(0, torch.where(valid, rs.ids, 0).long(),
                            add * mask.to(add.dtype))
