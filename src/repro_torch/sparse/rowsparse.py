"""Row-sparse representation of feature-keyed update leaves.

A client (or cohort) update to a feature-keyed table ``(V, ...)`` touches only
the rows in its submodel S(i). ``RowSparse`` stores exactly those rows:

    ids  : (..., R) int32, sorted ascending, ``-1`` marks padding slots
    rows : (..., R, ...) the touched rows' values (padding rows are zero)

Leading axes are batch axes: a cohort of K client updates is ids ``(K, R)``
and rows ``(K, R, ...)``. ``num_rows`` is the dense leading size V.

The id helpers below keep the JAX package's contract (sorted ascending,
``-1`` pads, the largest ids dropped over capacity, ids exact in int32) and
work along the last axis, so one call covers a whole cohort where the JAX
package maps the unbatched function over clients.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: id value marking an unused (padding) slot
PAD_ID = -1
_SENTINEL = torch.iinfo(torch.int32).max


class RowSparse:
    """``(ids, rows)`` pair for one feature-keyed leaf."""

    __slots__ = ("ids", "rows", "num_rows")

    def __init__(self, ids: torch.Tensor, rows: torch.Tensor, num_rows: int):
        self.ids = ids
        self.rows = rows
        self.num_rows = int(num_rows)

    def __repr__(self):
        return (f"RowSparse(ids={tuple(self.ids.shape)}, "
                f"rows={tuple(self.rows.shape)}, num_rows={self.num_rows})")

    @property
    def capacity(self) -> int:
        """Number of id slots R."""
        return int(self.ids.shape[-1])

    @staticmethod
    def from_dense(dense: torch.Tensor, ids: torch.Tensor) -> "RowSparse":
        """Gather rows of ``dense`` at ``ids`` (axis 0); ``-1`` slots get zeros."""
        rows = dense[torch.clamp(ids, min=0).long()]
        valid = (ids >= 0).reshape(ids.shape + (1,) * (rows.dim() - ids.dim()))
        return RowSparse(ids.to(torch.int32), rows * valid.to(rows.dtype),
                         dense.shape[0])

    def to_dense(self) -> torch.Tensor:
        """Scatter-add rows into the dense ``(V, ...)`` leaf (unbatched only)."""
        if self.ids.dim() != 1:
            raise ValueError("to_dense expects an unbatched RowSparse")
        out = torch.zeros((self.num_rows + 1,) + tuple(self.rows.shape[1:]),
                          dtype=self.rows.dtype, device=self.rows.device)
        safe = torch.where(self.ids >= 0, self.ids, self.num_rows).long()
        return out.index_add_(0, safe, self.rows)[: self.num_rows]


def is_rowsparse(x) -> bool:
    return isinstance(x, RowSparse)


def _sorted_firsts(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ids sorted along the last axis (pads last) and their first-occurrence mask."""
    ids = ids.to(torch.int32)
    s = torch.sort(torch.where(ids >= 0, ids, _SENTINEL), dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    return s, first & (s != _SENTINEL)


def unique_ids_padded(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Sorted unique non-negative ids of the last axis, ``-1``-padded to
    ``capacity``: ``(..., T) -> (..., capacity)``.

    Ids beyond ``capacity`` distinct values are dropped, largest first.
    """
    s, first = _sorted_firsts(ids)
    slot = torch.where(first, torch.cumsum(first, dim=-1) - 1, capacity)
    slot = torch.clamp(slot, max=capacity)
    out = torch.full(s.shape[:-1] + (capacity + 1,), PAD_ID, dtype=torch.int32,
                     device=s.device)
    # repeats and ids over capacity land in the spare slot `capacity`, sliced off
    out.scatter_(-1, slot, torch.where(first, s, PAD_ID))
    return out[..., :capacity]


def count_unique_ids(ids: torch.Tensor) -> torch.Tensor:
    """Number of distinct non-negative ids along the last axis."""
    return _sorted_firsts(ids)[1].sum(dim=-1, dtype=torch.int32)


def membership(tokens: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Is each token in ``ids`` (sorted ascending, ``-1``-padded)?

    ``ids`` is ``(R,)`` with ``tokens`` of any shape (the mask has the
    tokens' shape), or ``(K, R)`` with ``tokens`` ``(K, ...)``: each
    client's tokens are looked up in its own row of ids and the mask is
    ``(K, M)``. Negative tokens are never members. Binary search plus an
    equality check, so an absent token reports False where
    :func:`remap_ids` would give an arbitrary slot: what prices capacity
    drops exactly.
    """
    key = torch.where(ids >= 0, ids, _SENTINEL).to(torch.int32).contiguous()
    t = tokens.to(torch.int32)
    if ids.dim() > 1:
        t = t.reshape(tuple(ids.shape[:-1]) + (-1,)).contiguous()
    pos = torch.clamp(torch.searchsorted(key, t), max=key.shape[-1] - 1)
    hit = key[pos] == t if ids.dim() == 1 else torch.gather(key, -1, pos) == t
    return hit & (t >= 0)


def remap_ids(tokens: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Map feature ids to their slot in ``ids`` (sorted uniques then -1 pads).

    ``ids`` is ``(R,)``, or ``(K, R)`` with ``tokens`` ``(K, ...)``: each
    client's tokens map into its own row of ids. Negative tokens stay
    negative; tokens absent from ``ids`` get an arbitrary slot (callers
    guarantee coverage).
    """
    key = torch.where(ids >= 0, ids, _SENTINEL).to(torch.int32)
    t = tokens.to(torch.int32)
    if ids.dim() == 1:
        pos = torch.searchsorted(key, t)
    else:
        flat = t.reshape(ids.shape[:-1] + (-1,)).contiguous()
        pos = torch.searchsorted(key.contiguous(), flat).reshape(t.shape)
    return torch.where(t >= 0, pos.to(torch.int32), t)
