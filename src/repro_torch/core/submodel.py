"""Submodel extraction and alignment (paper §2, "Model Structure and Submodel").

A client's submodel is the dense layers plus the embedding rows of its local
feature ids, as a key-value view:

    download:  rows = table[ids]                      (gather)
    upload:    table_update[ids] += row_updates       (scatter-add, aligned)

Index sets are fixed-size, ``-1``-padded id vectors; a pad gathers row 0
but is masked out of every scatter.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class IndexSet(NamedTuple):
    ids: torch.Tensor      # (max_ids,) int32, padded with -1
    mask: torch.Tensor     # (max_ids,) float32, 1.0 for real ids


def index_set_from_tokens(tokens: torch.Tensor, max_ids: int) -> IndexSet:
    """A client's S(i): the distinct values of ``tokens``, ascending, packed
    into ``max_ids`` slots (the largest dropped over capacity). Negative
    tokens take slots too but read as pads."""
    flat = torch.sort(tokens.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    rank = torch.cumsum(first, dim=0) - 1
    ok = first & (rank < max_ids)
    ids = torch.full((max_ids + 1,), -1, dtype=torch.int32, device=flat.device)
    # repeats and overflow land in the spare slot max_ids, sliced off
    ids.scatter_(0, torch.where(ok, rank, max_ids),
                 torch.where(ok, flat.to(torch.int32), -1))
    ids = ids[:max_ids]
    return IndexSet(ids=ids, mask=(ids >= 0).to(torch.float32))


def gather_rows(table: torch.Tensor, index_set: IndexSet) -> torch.Tensor:
    """Download: the submodel's rows of ``table`` (pads give zero rows)."""
    rows = table[torch.clamp(index_set.ids, min=0).long()]
    return rows * index_set.mask[:, None].to(rows.dtype)


def _rows_or_spare(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Row index of each id, ``num_rows`` (a spare row) for ids past the
    table; pads read as row 0 and are masked by the caller."""
    safe = torch.clamp(ids, min=0)
    return torch.where(safe < num_rows, safe, num_rows).long()


def scatter_row_updates(num_rows: int, index_set: IndexSet,
                        row_updates: torch.Tensor) -> torch.Tensor:
    """Upload: the row updates aligned back to ``(num_rows, D)`` table
    coordinates; ids past the table are dropped."""
    upd = row_updates * index_set.mask[:, None].to(row_updates.dtype)
    out = torch.zeros((num_rows + 1, row_updates.shape[-1]), dtype=row_updates.dtype,
                      device=row_updates.device)
    return out.index_add_(0, _rows_or_spare(index_set.ids, num_rows), upd)[:num_rows]


def involvement_matrix(ids_batch: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``(K, num_rows)`` 0/1: which client of the cohort involves which row."""
    k = ids_batch.shape[0]
    valid = (ids_batch >= 0).to(torch.float32)
    out = torch.zeros((k, num_rows + 1), dtype=torch.float32, device=ids_batch.device)
    out.scatter_reduce_(1, _rows_or_spare(ids_batch, num_rows), valid, reduce="amax")
    return out[:, :num_rows]


def count_token_rows(tokens: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Occurrences of each row among the batch's tokens (pads not counted)."""
    flat = tokens.reshape(-1)
    out = torch.zeros(num_rows + 1, dtype=torch.float32, device=flat.device)
    return out.index_add_(0, _rows_or_spare(flat, num_rows),
                          (flat >= 0).to(torch.float32))[:num_rows]
