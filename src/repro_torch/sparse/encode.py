"""Encoders onto the sparse plane, and submodel replicas.

Two paths onto the sparse plane:

``encode_delta_tree``
    Post-hoc: a dense delta (or a per-client stack of deltas) already
    exists; gather the rows its support lives on. Exact whenever the ids
    cover the delta's support, as they do for lookup tables.
``submodel_value_and_grad``
    Gather before backward: the table is swapped for its gathered ``(R, D)``
    rows and the batch's ids are remapped to row slots before autodiff, so
    no ``(V, D)`` gradient is ever built.

Submodel replicas gather a client's rows, remap its batch and repackage its
delta as row-sparse. Parameters are flat dicts, so a table is named by its
key (the JAX package's tree paths and ``tree_leaf_at`` become plain dict
lookups).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from repro_torch.core.aggregate import HeatSpec
from repro_torch.sharding.context import whole_leaves
from repro_torch.sharding.parallel import lookup_for_data
from repro_torch.sparse.rowsparse import (RowSparse, is_rowsparse, remap_ids,
                                          unique_ids_padded)

#: feature spaces the sparse plane encodes by default
DEFAULT_SPARSE_SPACES = ("vocab",)


def sparse_eligible(space: Optional[Tuple[str, int]],
                    spaces: Sequence[str] = DEFAULT_SPARSE_SPACES) -> bool:
    """A leaf rides the sparse plane iff it is feature-keyed on axis 0."""
    return space is not None and space[0] in spaces and space[1] == 0


def encode_delta_tree(delta: Dict[str, torch.Tensor], heat_spec: HeatSpec,
                      ids: torch.Tensor,
                      spaces: Sequence[str] = DEFAULT_SPARSE_SPACES) -> Dict:
    """Replace the eligible feature-keyed leaves of ``delta`` with RowSparse.

    ``delta`` is one update (leaves ``(V, ...)``, ``ids`` ``(R,)``) or a
    per-client stack (leaves ``(K, V, ...)``, ``ids`` ``(K, R)``). Dense
    leaves pass through unchanged.
    """
    def enc(leaf):
        if ids.dim() == 1:
            return RowSparse.from_dense(leaf, ids)
        rows = vmap(lambda d, i: RowSparse.from_dense(d, i).rows)(leaf, ids)
        return RowSparse(ids.to(torch.int32), rows, leaf.shape[1])

    return {name: enc(leaf) if sparse_eligible(heat_spec.leaf_spaces.get(name), spaces)
            else leaf for name, leaf in delta.items()}


def remap_to_rows(tokens: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``remap_ids`` for a gathered table of ``R`` rows: a token dropped by
    a full capacity (absent from ``ids``) lands on the last row instead of
    past the table, as the JAX package's clamped gather reads it."""
    return torch.clamp(remap_ids(tokens, ids), max=ids.shape[-1] - 1)


def submodel_value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                            batch: Dict[str, torch.Tensor], table: str,
                            feature_keys: Sequence[str], ids: torch.Tensor,
                            split=None, cols=None):
    """Loss and gradients with the table ``table`` never densified.

    ``ids`` is the sorted, -1-padded union of the batch's feature ids. The
    table is gathered at ``ids`` outside the differentiated function, every
    ``batch[k]`` for k in ``feature_keys`` is remapped to row slots, and
    autodiff runs over the gathered ``(R, ...)`` rows and the other leaves
    apart: the table itself is not an argument, so only the row gradient
    exists. Returns ``(loss, grads)`` with a ``RowSparse`` at ``table``.

    ``split`` (the model axis's ``CohortMesh``) says the rank holds rows
    ``[rank * V/m, (rank + 1) * V/m)`` of the table. Each model rank then
    gathers the union rows of its slice, zeros for the others, and one
    all-reduce over ``split`` (tagged ``sub_rows:<table>``) hands every rank
    the whole sub-table, which the loss looks up unsplit
    (``context.whole_leaves``). The loss is the same on every model rank,
    and so is the row gradient; the rank keeps the rows of its slice, as a
    ``RowSparse`` of ``V/m`` rows on slice-local ids.

    ``cols`` (the data axis's ``CohortMesh``, FSDP) says the rank holds the
    table's columns ``[rank * d/n, (rank + 1) * d/n)``: the union rows are
    looked up whole-width through ``lookup_for_data`` (the data ranks'
    unions gathered, then their rows; the table is not differentiated, so
    nothing is scattered back), and the row gradient is whole-width. The
    round step combines it so and keeps the rank's columns of the combined
    rows.
    """
    num_rows = params[table].shape[0]

    def lookup(idx):
        return params[table][idx] if cols is None else lookup_for_data(params[table], idx, cols)

    if split is None:
        rows0 = lookup(torch.clamp(ids, min=0).long())
    else:
        local = ids.long() - split.rank * num_rows
        mine = (ids >= 0) & (local >= 0) & (local < num_rows)
        rows0 = lookup(torch.where(mine, local, 0))
        mask = mine.reshape((-1,) + (1,) * (rows0.dim() - 1))
        rows0 = split.psum(torch.where(mask, rows0, 0.0), f"sub_rows:{table}")
    sub_batch = dict(batch)
    for k in feature_keys:
        sub_batch[k] = remap_to_rows(batch[k], ids)
    rest = {name: p for name, p in params.items() if name != table}

    def joint_loss(rows, p):
        return loss_fn({**p, table: rows}, sub_batch)

    # the gathered rows are the whole sub-table on every rank
    with whole_leaves(table):
        (row_grad, rest_grad), loss = grad_and_value(joint_loss, argnums=(0, 1))(rows0, rest)
    valid = (ids >= 0).reshape((-1,) + (1,) * (row_grad.dim() - 1))
    grads = dict(rest_grad)
    grads[table] = RowSparse(ids.to(torch.int32), row_grad * valid.to(row_grad.dtype),
                             num_rows)
    if split is not None:
        grads[table] = slice_rows(grads[table], split.rank * num_rows, num_rows)
    return loss, {name: grads[name] for name in params}


def slice_rows(rs: RowSparse, start: int, num_rows: int) -> RowSparse:
    """The rows of an unbatched ``RowSparse`` (sorted ids, -1 pads trailing)
    whose ids lie in ``[start, start + num_rows)``, on slice-local ids: a
    ``RowSparse`` of ``num_rows`` rows at the same capacity, its ids moved
    to the front in their order and -1 after them."""
    ids, cap = rs.ids.long(), rs.capacity
    lo = ((ids >= 0) & (ids < start)).sum()
    src = torch.clamp(torch.arange(cap, device=ids.device) + lo, max=max(cap - 1, 0))
    cand = ids[src] - start
    keep = (torch.arange(cap, device=ids.device) + lo < cap) & (ids[src] >= 0) & \
        (cand >= 0) & (cand < num_rows)
    rows = rs.rows[src]
    mask = keep.reshape((-1,) + (1,) * (rows.dim() - 1))
    return RowSparse(torch.where(keep, cand, -1).to(torch.int32),
                     torch.where(mask, rows, 0.0).to(rows.dtype), num_rows)


def flat_feature_ids(batch: Dict[str, torch.Tensor],
                     feature_keys: Sequence[str]) -> torch.Tensor:
    """Every feature id of the batch as one flat vector (padding ids kept)."""
    return torch.cat([batch[k].reshape(-1) for k in feature_keys])


def batch_union_ids(batch: Dict[str, torch.Tensor], feature_keys: Sequence[str],
                    capacity: int) -> torch.Tensor:
    """Union of the batch's feature ids across keys, padded to ``capacity``."""
    return unique_ids_padded(flat_feature_ids(batch, feature_keys), capacity)


def pin_labels(data: Dict[str, torch.Tensor], feature_key: str = "tokens") -> Dict:
    """Pin next-token targets to the original feature ids before a remap.

    When ``"labels"`` is absent and the feature leaf has a sequence axis,
    the labels are its ids shifted left along the last axis and zero-padded,
    so ``(B, S)`` and ``(K, I, B, S)`` batches give the same labels for the
    same sequences. No-op otherwise. The recsys losses read ``"label"``, not
    ``"labels"``, so this changes nothing they compute.
    """
    if "labels" in data or feature_key not in data:
        return data
    tokens = data[feature_key]
    if tokens.dim() < 2:
        return data
    return {**data, "labels": F.pad(tokens[..., 1:], (0, 1))}


def gather_submodel_tree(params: Dict[str, torch.Tensor],
                         table_paths: Sequence[str],
                         ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Swap every table in ``table_paths`` for its gathered ``(R, ...)`` rows.

    ``ids`` is one client's sorted-unique, -1-padded submodel id vector;
    padding slots get zero rows. The result is the client's whole replica.
    """
    out = dict(params)
    for name in table_paths:
        out[name] = RowSparse.from_dense(params[name], ids).rows
    return out


def remap_feature_batch(batch: Dict[str, torch.Tensor],
                        feature_keys: Sequence[str],
                        ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Remap each feature-carrying batch leaf to submodel row slots."""
    out = dict(batch)
    for k in feature_keys:
        out[k] = remap_to_rows(batch[k], ids)
    return out


def submodel_delta_tree(delta: Dict[str, torch.Tensor],
                        table_paths: Sequence[str], ids: torch.Tensor,
                        num_rows: Sequence[int]) -> Dict:
    """Repackage a submodel-replica delta: a ``RowSparse`` at each table
    (padding rows zeroed), dense leaves unchanged."""
    out = dict(delta)
    valid = ids >= 0
    for name, n in zip(table_paths, num_rows):
        rows = delta[name]
        mask = valid.reshape(valid.shape + (1,) * (rows.dim() - ids.dim()))
        out[name] = RowSparse(ids, rows * mask.to(rows.dtype), n)
    return out


def decode_delta_tree(tree: Dict) -> Dict[str, torch.Tensor]:
    """Densify every RowSparse leaf with ``RowSparse.to_dense`` (a plain
    scatter-add, as the reference's densify at the server boundary)."""
    return {name: leaf.to_dense() if is_rowsparse(leaf) else leaf
            for name, leaf in tree.items()}


def stacked_feature_ids(batch: Dict[str, torch.Tensor],
                        feature_keys: Sequence[str]) -> torch.Tensor:
    """Per-client ``(K, M)`` concatenation of the feature-id columns."""
    k = batch[feature_keys[0]].shape[0]
    return torch.cat([batch[fk].reshape(k, -1) for fk in feature_keys], dim=1)
