"""Submodel replicas: gather a client's rows, remap its batch, repackage its
delta as row-sparse.

Parameters are flat dicts, so a table is named by its key (the JAX package's
tree paths and ``tree_leaf_at`` become plain dict lookups).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.sparse.rowsparse import RowSparse, is_rowsparse, remap_ids

#: feature spaces the sparse plane encodes by default
DEFAULT_SPARSE_SPACES = ("vocab",)


def sparse_eligible(space: Optional[Tuple[str, int]],
                    spaces: Sequence[str] = DEFAULT_SPARSE_SPACES) -> bool:
    """A leaf rides the sparse plane iff it is feature-keyed on axis 0."""
    return space is not None and space[0] in spaces and space[1] == 0


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
        out[k] = remap_ids(batch[k], ids)
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
