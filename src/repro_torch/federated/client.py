"""Client-side local training (Algorithm 1 lines 12-18) on submodel replicas.

A client downloads its submodel (the rows of each feature table at its
sub-ids, plus the dense leaves), runs ``I`` iterations of mini-batch SGD and
uploads the row-sparse delta. The K clients of a cohort run together under
``torch.func.vmap``; gradients come from ``torch.func.grad``.

FedProx adds ``(mu/2) ||x - x_global||^2`` to the local objective.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.func import grad, vmap

from repro_torch.sparse.encode import (gather_submodel_tree, remap_feature_batch,
                                       submodel_delta_tree)

Params = Dict[str, torch.Tensor]


def _local_sgd_delta(loss_fn: Callable, cfg, params0: Params,
                     batches: Dict[str, torch.Tensor],
                     prox_mu: Optional[float] = None) -> Params:
    """I steps of mini-batch SGD from ``params0``; returns the delta.

    ``batches`` leaves are ``(I, B, ...)``. ``params0`` is also the FedProx
    anchor; ``prox_mu=None`` takes ``cfg.prox_mu`` iff the algorithm is
    fedprox.
    """
    prox = ((cfg.prox_mu if cfg.algorithm == "fedprox" else 0.0)
            if prox_mu is None else float(prox_mu))

    def objective(p, batch):
        loss = loss_fn(p, batch)
        if prox > 0.0:
            sq = sum(((p[k] - params0[k]) * (p[k] - params0[k])).sum() for k in p)
            loss = loss + 0.5 * prox * sq
        return loss

    g_fn = grad(objective)
    p = params0
    num_iters = next(iter(batches.values())).shape[0]
    for i in range(num_iters):
        g = g_fn(p, {k: v[i] for k, v in batches.items()})
        p = {k: p[k] + g[k] * (-cfg.lr) for k in p}
    return {k: p[k] - params0[k] for k in p}


def make_submodel_local_trainer(loss_fn: Callable, cfg,
                                table_paths: Sequence[str],
                                feature_keys: Sequence[str],
                                prox_mu: Optional[float] = None) -> Callable:
    """Returns ``local_train(global_params, client_batches, sub_ids)`` for
    one client: gather its submodel at ``sub_ids``, remap its batches to row
    slots, run the local steps and return the delta with the gathered
    ``(capacity, ...)`` row deltas at the table names (still dense tensors,
    so ``vmap`` can stack them).
    """

    def local_train(global_params: Params, client_batches, sub_ids):
        sub_params = gather_submodel_tree(global_params, table_paths, sub_ids)
        batches = remap_feature_batch(client_batches, feature_keys, sub_ids)
        return _local_sgd_delta(loss_fn, cfg, sub_params, batches,
                                prox_mu=prox_mu)

    local_train.table_paths = tuple(table_paths)
    return local_train


def cohort_submodel_deltas(local_train: Callable, global_params: Params,
                           cohort_batches: Dict[str, torch.Tensor],
                           sub_ids: torch.Tensor) -> Dict:
    """Submodel local training over the cohort.

    ``sub_ids``: ``(K, capacity)`` per-client submodel ids. Returns the
    per-client update stack: ``RowSparse`` leaves (ids ``(K, R)``, rows
    ``(K, R, ...)``) at the feature tables, dense ``(K, ...)`` leaves
    elsewhere — the input ``sparse_cohort_aggregate`` consumes.
    """
    deltas = vmap(local_train, in_dims=(None, 0, 0))(
        global_params, cohort_batches, sub_ids)
    paths = local_train.table_paths
    return submodel_delta_tree(deltas, paths, sub_ids,
                               [global_params[p].shape[0] for p in paths])
