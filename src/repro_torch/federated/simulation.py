"""The stateless round step: ``(params, batch) -> (params, metrics)``.

``make_round_step`` resolves one of four mode strings, or takes a
``RoundPlan`` as it is, and builds the step through
``federated.plan.build_round_step``:

``fedsgd``             I = 1 on the pooled batch (optionally microbatched):
                       ``FedSgdLocal x DenseTransport``
``sparse``             the same gradient on the row-sparse plane, gathered
                       before backward: ``FedSgdLocal x RowSparseTransport``
``replicated``         I > 1 local SGD on K dense replicas:
                       ``ReplicatedLocal x DenseTransport``
``sparse_replicated``  I > 1 on each client's gathered submodel, the paper's
                       protocol: ``SubmodelReplicatedLocal x RowSparseTransport``

The batch carries the cohort data and the heat vectors (``heat_vocab``); the
FedSubAvg correction reads the parameters' logical axes. A ``RoundPlan``
with ``CohortSharding`` runs on every rank of its mesh, each rank handed
the same batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import ServerState
from repro_torch.federated.plan import build_round_step, resolve_plan


def batch_fingerprint(batch: Dict[str, torch.Tensor], feature_keys) -> int:
    """The int8 stream's round counter on the stateless path, as the JAX
    package computes it: the feature ids summed as uint32 (a ``-1`` pad
    counts 0xFFFFFFFF), wrapping, then masked to 31 bits. Summed here in
    int64 and taken mod 2^31; one host read."""
    total = None
    for k in feature_keys:
        if k in batch:
            s = (batch[k].to(torch.int64) & 0xFFFFFFFF).sum()
            total = s if total is None else total + s
    return 0 if total is None else int(total) & 0x7FFFFFFF


def make_round_step(loss_fn: Callable, params: Dict[str, torch.Tensor],
                    axes: Dict[str, Tuple], cfg: FedConfig, mode="fedsgd",
                    correct: bool = True, feature_key: str = "tokens",
                    telemetry: bool = False) -> Callable:
    """Build the stateless federated round step.

    ``round_step(params, batch) -> (new_params, metrics)``. ``params`` and
    ``axes`` are the port's pair (``make_*_params`` gives both; only the
    shapes of ``params`` are read here). ``correct=False`` gives the FedAvg
    baseline on the same path. ``mode`` is a mode string or a ``RoundPlan``.

    The step threads bare parameters, not a ``ServerState``, so plans with a
    stateful server optimizer (scaffold, fedadam) are refused: run them
    through ``FederatedTrainer`` or ``build_round_step``. On the sparse
    transport the table rows of the ``params`` passed in are updated in
    place, as the trainer updates its own; pass a copy to keep them.

    ``telemetry=True`` adds the round's ``RoundTelemetry`` under
    ``metrics["telemetry"]`` without changing losses or parameters.

    The int8 transport keys its noise off the round counter; a stateless
    step has none, so the counter is the batch's fingerprint
    (:func:`batch_fingerprint`): distinct cohorts draw independent noise,
    and the same cohort the same noise.
    """
    plan = resolve_plan(mode, cfg, correct=correct, feature_key=feature_key)
    if not plan.server.stateless:
        raise ValueError(
            f"make_round_step is stateless; ServerUpdate({plan.server.algorithm!r}) "
            "carries optimizer slots: drive this plan through FederatedTrainer or "
            "build_round_step")
    step = build_round_step(plan, loss_fn, axes, params, cfg, telemetry=telemetry)
    int8 = getattr(plan.transport, "int8", False)

    def round_step(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        rounds = batch_fingerprint(batch, plan.feature_keys) if int8 else 0
        new_state, metrics = step(ServerState(params, (), rounds), batch)
        return new_state.params, metrics

    return round_step
