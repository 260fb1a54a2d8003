"""Execution plans for one federated round.

A :class:`RoundPlan` names a layout as three strategy choices:

``LocalStep``      how the cohort produces deltas. Ported:
                   :class:`SubmodelReplicatedLocal` (I > 1 local SGD on each
                   client's gathered submodel; deltas are born row-sparse).
``Transport``      what ships between clients and server, and what a round
                   costs in bytes. Ported: :class:`RowSparseTransport` with
                   optional top-k row selection.
``ServerUpdate``   the heat correction plus the algorithm that applies the
                   aggregate. Ported: fedavg, fedprox, fedsubavg.

``FedConfig(sparse=True)`` resolves to
``SubmodelReplicatedLocal x RowSparseTransport x ServerUpdate(algorithm)``,
the paper's main path, and :func:`build_round_step` turns it into a
single-device round step. The other pieces are defined so that plans resolve
as in the JAX package, but building a step from them raises
``NotImplementedError`` (ROADMAP Queue 1): ``FedSgdLocal``,
``ReplicatedLocal``, ``DenseTransport``, ``CohortSharding``, int8 transport,
telemetry and ``debug_checks``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import SERVER_ALGORITHMS, FedConfig
from repro_torch.core.aggregate import HeatSpec
from repro_torch.core.algorithms import ServerState
from repro_torch.federated.client import (cohort_submodel_deltas,
                                          make_submodel_local_trainer)
from repro_torch.sparse.aggregate import apply_rowsparse, sparse_cohort_aggregate
from repro_torch.sparse.comm import CommMeta, CommStats, round_comm_stats
from repro_torch.sparse.compress import compress_delta_tree
from repro_torch.sparse.encode import DEFAULT_SPARSE_SPACES, sparse_eligible
from repro_torch.sparse.rowsparse import is_rowsparse

#: round-plan server algorithms ("central" is not a federated round)
PLAN_ALGORITHMS = tuple(a for a in SERVER_ALGORITHMS if a != "central")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1): the port builds "
        "SubmodelReplicatedLocal x RowSparseTransport x ServerUpdate on one device")


def heat_spec_from_axes(axes: Dict[str, Tuple],
                        spaces: Optional[Dict[str, str]] = None) -> HeatSpec:
    """Derive the HeatSpec from the parameters' logical axes: the first axis
    named in ``spaces`` (default "vocab" -> "vocab", "experts" -> "expert")
    keys the leaf's feature space."""
    spaces = spaces or {"vocab": "vocab", "experts": "expert"}

    def leaf_space(ax):
        for i, name in enumerate(ax or ()):
            if name in spaces:
                return (spaces[name], i)
        return None

    return HeatSpec({name: leaf_space(ax) for name, ax in axes.items()})


def sparse_table_paths(heat_spec: HeatSpec,
                       spaces=DEFAULT_SPARSE_SPACES) -> List[Tuple[str, Tuple]]:
    """Names of the leaves that ride the sparse plane (axis-0 feature tables)."""
    return [(name, space) for name, space in heat_spec.leaf_spaces.items()
            if sparse_eligible(space, spaces)]


# ---------------------------------------------------------------------------
# strategy objects
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FedSgdLocal:
    """I = 1 on the pooled cohort batch (not ported yet)."""

    microbatches: int = 1
    stacked = False


@dataclass(frozen=True)
class ReplicatedLocal:
    """I > 1 local SGD on per-client dense replicas (not ported yet)."""

    prox_mu: Optional[float] = None
    stacked = True


@dataclass(frozen=True)
class SubmodelReplicatedLocal:
    """I > 1 local SGD on per-client gathered submodel replicas.

    Each client's replica is its gathered ``(capacity, D)`` feature rows
    plus the dense leaves; deltas are born RowSparse on its sub-ids.
    ``prox_mu`` overrides the FedProx coefficient (None: from the config).
    """

    prox_mu: Optional[float] = None
    stacked = True


LocalStep = Union[FedSgdLocal, ReplicatedLocal, SubmodelReplicatedLocal]


@dataclass(frozen=True)
class DenseTransport:
    """Full dense update trees ship both ways (not ported yet)."""

    sparse = False


@dataclass(frozen=True)
class RowSparseTransport:
    """Row-sparse ``(ids, rows)`` updates — the paper's submodel wire format.

    ``topk``: keep only the k largest-L2 delta rows per client (0 = off).
    ``int8``: int8 row payloads (not ported yet). ``union_backend``: server
    segment-sum backend (``"auto"``/``"cuda"``/``"bitmap"``/``"sort"`` — see
    ``repro_torch.sparse.aggregate``).
    """

    topk: int = 0
    int8: bool = False
    union_backend: str = "auto"
    sparse = True

    def __post_init__(self):
        if self.topk < 0:
            raise ValueError(f"topk must be >= 0 (0 disables), got {self.topk}")

    def round_comm(self, rnd: int, meta: CommMeta, valid_counts: np.ndarray,
                   num_features: int, capacity: Optional[int] = None,
                   submodel_downlink: bool = False,
                   local_iters: int = 1) -> CommStats:
        """Price one round in exact bytes from per-client sub-id counts.

        Uplink: top-k ships ``min(topk, valid)`` rows per client. Downlink:
        the gathered ``capacity``-row submodel (clamped to the table) when
        ``submodel_downlink``, else the full table.
        """
        valid_counts = np.asarray(valid_counts)
        k = len(valid_counts)
        up = (np.minimum(valid_counts, self.topk) if self.topk
              else valid_counts)
        if submodel_downlink:
            if capacity is None:
                raise ValueError("submodel downlink pricing needs the "
                                 "gathered replica capacity")
            down = np.full(k, min(int(capacity), int(num_features)))
        else:
            down = np.full(k, int(num_features))
        return round_comm_stats(
            rnd, meta.dense_bytes, meta.sparse_static_bytes,
            meta.row_payload_bytes, valid_counts, num_features,
            int8=self.int8, row_elems=meta.row_elems,
            uplink_rows_per_client=up, downlink_rows_per_client=down,
            local_iters=local_iters)


Transport = Union[DenseTransport, RowSparseTransport]


@dataclass(frozen=True)
class ServerUpdate:
    """Heat correction + the algorithm that applies the update. The
    FedSubAvg correction ``N / n_m`` applies iff ``algorithm == "fedsubavg"``."""

    algorithm: str = "fedsubavg"

    def __post_init__(self):
        if self.algorithm not in PLAN_ALGORITHMS:
            raise ValueError(
                f"unknown server algorithm {self.algorithm!r}: expected one "
                f"of {PLAN_ALGORITHMS}")

    @property
    def correct(self) -> bool:
        return self.algorithm == "fedsubavg"

    @property
    def stateless(self) -> bool:
        return self.algorithm in ("fedavg", "fedprox", "fedsubavg")


@dataclass(frozen=True)
class CohortSharding:
    """Shard the cohort axis over devices (not ported yet)."""

    mesh: object
    axis: str = "data"
    combine: str = "auto"


@dataclass(frozen=True)
class RoundPlan:
    """One federated round as a composition of three strategies."""

    local: LocalStep
    transport: Transport
    server: ServerUpdate
    feature_keys: Tuple[str, ...] = ("tokens",)
    sharding: Optional[CohortSharding] = None
    debug_checks: bool = False

    def describe(self) -> str:
        return (f"{type(self.local).__name__} -> "
                f"{type(self.transport).__name__} -> "
                f"ServerUpdate({self.server.algorithm})")


def plan_from_config(cfg: FedConfig, feature_keys: Tuple[str, ...] = ("tokens",),
                     gatherable: bool = True) -> RoundPlan:
    """Resolve ``FedConfig`` flags into the RoundPlan the trainer executes."""
    if cfg.algorithm == "central":
        raise ValueError("central training is not a federated round plan")
    server = ServerUpdate(cfg.algorithm)
    if not cfg.sparse:
        return RoundPlan(ReplicatedLocal(), DenseTransport(), server,
                         tuple(feature_keys))
    mode = cfg.sparse_local
    if mode == "auto":
        mode = "sparse_replicated" if gatherable else "replicated"
    local = (SubmodelReplicatedLocal() if mode == "sparse_replicated"
             else ReplicatedLocal())
    transport = RowSparseTransport(topk=cfg.sparse_topk, int8=cfg.sparse_int8)
    return RoundPlan(local, transport, server, tuple(feature_keys))


# ---------------------------------------------------------------------------
# the compiler: plan -> round step
# ---------------------------------------------------------------------------


def _apply_plain(params: Dict[str, torch.Tensor], update: Dict,
                 eta: float) -> Dict[str, torch.Tensor]:
    """``X += eta * update``: RowSparse leaves by ``index_add_`` in place,
    dense leaves out of place."""
    out = {}
    for name, p in params.items():
        u = update[name]
        out[name] = (apply_rowsparse(p, u, eta) if is_rowsparse(u)
                     else p + (u * eta).to(p.dtype))
    return out


def build_round_step(plan: RoundPlan, loss_fn: Callable,
                     axes: Dict[str, Tuple], params_template: Dict[str, torch.Tensor],
                     cfg: FedConfig, *, heat_counts: Dict[str, torch.Tensor],
                     total: float, telemetry: bool = False) -> Callable:
    """Build the round step of a :class:`RoundPlan` for one device.

    ``step(state, batch, sub_ids) -> (new_state, metrics)`` over a
    ``ServerState``: ``batch`` leaves are ``(K, I, B, ...)``, ``sub_ids`` the
    ``(K, capacity)`` per-client submodel ids. ``heat_counts``/``total`` are
    the static heat statistics. ``metrics`` carries ``"loss"`` — the cohort
    mean of ``loss_fn`` on each client's first minibatch at the pre-round
    parameters — plus ``"sub_rows"`` and ``"density"``.

    The table rows of ``state.params`` are updated in place.
    """
    local, transport, server = plan.local, plan.transport, plan.server
    if not isinstance(local, SubmodelReplicatedLocal):
        raise _not_ported(type(local).__name__)
    if not transport.sparse:
        raise _not_ported(type(transport).__name__)
    if transport.int8:
        raise _not_ported("int8 row transport")
    if plan.sharding is not None:
        raise _not_ported("CohortSharding")
    if plan.debug_checks:
        raise _not_ported("debug_checks")
    if telemetry:
        raise _not_ported("round telemetry")
    if not server.stateless:
        raise _not_ported(f"server algorithm {server.algorithm!r}")

    feature_keys = tuple(plan.feature_keys)
    heat_spec = heat_spec_from_axes(axes)
    table_paths = [name for name, _ in sparse_table_paths(heat_spec)]
    vocabs = sorted({int(params_template[p].shape[0]) for p in table_paths})
    if not table_paths:
        raise ValueError("submodel-replica local training needs at least one "
                         "axis-0 feature table")
    if len(vocabs) != 1:
        raise ValueError(
            f"submodel-replica feature tables disagree on vocab: {vocabs}")
    vocab = vocabs[0]
    n_total = float(total)
    eta = cfg.server_lr
    local_train = make_submodel_local_trainer(
        loss_fn, cfg, table_paths, feature_keys, prox_mu=local.prox_mu)

    def step(state: ServerState, batch: Dict[str, torch.Tensor],
             sub_ids: torch.Tensor):
        params = state.params
        deltas = cohort_submodel_deltas(local_train, params, batch, sub_ids)
        if transport.topk:
            deltas = compress_delta_tree(deltas, topk=transport.topk)
        k = batch[feature_keys[0]].shape[0]
        # the monitoring loss reads the pre-round parameters: take it before
        # the in-place apply
        first = {key: v[:, 0] for key, v in batch.items()}
        loss = vmap(lambda b: loss_fn(params, b))(first).mean()
        agg = sparse_cohort_aggregate(deltas, heat_spec, heat_counts, n_total, k,
                                      correct=server.correct,
                                      union_backend=transport.union_backend)
        new_params = _apply_plain(params, agg, eta)
        sub_rows = (sub_ids >= 0).sum()
        metrics = {"loss": loss, "sub_rows": sub_rows,
                   "density": sub_rows / (sub_ids.shape[0] * vocab)}
        return ServerState(new_params, state.opt, state.rounds + 1), metrics

    return step
