"""Execution plans for one federated round.

A :class:`RoundPlan` names a layout as three strategy choices:

``LocalStep``      how the cohort produces deltas: :class:`FedSgdLocal`
                   (I = 1 on the pooled batch, optionally microbatched),
                   :class:`ReplicatedLocal` (I > 1 local SGD on K dense
                   replicas) and :class:`SubmodelReplicatedLocal` (I > 1 on
                   each client's gathered submodel; deltas born row-sparse).
``Transport``      what ships between clients and server, and what a round
                   costs in bytes: :class:`RowSparseTransport` with optional
                   top-k row selection and int8 stochastic rounding, or
                   :class:`DenseTransport`.
``ServerUpdate``   the heat correction plus the algorithm that applies the
                   aggregate: fedavg, fedprox, fedsubavg, scaffold, fedadam.

``FedConfig`` flags resolve through :func:`plan_from_config` (the trainer)
and the four mode strings of ``make_round_step`` through
:func:`resolve_plan`. :func:`build_round_step` turns any composition into a
single-device round step, with the heat static (the trainer) or read from
the batch's ``heat_*`` entries (the simulation entry point), and with the
RowSparse contract checked at the plane's boundaries under
``debug_checks``, and with ``telemetry=True`` the round's
:class:`~repro_torch.telemetry.round.RoundTelemetry`. ``CohortSharding``
(ROADMAP Queue 1 item 8) is not ported: building a step with it raises
``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.analysis import sanitize
from repro_torch.configs.base import SERVER_ALGORITHMS, FedConfig
from repro_torch.core.aggregate import (HeatSpec, cohort_mean, correct_dense_leaf,
                                        correct_update_tree)
from repro_torch.core.algorithms import (ServerAlgorithm, ServerState,
                                         make_server_algorithm)
from repro_torch.federated.client import (cohort_deltas, cohort_submodel_deltas,
                                          make_local_trainer,
                                          make_submodel_local_trainer)
from repro_torch.sparse.aggregate import (apply_rowsparse, correct_rowsparse,
                                          sparse_cohort_aggregate)
from repro_torch.sparse.comm import (CommMeta, CommStats, model_comm_meta,
                                     round_comm_stats)
from repro_torch.sparse.compress import compress_delta_tree
from repro_torch.sparse.encode import (DEFAULT_SPARSE_SPACES, batch_union_ids,
                                       decode_delta_tree, encode_delta_tree,
                                       flat_feature_ids, sparse_eligible,
                                       stacked_feature_ids, submodel_value_and_grad)
from repro_torch.sparse.rowsparse import RowSparse, is_rowsparse, unique_ids_padded
from repro_torch.telemetry.round import (HEAT_BUCKETS, RoundTelemetry, drop_stats,
                                         heat_histogram, tree_agg_rows, tree_sq_sum,
                                         union_ids_vec)

#: round-plan server algorithms ("central" is not a federated round)
PLAN_ALGORITHMS = tuple(a for a in SERVER_ALGORITHMS if a != "central")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item {item}): the port "
        "builds every local step, transport and server update on one device")


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


def round_capacity(vocab: int, ids_size: int, align: int = 8) -> int:
    """Union-id capacity of one sparse round step: ``min(vocab, ids_size)``
    rounded up to a multiple of ``align``, then clamped back to ``vocab``."""
    cap = min(int(vocab), int(ids_size))
    cap += (-cap) % align
    return min(cap, int(vocab))


def split_heat_batch(batch: Dict) -> Tuple[Dict, Dict]:
    """Split a round batch into its ``heat_*`` vectors and the cohort data.

    The simulation entry point carries the heat in the batch (``heat_vocab``
    and so on); the trainer bakes it into the step and its batches carry
    none.
    """
    heat = {k: v for k, v in batch.items() if k.startswith("heat_")}
    data = {k: v for k, v in batch.items() if not k.startswith("heat_")}
    return heat, data


# ---------------------------------------------------------------------------
# strategy objects
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FedSgdLocal:
    """I = 1: the cohort-mean delta is one gradient of the pooled batch.

    ``microbatches > 1`` splits the batch for gradient accumulation (dense
    transport only: the sparse plane computes one fused cohort gradient).
    Data layout: flat ``(B, ...)`` leaves. FedProx is a no-op here: one step
    taken at the prox anchor has a zero prox gradient.
    """

    microbatches: int = 1
    stacked = False


@dataclass(frozen=True)
class ReplicatedLocal:
    """I > 1 local SGD on per-client dense replicas: K full copies of the
    parameters under ``vmap``, dense deltas. ``prox_mu`` as below."""

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
    """Full dense update trees ship both ways (the classic FL layout)."""

    sparse = False

    def round_comm(self, rnd: int, meta: CommMeta, valid_counts: np.ndarray,
                   num_features: int, capacity: Optional[int] = None,
                   submodel_downlink: bool = False,
                   local_iters: int = 1) -> Optional[CommStats]:
        """Dense rounds have no sparse-plane pricing to log."""
        return None


@dataclass(frozen=True)
class RowSparseTransport:
    """Row-sparse ``(ids, rows)`` updates — the paper's submodel wire format.

    ``topk``: keep only the k largest-L2 delta rows per client (0 = off).
    ``int8``: unbiased stochastic-rounding int8 row payloads.
    ``union_backend``: server segment-sum backend (``"auto"``/``"cuda"``/
    ``"bitmap"``/``"sort"`` — see ``repro_torch.sparse.aggregate``).
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
    """Shard the cohort axis over devices (not ported yet: Queue 1 item 8)."""

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
        base = (f"{type(self.local).__name__} -> "
                f"{type(self.transport).__name__} -> "
                f"ServerUpdate({self.server.algorithm})")
        if self.debug_checks:
            base += " [debug_checks]"
        return base


def resolve_plan(mode_or_plan, cfg: FedConfig, correct: bool = True,
                 feature_key: str = "tokens") -> RoundPlan:
    """Resolve a ``make_round_step`` mode string into its RoundPlan.

    ``"fedsgd"``, ``"sparse"``, ``"replicated"`` and ``"sparse_replicated"``
    each name one composition. A RoundPlan passes through unchanged, and is
    then the whole truth: the string-mode knobs must not contradict it.
    """
    if isinstance(mode_or_plan, RoundPlan):
        plan = mode_or_plan
        if not correct and plan.server.correct:
            raise ValueError(
                "correct=False conflicts with an explicit RoundPlan whose "
                "ServerUpdate applies the heat correction: encode the choice "
                "in the plan (ServerUpdate('fedavg'), etc.)")
        if feature_key != "tokens" and feature_key not in plan.feature_keys:
            raise ValueError(
                f"feature_key={feature_key!r} conflicts with the explicit "
                f"RoundPlan's feature_keys={plan.feature_keys}: set it on the plan")
        return plan
    server = ServerUpdate("fedsubavg" if correct else "fedavg")
    fk = (feature_key,)
    if mode_or_plan == "fedsgd":
        return RoundPlan(FedSgdLocal(max(cfg.microbatches, 1)), DenseTransport(),
                         server, fk)
    if mode_or_plan == "sparse":
        if cfg.microbatches > 1:
            raise ValueError(
                "mode='sparse' composes with microbatches=1: the sparse plane "
                "computes one fused cohort gradient per round")
        return RoundPlan(FedSgdLocal(), RowSparseTransport(), server, fk)
    if mode_or_plan == "replicated":
        return RoundPlan(ReplicatedLocal(), DenseTransport(), server, fk)
    if mode_or_plan == "sparse_replicated":
        return RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(), server, fk)
    raise ValueError(mode_or_plan)


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


def plan_comm_meta(params: Dict[str, torch.Tensor], axes: Dict[str, Tuple]) -> CommMeta:
    """Static comm geometry of a model for ``Transport.round_comm``."""
    paths = {name for name, _ in sparse_table_paths(heat_spec_from_axes(axes))}
    return model_comm_meta(params, paths)


# ---------------------------------------------------------------------------
# the compiler: plan -> round step
# ---------------------------------------------------------------------------


def _densify_stacked(tree: Dict) -> Dict:
    """Scatter per-client RowSparse leaves ``(K, R)`` back to dense ``(K, V, ...)``."""
    def dense(leaf):
        return torch.stack([RowSparse(ids, rows, leaf.num_rows).to_dense()
                            for ids, rows in zip(leaf.ids, leaf.rows)])

    return {name: dense(leaf) if is_rowsparse(leaf) else leaf
            for name, leaf in tree.items()}


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


def _scale_tree_f32(tree: Dict, s: float) -> Dict:
    """``s * tree`` in float32, RowSparse leaves by their rows."""
    def f(leaf):
        if is_rowsparse(leaf):
            return RowSparse(leaf.ids, leaf.rows.to(torch.float32) * s, leaf.num_rows)
        return leaf.to(torch.float32) * s

    return {name: f(leaf) for name, leaf in tree.items()}


def _microbatches(data: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    """``n`` contiguous slices of every batch leaf along axis 0 (0-d leaves
    go to every slice)."""
    out = [dict() for _ in range(n)]
    for name, x in data.items():
        if x.dim() == 0:
            for mb in out:
                mb[name] = x
            continue
        if x.shape[0] % n:
            raise ValueError(f"batch leaf {name!r} of {x.shape[0]} rows does not "
                             f"split into {n} microbatches")
        for mb, part in zip(out, x.reshape((n, -1) + tuple(x.shape[1:]))):
            mb[name] = part
    return out


def build_round_step(plan: RoundPlan, loss_fn: Callable,
                     axes: Dict[str, Tuple], params_template: Dict[str, torch.Tensor],
                     cfg: FedConfig, *, heat_counts: Optional[Dict[str, torch.Tensor]] = None,
                     total: Optional[float] = None,
                     server_alg: Optional[ServerAlgorithm] = None,
                     telemetry: bool = False) -> Callable:
    """Build the round step of a :class:`RoundPlan` for one device.

    ``step(state, batch, sub_ids=None) -> (new_state, metrics)`` over a
    ``ServerState``. ``batch`` carries the cohort data, flat ``(B, ...)``
    for :class:`FedSgdLocal` and ``(K, I, B, ...)`` for the replicated
    locals, plus, on the simulation entry point, the ``heat_*`` vectors.

    ``heat_counts``/``total``: the static heat (the trainer); when omitted,
    counts are read from the batch's ``heat_*`` entries and ``total =
    cfg.num_clients``. ``sub_ids``: the per-client ``(K, capacity)`` ids or
    the flat union ``(capacity,)``; derived in the step from the batch's
    feature keys when None. ``server_alg``: the ``ServerAlgorithm`` to apply
    through (the trainer passes the one it initialised its state with);
    built here when the plan needs one. The int8 transport's noise stream
    is ``(cfg.seed + 17, state.rounds, leaf)``. ``metrics`` carries
    ``"loss"`` (a replicated local's: the cohort mean of ``loss_fn`` on each
    client's first minibatch at the pre-round parameters; ``FedSgdLocal``'s:
    the pooled batch's); sparse transports add ``"sub_rows"`` and
    ``"density"``.

    ``telemetry=True`` adds the round's :class:`RoundTelemetry` under
    ``metrics["telemetry"]``: pure reads of the step's own tensors, taken
    before the apply, so losses and parameters are the same bit for bit.

    Stateless algorithms on the sparse transport update the table rows of
    ``state.params`` in place; every other apply builds new tensors. With
    ``plan.debug_checks`` on a sparse transport, the sub-ids and the
    aggregate are checked against the RowSparse contract
    (``repro_torch.analysis.sanitize``); the update is the same bit for bit.
    """
    local, transport, server = plan.local, plan.transport, plan.server
    sparse = transport.sparse
    if plan.sharding is not None:
        raise _not_ported("CohortSharding", 8)

    feature_keys = tuple(plan.feature_keys)
    heat_spec = heat_spec_from_axes(axes)
    n_total = float(cfg.num_clients if total is None else total)
    eta = cfg.server_lr
    static_heat = heat_counts is not None
    debug = bool(plan.debug_checks) and sparse     # dense plans: nothing to check
    table_paths = [name for name, _ in sparse_table_paths(heat_spec)]
    vocabs = sorted({int(params_template[p].shape[0]) for p in table_paths})
    vocab = vocabs[-1] if vocabs else 0
    if isinstance(local, SubmodelReplicatedLocal):
        if not table_paths:
            raise ValueError("submodel-replica local training needs at least one "
                             "axis-0 feature table")
        if len(vocabs) != 1:
            raise ValueError(
                f"submodel-replica feature tables disagree on vocab: {vocabs}")
    if isinstance(local, FedSgdLocal) and not sparse:
        if max(local.microbatches, 1) != max(cfg.microbatches, 1):
            raise ValueError(
                f"cfg.microbatches={cfg.microbatches} conflicts with "
                f"FedSgdLocal(microbatches={local.microbatches}): an explicit "
                "plan owns the knob, set it on the plan")
    if isinstance(local, FedSgdLocal) and sparse:
        if max(local.microbatches, 1) > 1 or cfg.microbatches > 1:
            raise ValueError("FedSgdLocal on the sparse transport computes one fused "
                             "cohort gradient: microbatches must be 1")
        if len(table_paths) != 1:
            # one batch union covers one table's gradient support
            raise ValueError(
                f"FedSgdLocal sparse mode supports exactly one axis-0 feature "
                f"table, found {len(table_paths)}: {table_paths}")
    if server_alg is None and not server.stateless:
        server_alg = make_server_algorithm(
            dataclasses.replace(cfg, algorithm=server.algorithm))
    int8_seed = cfg.seed + 17

    def batch_counts(heat: Dict) -> Dict:
        if static_heat:
            return heat_counts
        return {k[len("heat_"):]: v for k, v in heat.items()}

    def require_tables_for_ids():
        if not table_paths or len(vocabs) != 1:
            raise ValueError(
                "in-step sub-id derivation needs feature tables sharing one axis-0 "
                f"id space; found row counts {vocabs}: pass sub_ids explicitly")

    def derive_flat_ids(data: Dict) -> torch.Tensor:
        capacity = round_capacity(vocab, sum(data[k].numel() for k in feature_keys))
        if debug:
            sanitize.check_capacity(capacity, vocab)
        return batch_union_ids(data, feature_keys, capacity)

    def derive_cohort_ids(data: Dict) -> torch.Tensor:
        feats = stacked_feature_ids(data, feature_keys)
        capacity = round_capacity(vocab, feats.shape[1])
        if debug:
            sanitize.check_capacity(capacity, vocab)
        return unique_ids_padded(feats, capacity)

    def check_ids(used_ids: Optional[torch.Tensor], data: Dict, derived: bool) -> None:
        """The round's sub-ids against the RowSparse contract (a caller's
        ids are checked before the step indexes a table with them), and the
        largest-first drop order against the batch's own ids (per client
        for a ``(K, R)`` stack)."""
        if not debug or used_ids is None or not vocab:
            return
        if derived:
            sanitize.check_union_ids(used_ids, vocab, name="sub_ids")
        if used_ids.dim() == 1:
            for k in feature_keys:
                sanitize.check_drop_order(used_ids, data[k], name="sub_ids")
        else:
            sanitize.check_drop_order(used_ids, stacked_feature_ids(data, feature_keys),
                                      name="sub_ids")

    def check_agg(agg: Dict) -> None:
        if debug:
            for leaf in agg.values():
                if is_rowsparse(leaf):
                    sanitize.check_rowsparse(leaf, name="agg")

    # ---- telemetry: pure reads of the round's own tensors ----------------
    heat_space = heat_spec.leaf_spaces[table_paths[0]][0] if table_paths else None

    def cohort_drop_tel(data: Dict, used_ids: Optional[torch.Tensor], device):
        """``(union ids, dropped, mass, per_client)`` from the ids the step
        consumed: the per-client ``(K, R)`` stack or the flat ``(R,)``
        union, priced against the batch's raw feature ids."""
        zi = torch.zeros((), dtype=torch.int32, device=device)
        zf = torch.zeros((), dtype=torch.float32, device=device)
        if not (sparse and vocab) or used_ids is None:
            return None, zi, zf, None
        if used_ids.dim() == 2:
            d_pc, m_pc = drop_stats(stacked_feature_ids(data, feature_keys),
                                    used_ids, vocab)
            return (union_ids_vec(used_ids, vocab), d_pc.sum(dtype=torch.int32),
                    m_pc.sum(), d_pc)
        dropped, mass = drop_stats(flat_feature_ids(data, feature_keys), used_ids, vocab)
        return used_ids, dropped, mass, None

    def assemble_tel(data, used_ids, agg, counts, pre_sq, post_sq) -> RoundTelemetry:
        device = pre_sq.device
        union, dropped, mass, per_client = cohort_drop_tel(data, used_ids, device)
        union_size = ((union >= 0).sum(dtype=torch.int32) if union is not None
                      else torch.zeros((), dtype=torch.int32, device=device))
        hv = counts.get(heat_space) if (counts and heat_space) else None
        hist = (heat_histogram(hv, union) if union is not None and hv is not None
                else torch.zeros(HEAT_BUCKETS, dtype=torch.float32, device=device))
        dens = (union_size.to(torch.float32) / vocab if vocab
                else torch.zeros((), dtype=torch.float32, device=device))
        return RoundTelemetry(
            dropped_ids=dropped, dropped_mass=mass, dropped_per_client=per_client,
            union_size=union_size,
            agg_rows=tree_agg_rows(agg) if agg is not None else None,
            shard_union_sizes=None, delta_norm_pre=torch.sqrt(pre_sq),
            delta_norm_post=torch.sqrt(post_sq), heat_hist=hist, density=dens)

    # run_local(params, data, sub_ids) -> (update, loss | None, used_ids | None, data)
    if isinstance(local, FedSgdLocal) and sparse:
        table = table_paths[0]

        def run_local(params, data, sub_ids):
            if sub_ids is None:
                require_tables_for_ids()
                sub_ids = derive_flat_ids(data)
            loss, grads = submodel_value_and_grad(loss_fn, params, data, table,
                                                  feature_keys, sub_ids)
            return _scale_tree_f32(grads, -cfg.lr), loss, sub_ids, data
    elif isinstance(local, FedSgdLocal):
        nmb = max(local.microbatches, 1)
        g_fn = grad_and_value(loss_fn)

        def run_local(params, data, sub_ids):
            if nmb == 1:
                grads, loss = g_fn(params, data)
            else:
                # gradient accumulation in f32 over contiguous microbatches
                gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                        for k, p in params.items()}
                lsum = None
                for mb in _microbatches(data, nmb):
                    g, l = g_fn(params, mb)
                    gsum = {k: gsum[k] + g[k].to(torch.float32) for k in gsum}
                    lsum = l if lsum is None else lsum + l
                grads = {k: g * (1.0 / nmb) for k, g in gsum.items()}
                loss = lsum / nmb
            return {k: g * (-cfg.lr) for k, g in grads.items()}, loss, None, data
    elif isinstance(local, ReplicatedLocal):
        dense_train = make_local_trainer(loss_fn, cfg, prox_mu=local.prox_mu)

        def run_local(params, data, sub_ids):
            deltas = cohort_deltas(dense_train, params, data)
            if sparse:
                if sub_ids is None:
                    require_tables_for_ids()
                    sub_ids = derive_cohort_ids(data)
                deltas = encode_delta_tree(deltas, heat_spec, sub_ids)
            return deltas, None, sub_ids, data
    elif isinstance(local, SubmodelReplicatedLocal):
        submodel_train = make_submodel_local_trainer(
            loss_fn, cfg, table_paths, feature_keys, prox_mu=local.prox_mu)

        def run_local(params, data, sub_ids):
            if sub_ids is None:
                sub_ids = derive_cohort_ids(data)
            deltas = cohort_submodel_deltas(submodel_train, params, data, sub_ids)
            return deltas, None, sub_ids, data
    else:
        raise TypeError(f"unknown LocalStep: {local!r}")

    def apply_sparse(state: ServerState, agg: Dict) -> ServerState:
        check_agg(agg)
        if server.stateless:
            return ServerState(_apply_plain(state.params, agg, eta), state.opt,
                               state.rounds + 1)
        # stateful optimizers take the dense mean delta, densified once at
        # the server boundary
        return server_alg.apply(state, decode_delta_tree(agg))

    def apply_dense(state: ServerState, update: Dict, counts: Dict) -> ServerState:
        if server_alg is not None:
            return server_alg.apply(state, update)
        corrected = (correct_update_tree(update, heat_spec, counts, n_total)
                     if server.correct else update)
        # cast to each parameter's dtype before the add: the microbatch
        # accumulator is f32, and bf16 parameters must stay bf16
        new = {k: p + corrected[k].to(p.dtype) * eta for k, p in state.params.items()}
        return ServerState(new, state.opt, state.rounds + 1)

    def step(state: ServerState, batch: Dict[str, torch.Tensor],
             sub_ids: Optional[torch.Tensor] = None):
        params = state.params
        heat, data = split_heat_batch(batch)
        counts = batch_counts(heat)
        if debug and sub_ids is not None and vocab:
            sanitize.check_union_ids(sub_ids, vocab, name="sub_ids")
        update, loss, used_ids, data = run_local(params, data, sub_ids)
        check_ids(used_ids, data, derived=sub_ids is None)
        if local.stacked:
            # the monitoring loss reads the pre-round parameters: take it
            # before an in-place apply
            first = {key: v[:, 0] for key, v in data.items()}
            loss = vmap(lambda b: loss_fn(params, b))(first).mean()
        pre_sq = tree_sq_sum(update) if telemetry else None
        tel = None
        if sparse:
            if transport.topk or transport.int8:
                update = compress_delta_tree(
                    update, topk=transport.topk, int8=transport.int8,
                    key=(int8_seed, state.rounds) if transport.int8 else None)
            post_sq = tree_sq_sum(update) if telemetry else None
            if local.stacked:
                agg = sparse_cohort_aggregate(
                    update, heat_spec, counts, n_total, data[feature_keys[0]].shape[0],
                    correct=server.correct, union_backend=transport.union_backend)
            else:
                agg = {}
                for name, leaf in update.items():
                    space = heat_spec.leaf_spaces.get(name)
                    if is_rowsparse(leaf):
                        h = (counts.get(space[0]) if server.correct and space is not None
                             else None)
                        agg[name] = correct_rowsparse(leaf, h, n_total)
                    elif server.correct:
                        agg[name] = correct_dense_leaf(leaf, space, counts, n_total)
                    else:
                        agg[name] = leaf
            if telemetry:
                # read before the stateless apply writes the tables in place
                tel = assemble_tel(data, used_ids, agg, counts, pre_sq, post_sq)
            new_state = apply_sparse(state, agg)
        else:
            if telemetry:
                # dense transport: no wire compression, no union
                tel = assemble_tel(data, used_ids, None, counts, pre_sq, pre_sq)
            if isinstance(local, SubmodelReplicatedLocal):
                update = _densify_stacked(update)
            if local.stacked:
                update = cohort_mean(update)
            new_state = apply_dense(state, update, counts)
        metrics = {"loss": loss}
        if sparse and used_ids is not None and vocab:
            sub_rows = (used_ids >= 0).sum()
            denom = vocab if used_ids.dim() == 1 else used_ids.shape[0] * vocab
            metrics["sub_rows"] = sub_rows
            metrics["density"] = sub_rows / denom
        if telemetry:
            metrics["telemetry"] = tel
        return new_state, metrics

    return step
