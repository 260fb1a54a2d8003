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
:class:`~repro_torch.telemetry.round.RoundTelemetry`.

:class:`CohortSharding` is the optional fourth strategy: it splits the
cohort over the ranks of a :class:`~repro_torch.launch.mesh.CohortMesh`.
Every rank runs the same step on the full cohort batch and takes its own
shard-major block of clients (of examples, on the flat path); each rank
trains its block and reduces it to a partial, a cross-rank combine builds
the replicated aggregate, and every rank applies it to its replica of the
server state. :func:`round_collective_budget` prices the collectives one
such step makes.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

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
from repro_torch.sharding.context import get_rules
from repro_torch.sparse.aggregate import (aggregate_rowsparse_partial, apply_rowsparse,
                                          combine_rowsparse_partials, correct_rowsparse,
                                          pick_combine, sparse_cohort_aggregate)
from repro_torch.sparse.comm import (CommMeta, CommStats, model_comm_meta,
                                     round_comm_stats)
from repro_torch.sparse.compress import compress_delta_tree
from repro_torch.sparse.encode import (DEFAULT_SPARSE_SPACES, batch_union_ids,
                                       decode_delta_tree, encode_delta_tree,
                                       flat_feature_ids, pin_labels, sparse_eligible,
                                       stacked_feature_ids, submodel_value_and_grad)
from repro_torch.sparse.rowsparse import (RowSparse, count_unique_ids, is_rowsparse,
                                          unique_ids_padded)
from repro_torch.telemetry.round import (HEAT_BUCKETS, RoundTelemetry, drop_stats,
                                         heat_histogram, tree_agg_rows, tree_sq_sum,
                                         union_ids_vec)

#: round-plan server algorithms ("central" is not a federated round)
PLAN_ALGORITHMS = tuple(a for a in SERVER_ALGORITHMS if a != "central")


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
    """Shard one round's cohort axis over the ranks of a mesh.

    ``mesh``/``axis`` name the mesh axis the cohort is split over (a
    :class:`~repro_torch.launch.mesh.CohortMesh`, or anything with
    ``axis_names`` and ``shape`` keyed by axis). Each rank trains its
    K/ranks clients and reduces them to a partial; a cross-rank combine
    builds the replicated aggregate before the server apply, which is the
    same on every rank. ``combine`` picks the sparse plane's cross-rank
    reduction: ``"psum"`` (densify and all-reduce), ``"union"`` (all-gather
    the partial unions and segment-sum them again) or ``"auto"`` (by bytes,
    ``repro_torch.sparse.aggregate.pick_combine``).

    ``shapes`` are the parameters' global shapes where the rank holds its
    part of them: on a ``(data, model)`` mesh, ``mesh`` its data axis and
    the rules installed (``sharding.context.set_rules``), the step reads
    from them which leaves the rules split over ``model`` and the table's
    whole vocabulary. A model axis above 1 needs them on the sparse
    transport and for telemetry.
    """

    mesh: object
    axis: str = "data"
    combine: str = "auto"
    shapes: Optional[Dict[str, Tuple[int, ...]]] = None

    def __post_init__(self):
        if self.axis not in self.mesh.axis_names:
            raise ValueError(
                f"CohortSharding axis {self.axis!r} not in mesh axes "
                f"{self.mesh.axis_names}")
        if self.combine not in ("auto", "psum", "union"):
            raise ValueError(
                f"unknown combine strategy {self.combine!r}: expected "
                "'auto', 'psum' or 'union'")

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])


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
        if self.sharding is not None:
            base += (f" [sharded x{self.sharding.num_shards} over "
                     f"'{self.sharding.axis}']")
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


def round_collective_budget(plan: RoundPlan, axes: Dict[str, Tuple],
                            params_template: Dict[str, torch.Tensor], cfg: FedConfig,
                            batch: Dict, *, sub_ids: Optional[torch.Tensor] = None) -> Dict:
    """Per-rank collective budget of one cohort-sharded round step.

    The JAX package's function term by term: the collectives the shard
    bodies of :func:`build_round_step` make with telemetry off, priced per
    rank, payloads as f32 and ids as int32 (an all-gather counts its whole
    output). A :class:`~repro_torch.launch.mesh.CohortMesh` counts what a
    step really moved under the same component names.

    - stacked locals: ``loss`` and ``sub_rows`` all-reduces (4 B each),
      ``dense_leaves`` (the non-table leaves), and per table the combine
      ``pick_combine`` chooses: an all-reduce of the densified ``(V, E)``
      partial, or an all-gather of the partial's ``min(V, K_shard * cap)``
      ids and rows. A dense transport moves every leaf as ``dense_tree``.
    - the flat local: ``loss``, ``dense_leaves``, the one table's combine
      over the round's union capacity and the ``used_ids`` all-gather that
      counts the cross-rank union (or ``dense_tree`` on a dense transport).

    Returns ``{"axis", "num_shards", "vocab", "stacked", "combine": {table:
    mode}, "capacity": {table: per-rank partial capacity}, "components":
    {name: {"op", "bytes"}}, "by_op", "allowed_ops"}``.
    """
    sharding = plan.sharding
    if sharding is None:
        raise ValueError("round_collective_budget prices the cross-shard "
                         "combine: the plan has no CohortSharding")
    local, sparse = plan.local, plan.transport.sparse
    ndev = sharding.num_shards
    feature_keys = tuple(plan.feature_keys)
    table_paths = [name for name, _ in sparse_table_paths(heat_spec_from_axes(axes))]
    vocabs = sorted({int(params_template[p].shape[0]) for p in table_paths})
    vocab = vocabs[-1] if vocabs else 0
    _, data = split_heat_batch(batch)
    tables = [(p, int(params_template[p].shape[0]),
               max(math.prod(params_template[p].shape[1:]), 1)) for p in table_paths]
    static_f32 = sum(float(x.numel()) for name, x in params_template.items()
                     if name not in table_paths) * 4.0
    dense_tree = sum(float(x.numel()) * 4.0 for x in params_template.values())

    components: Dict[str, Dict] = {}
    combine_modes: Dict[str, str] = {}
    capacities: Dict[str, int] = {}

    def add(name, op, nbytes):
        if nbytes > 0:
            components[name] = {"op": op, "bytes": float(nbytes)}

    def add_combine(name, v_t, elems_t, cap):
        mode = pick_combine(v_t, elems_t, sharding.combine)
        combine_modes[name] = mode
        capacities[name] = cap
        if mode == "psum":
            add(f"combine:{name}", "all-reduce", float(v_t) * elems_t * 4.0)
        else:
            add(f"combine:{name}", "all-gather", float(ndev) * cap * (4.0 + elems_t * 4.0))

    add("loss", "all-reduce", 4.0)
    if not sparse:
        add("dense_tree", "all-reduce", dense_tree)
    elif local.stacked:
        k_shard = -(-int(data[feature_keys[0]].shape[0]) // ndev)
        add("sub_rows", "all-reduce", 4.0)
        add("dense_leaves", "all-reduce", static_f32)
        cap_client = (int(sub_ids.shape[-1]) if sub_ids is not None else round_capacity(
            vocab, sum(math.prod(data[k].shape[1:]) for k in feature_keys)))
        for name, v_t, elems_t in tables:
            add_combine(name, v_t, elems_t, min(v_t, k_shard * cap_client))
    else:
        add("dense_leaves", "all-reduce", static_f32)
        cap = (int(sub_ids.shape[-1]) if sub_ids is not None else round_capacity(
            vocab, sum(data[k].numel() // ndev for k in feature_keys)))
        add_combine(*tables[0], cap)
        add("used_ids", "all-gather", float(ndev) * cap * 4.0)

    by_op: Dict[str, float] = {}
    for c in components.values():
        by_op[c["op"]] = by_op.get(c["op"], 0.0) + c["bytes"]
    return {"axis": sharding.axis, "num_shards": ndev, "vocab": vocab,
            "stacked": bool(local.stacked), "combine": combine_modes,
            "capacity": capacities, "components": components, "by_op": by_op,
            "allowed_ops": sorted(by_op)}


def _budget_axes(mesh, rules: Dict) -> Tuple[Dict[str, Dict], str, int]:
    """The counters' empty per-axis dict of ``mesh`` (its axes, joint ones
    too, as ``DeviceMesh.counters`` keys them), the rules' batch axes' key
    and their shard count."""
    from repro_torch.launch.mesh import axis_key

    keys = list(getattr(mesh, "axes", None) or mesh.axis_names)
    batch = tuple(n for n in (rules.get("batch") or ()) if n in mesh.shape) or ("data",)
    return ({k: {} for k in keys}, axis_key(batch),
            math.prod(int(mesh.shape.get(n, 1)) for n in batch))


def _fsdp_leaves(cfg, shapes: Dict, split) -> Tuple[List[float], Dict[str, float], frozenset]:
    """Under FSDP (``split.data``): the bytes one gather of each layer's
    weights makes whole (its leaves with a ``d_model`` dim, at their local
    shapes times the data ranks), those of ``final_norm.scale`` and
    ``lm_head``, and the names of every leaf split over ``data`` (those and
    the embedding, whose rows ``lookup_for_data`` gathers instead). Empty
    off FSDP."""
    from repro_torch.models.transformer import _TOP_EMBED_DIMS, layer_embed_dims

    if split.data is None:
        return [], {}, frozenset()
    dims = layer_embed_dims(cfg)
    layers = [0.0] * cfg.num_layers
    top: Dict[str, float] = {}
    names = set()
    for name, (shape, size) in shapes.items():
        whole = math.prod(shape) * size * split.data.size
        m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
        if m and m.group(2) in dims:
            layers[int(m.group(1))] += whole
        elif name in _TOP_EMBED_DIMS:
            top[name] = whole
        elif name != "embedding":
            continue
        names.add(name)
    return layers, top, frozenset(names)


def tp_collective_budget(cfg, mesh, batch: Dict, *, rules: Optional[Dict] = None,
                         remat: bool = True, sparse: bool = False,
                         combine: str = "auto") -> Dict:
    """Per-rank collectives of one FedSGD round of any LLM family on a
    ``(data, model)`` :class:`~repro_torch.launch.mesh.DeviceMesh`.

    The round step's on the ``data`` axis (``CohortSharding``'s flat shard,
    dense transport): the ``loss`` all-reduce (4 B) and ``dense_tree``, an
    all-reduce of every leaf of the rank's gradient. On the row-sparse
    transport (``sparse``) instead, over the rank's union capacity ``R =
    round_capacity(V, T)`` and the table's rows ``V'`` on the rank (``V /
    model`` where the vocabulary is split): ``dense_leaves`` (the other
    leaves in f32), ``combine:<table>`` (``pick_combine(V', d, combine)``:
    an all-reduce of the f32 ``(V', d)`` slice, or an all-gather of every
    data rank's R ids and f32 rows) and ``used_ids`` (an all-gather of R
    ids); on ``model``, where the table is split, ``sub_rows:<table>`` (the
    gathered ``(R, d)`` sub-table in the model's dtype) in place of
    ``embed``: the loss looks the tokens up in the whole sub-table. The
    model's on the
    ``model`` axis, under the rules' split (``transformer.model_split``),
    per layer and pass over ``T = B / data`` ranks' tokens of width ``d`` in
    the model's dtype:

    - a forward pass: ``attn_out`` (T x d), ``mlp_out`` or ``moe_out`` (T x
      d), and under expert parallelism ``router_logits``, an all-gather of
      T x E; once more for remat's recompute of the layer in the backward,
      and once more again for each layer but a group's last under two-level
      remat (``cfg.remat_groups``);
    - the backward: ``attn_in``, ``mlp_in`` or ``moe_in`` (T x d),
      ``moe_gates`` (T x k), ``router_in`` (T x d), and where the KV heads
      are whole on every rank the gradients of ``wk`` and ``wv``
      (``attn_kv``), of the QK norms (``qk_norm``);
    - a MoE layer with more than one ``data`` rank routes the whole batch:
      per forward pass ``moe_counts`` (an all-gather of each rank's int32
      counts per expert) and ``moe_aux`` (f32 2 x E) on the data axis;
    - outside the layers, split over the vocabulary: ``embed`` (T x d,
      forward), ``xent_in`` (T x d, backward), and per sequence chunk
      ``xent_max`` (f32 B x c) and ``xent_sum`` (f32 2 x B x c).

    Under FSDP (the rules' ``embed`` over ``data``: ``model_split``'s
    ``data``) on ``data``: ``fsdp_gather``, per layer and forward pass (the
    remat counts above) an all-gather of the layer's weights made whole,
    and once each the embedding (the dense transport's; the sparse one
    the final norm and ``lm_head``; ``fsdp_grad``, a reduce-scatter of each
    of them, once. The embedding's rows (``lookup_for_data``): the rank's T
    ids gathered as int32 (``fsdp_ids``, data x T x 4), their rows gathered
    (``fsdp_gather``, data x T x d) and on the dense transport their
    gradient reduce-scattered (``fsdp_grad``); the sparse transport looks up
    its R union rows so, with no gradient.
    Those leaves then leave ``dense_tree`` (``dense_leaves`` on the sparse
    transport) and, on the multi-pod mesh, are summed over ``pod`` instead
    (under the same tag). Every cohort collective (``loss``, ``dense_tree``,
    the combine, ``moe_counts``) is on the rules' batch axes: ``data``, or
    the joint ``pod+data`` of the multi-pod mesh.

    The other families, each forward pass counted as above (Whisper's
    encoder layers always twice: the reference always rematerialises them):

    - Whisper: per encoder layer an attention and the MLP over its ``Te =
      B / data * encoder_seq`` frames, per decoder layer two attentions and
      the MLP, its cross-attention's keys' input under ``cross_in`` (Te x
      d); ``attn_kv`` counts ``wv``'s bias, as ``wk`` has none;
    - Zamba2: per Mamba2 layer split by SSM heads ``ssm_proj`` and
      ``ssm_conv`` (all-gathers of T x the fused projection's and the
      conv's widths), ``ssm_norm`` (f32 T, also in the backward),
      ``ssm_out`` (T x d); in the backward ``ssm_in`` (T x d), the two
      gathers' gradients (``ssm_proj_grad``, ``ssm_conv_grad``) and
      ``ssm_leaves`` (f32 ``a_log``, ``dt_bias``, ``d_skip`` and
      ``out_norm``'s scale); per attention site the shared block's
      attention and MLP;
    - xLSTM: per mLSTM block ``mlstm_up`` (T x inner dim), ``mlstm_gate``
      (``w_i`` and ``w_f``, 2 x inner x heads), ``mlstm_norm`` (f32 T, also
      in the backward), ``mlstm_out`` (T x d), and in the backward
      ``mlstm_in`` (T x d), ``mlstm_up_grad``, ``mlstm_gate_grad`` (the
      gathers' gradients, reduce-scatters of their whole width, as
      ``ssm_proj_grad`` and ``ssm_conv_grad``) and
      ``mlstm_leaves`` (f32 ``b_i``, ``b_f`` and ``out_norm``'s scale); per
      sLSTM block ``slstm_pre`` (f32 T x 4d), ``slstm_up`` (T x 2d),
      ``slstm_out`` (T x d), and in the backward ``slstm_in`` and
      ``slstm_hs`` (T x d) and ``slstm_up_grad`` (a reduce-scatter of T x
      2d).

    ``batch`` is the round's whole batch (its ``tokens`` give B and S).
    ``rules`` default to the installed ones. Returns ``{"axes": {axis: {tag:
    {"op", "bytes"}}}, "by_op": {axis: {op: bytes}}}``, laid out as
    ``DeviceMesh.counters`` after a round that started from zero.
    """
    from repro_torch.launch.shardings import local_shapes
    from repro_torch.models.transformer import model_dtype, model_split
    from repro_torch.sharding.context import get_rules, set_rules

    installed = get_rules()
    rules = installed[1] if rules is None else rules
    if rules is None:
        raise ValueError("tp_collective_budget: no rules installed or given")
    set_rules(mesh, rules)
    try:
        split = model_split(cfg)
    finally:
        set_rules(*installed)
    b, s = (int(n) for n in batch["tokens"].shape)
    axes, bkey, ndata = _budget_axes(mesh, rules)
    t = b // ndata * s
    d, a = cfg.d_model, torch.empty((), dtype=model_dtype(cfg)).element_size()

    def add(axis, tag, op, nbytes):
        if nbytes > 0:
            c = axes[axis].setdefault(tag, {"op": op, "bytes": 0.0})
            c["bytes"] += float(nbytes)

    shapes = local_shapes(cfg, mesh, rules)
    fsdp_layers, fsdp_top, on_data = _fsdp_leaves(cfg, shapes, split)
    pod = "pod" if on_data and "pod" in bkey.split("+") and mesh.shape["pod"] > 1 else None
    add(bkey, "loss", "all-reduce", 4)
    if not sparse:
        add(bkey, "dense_tree", "all-reduce",
            sum(math.prod(shape) * size for name, (shape, size) in shapes.items()
                if name not in on_data))
        if pod:
            add(pod, "dense_tree", "all-reduce",
                sum(math.prod(shape) * size for name, (shape, size) in shapes.items()
                    if name in on_data))
        for name, whole in fsdp_top.items():
            add("data", "fsdp_gather", "all-gather", whole)
            add("data", "fsdp_grad", "reduce-scatter", whole)
        if on_data:
            n = split.data.size
            add("data", "fsdp_ids", "all-gather", n * t * 4)
            add("data", "fsdp_gather", "all-gather", n * t * d * a)
            add("data", "fsdp_grad", "reduce-scatter", n * t * d * a)
    else:
        cap = round_capacity(cfg.vocab_size, t)
        rows = shapes["embedding"][0][0]
        add(bkey, "dense_leaves", "all-reduce",
            sum(math.prod(shape) * 4 for name, (shape, _) in shapes.items()
                if name != "embedding" and name not in on_data))
        if pod:
            add(pod, "dense_leaves", "all-reduce",
                sum(math.prod(shape) * 4 for name, (shape, _) in shapes.items()
                    if name != "embedding" and name in on_data))
        if pick_combine(rows, d, combine) == "psum":
            add(bkey, "combine:embedding", "all-reduce", rows * d * 4)
        else:
            add(bkey, "combine:embedding", "all-gather", ndata * cap * (4 + d * 4))
        add(bkey, "used_ids", "all-gather", ndata * cap * 4)
        if split.vocab is not None:
            add("model", "sub_rows:embedding", "all-reduce", cap * d * a)
        for name, whole in fsdp_top.items():
            add("data", "fsdp_gather", "all-gather", whole)
            add("data", "fsdp_grad", "reduce-scatter", whole)
        if on_data:
            n = split.data.size
            add("data", "fsdp_ids", "all-gather", n * cap * 4)
            add("data", "fsdp_gather", "all-gather", n * cap * d * a)
    def attention(fwd, tq, tkv=0, kv_biases=2 if cfg.qkv_bias else 0):
        # tkv: the tokens of a cross-attention's keys (their input's own tag)
        if split.heads is None:
            return
        add("model", "attn_out", "all-reduce", fwd * tq * d * a)
        add("model", "attn_in", "all-reduce", tq * d * a)
        if tkv:
            add("model", "cross_in", "all-reduce", tkv * d * a)
        if split.kv is None:
            kv = cfg.num_kv_heads * cfg.head_dim
            add("model", "attn_kv", "all-reduce", (2 * d * kv + kv_biases * kv) * a)
        if cfg.qk_norm:
            add("model", "qk_norm", "all-reduce", 2 * cfg.head_dim * 4)

    def mlp(fwd, tt):
        if split.ffn is not None:
            add("model", "mlp_out", "all-reduce", fwd * tt * d * a)
            add("model", "mlp_in", "all-reduce", tt * d * a)

    fwd1 = 2 if remat else 1
    if cfg.family == "audio":
        # the encoder is always rematted in grad mode, as the reference's
        te = b // ndata * cfg.encoder_seq
        for _ in range(cfg.encoder_layers):
            attention(2, te, kv_biases=1)
            mlp(2, te)
        for _ in range(cfg.num_layers):
            attention(fwd1, t, kv_biases=1)
            attention(fwd1, t, te, kv_biases=1)
            mlp(fwd1, t)
    elif cfg.family == "hybrid":
        di, n, h = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_heads
        proj, conv = 2 * di + 2 * n + h, di + 2 * n
        for i in range(cfg.num_layers):
            if split.ssm is not None:
                add("model", "ssm_proj", "all-gather", fwd1 * t * proj * a)
                add("model", "ssm_conv", "all-gather", fwd1 * t * conv * a)
                add("model", "ssm_norm", "all-reduce", (fwd1 + 1) * t * 4)
                add("model", "ssm_out", "all-reduce", fwd1 * t * d * a)
                add("model", "ssm_in", "all-reduce", t * d * a)
                add("model", "ssm_proj_grad", "reduce-scatter", t * proj * a)
                add("model", "ssm_conv_grad", "reduce-scatter", t * conv * a)
                add("model", "ssm_leaves", "all-reduce", (3 * h + di) * 4)
            if (i + 1) % cfg.attn_every == 0:
                attention(fwd1, t)
                mlp(fwd1, t)
    elif cfg.family == "ssm":
        di, h = cfg.ssm_expand * d, cfg.ssm_heads
        for kind in cfg.block_pattern:
            if kind == "m" and split.mlstm is not None:
                add("model", "mlstm_up", "all-gather", fwd1 * t * di * a)
                add("model", "mlstm_gate", "all-gather", fwd1 * 2 * di * h * a)
                add("model", "mlstm_norm", "all-reduce", (fwd1 + 1) * t * 4)
                add("model", "mlstm_out", "all-reduce", fwd1 * t * d * a)
                add("model", "mlstm_in", "all-reduce", t * d * a)
                add("model", "mlstm_up_grad", "reduce-scatter", t * di * a)
                add("model", "mlstm_gate_grad", "reduce-scatter", 2 * di * h * a)
                add("model", "mlstm_leaves", "all-reduce", (2 * h + di) * 4)
            if kind == "s" and split.slstm is not None:
                add("model", "slstm_pre", "all-gather", fwd1 * t * 4 * d * 4)
                add("model", "slstm_up", "all-gather", fwd1 * t * 2 * d * a)
                add("model", "slstm_out", "all-reduce", fwd1 * t * d * a)
                add("model", "slstm_in", "all-reduce", t * d * a)
                add("model", "slstm_hs", "all-reduce", t * d * a)
                add("model", "slstm_up_grad", "reduce-scatter", t * 2 * d * a)
    nl = cfg.num_layers if cfg.family in ("dense", "moe", "vlm") else 0
    g = cfg.remat_groups
    per = nl // g if remat and g > 1 and nl % g == 0 else 1
    for i in range(nl):
        fwd = 1 if not remat else 2 + (per > 1 and i % per != per - 1)
        if fsdp_layers:
            add("data", "fsdp_gather", "all-gather", fwd * fsdp_layers[i])
            add("data", "fsdp_grad", "reduce-scatter", fsdp_layers[i])
        attention(fwd, t)
        if not cfg.is_moe:
            mlp(fwd, t)
        if split.batch is not None:
            add(bkey, "moe_counts", "all-gather", fwd * split.batch.size * cfg.num_experts * 4)
            add(bkey, "moe_aux", "all-reduce", fwd * 2 * cfg.num_experts * 4)
        if cfg.is_moe and (split.experts is not None or split.ffn is not None):
            add("model", "moe_out", "all-reduce", fwd * t * d * a)
            add("model", "moe_in", "all-reduce", t * d * a)
            add("model", "moe_gates", "all-reduce", t * cfg.experts_per_token * a)
            if split.experts is not None:
                add("model", "router_logits", "all-gather", fwd * t * cfg.num_experts * a)
                add("model", "router_in", "all-reduce", t * d * a)
    if split.vocab is not None:
        if not sparse:
            add("model", "embed", "all-reduce", t * d * a)
        add("model", "xent_in", "all-reduce", t * d * a)
        add("model", "xent_max", "all-reduce", t * 4)
        add("model", "xent_sum", "all-reduce", 2 * t * 4)
    by_op = {axis: {} for axis in axes}
    for axis, comps in axes.items():
        for c in comps.values():
            by_op[axis][c["op"]] = by_op[axis].get(c["op"], 0.0) + c["bytes"]
    return {"axes": axes, "by_op": by_op}


def serve_collective_budget(cfg, mesh, batch: int, prompt: int, gen: int, *,
                            rules: Optional[Dict] = None) -> Dict:
    """Per-rank collectives of sharded serving (``launch.serve.serve`` on a
    ``(data, model)`` :class:`~repro_torch.launch.mesh.DeviceMesh` under
    ``make_rules("decode")``): one prefill of ``batch`` prompts of
    ``prompt`` tokens, and one decode step, whose collectives are the same
    at every step. Over ``b`` = the rank's sequences (``batch / data``
    where it divides) and the model's dtype size ``a``, by the split of
    ``transformer.model_split`` and the cache's of
    ``launch.shardings.cache_specs`` (its ``prompt + gen`` slots, or the
    window, split over ``model`` where they divide):

    - the prefill (``T = b * prompt`` tokens): ``embed`` (T x d); per
      layer ``attn_out`` (T x d) where the heads are split, ``mlp_out`` or
      ``moe_out`` (T x d) where the FFN or the experts are,
      ``router_logits`` (an all-gather of T x E) under expert parallelism,
      ``prefill_kv`` (an all-gather of K and V, 2 x T x KV x hd) where the
      KV heads are split; ``logits`` (an all-gather of f32 b x V);
    - a step: the same with ``T = b``, and per layer ``decode_q`` (an
      all-gather of b x H x hd) where the heads are split, ``decode_kv``
      (2 x b x KV x hd) where the KV heads are, and where the cache is split
      by sequence the merge of K4's partials: ``decode_max`` (f32 b x H)
      and ``decode_merge`` (f32 b x H x (hd + 1));
    - a MoE layer on more than one ``data`` rank routes the whole batch:
      ``moe_counts`` (an all-gather of int32 counts per expert) and
      ``moe_aux`` (f32 2 x E) on the rules' batch axes (``data``, or the
      joint ``pod+data``), in the prefill and in each step;
    - under FSDP, on ``data``: ``fsdp_gather``, each layer's weights made
      whole once, the final norm and ``lm_head`` once, and the embedding's
      rows (``lookup_for_data``: data x T x d, and ``fsdp_ids``, data x T x
      4), in the prefill and in each step.

    ``b`` is the batch over the rules' batch axes (``data``, or ``pod`` and
    ``data`` on the multi-pod mesh).

    The other families:

    - Whisper: the prefill's encoder layers an attention and the MLP over
      ``Te = b * encoder_seq`` frames; per decoder layer the self-attention,
      the cross-attention (its ``prefill_kv`` of 2 x Te x KV x hd; in a step
      no K/V gather, and the merge where the frames' slots are split) and
      the MLP;
    - Zamba2: per Mamba2 layer split by SSM heads ``ssm_proj`` and
      ``ssm_conv`` (all-gathers of T x the fused projection's and the
      conv's widths), ``ssm_norm`` (f32 T) and ``ssm_out`` (T x d, f32 in a
      step); per attention site the shared block's attention and MLP;
    - xLSTM: per mLSTM block ``mlstm_up`` (T x inner dim), ``mlstm_gate``
      (2 x inner x heads), ``mlstm_norm`` (f32 T), ``mlstm_out`` (T x d),
      in the prefill ``mlstm_state`` (f32: the cache's layout gathered into
      the rank's heads, ``c`` and ``n``, and back, ``c``, ``n`` and ``m``),
      in a step ``mlstm_qkv`` (3 x b x inner) and ``mlstm_merge`` (f32 b x
      heads x (head dim + 1)); per sLSTM block ``slstm_pre`` (f32 T x 4d),
      ``slstm_state`` (f32 4 x b x d), ``slstm_up`` (T x 2d) and
      ``slstm_out`` (T x d).

    ``rules`` default to the installed ones. Returns ``{"prefill": {axis:
    {tag: {"op", "bytes"}}}, "step": ...}``, laid out as
    ``DeviceMesh.counters`` after a prefill and after a step that each
    started from zero."""
    from repro_torch.launch.shardings import _fit_spec
    from repro_torch.models.transformer import model_dtype, model_split
    from repro_torch.sharding.context import get_rules, set_rules

    if cfg.moe_token_chunk:
        raise NotImplementedError("serve_collective_budget: a MoE routed in token chunks")
    installed = get_rules()
    rules = installed[1] if rules is None else rules
    if rules is None:
        raise ValueError("serve_collective_budget: no rules installed or given")
    set_rules(mesh, rules)
    try:
        split = model_split(cfg)
    finally:
        set_rules(*installed)
    m = int(mesh.shape.get("model", 1))
    empty, bkey, data = _budget_axes(mesh, rules)
    b = batch // data if batch % data == 0 else batch
    fsdp_layers, fsdp_top = [], {}
    if split.data is not None:
        from repro_torch.launch.shardings import local_shapes
        fsdp_layers, fsdp_top, _ = _fsdp_leaves(cfg, local_shapes(cfg, mesh, rules), split)
    cap = prompt + gen
    if cfg.sliding_window > 0:
        cap = min(cfg.sliding_window, cap)
    kv_seq = (rules.get("kv_seq") or (None,))[0]
    seq = m > 1 and _fit_spec(mesh, (kv_seq,), (cap,))[0] == "model"
    d, a = cfg.d_model, torch.empty((), dtype=model_dtype(cfg)).element_size()
    hd, e = cfg.head_dim, cfg.num_experts

    def one(t: int, step: bool) -> Dict:
        axes: Dict[str, Dict[str, Dict]] = {name: {} for name in empty}

        def add(axis, tag, op, nbytes):
            c = axes[axis].setdefault(tag, {"op": op, "bytes": 0.0})
            c["bytes"] += float(nbytes)

        def attention(tq, tkv, merge, self_kv=True):
            # tkv: the prefill's key tokens; merge: the slots are split
            if split.heads is not None:
                if step:
                    add("model", "decode_q", "all-gather", b * cfg.num_heads * hd * a)
                add("model", "attn_out", "all-reduce", tq * d * a)
            if split.kv is not None and (self_kv or not step):
                add("model", "decode_kv" if step else "prefill_kv", "all-gather",
                    2 * tkv * cfg.num_kv_heads * hd * a)
            if step and merge:
                add("model", "decode_max", "all-reduce", b * cfg.num_heads * 4)
                add("model", "decode_merge", "all-reduce", b * cfg.num_heads * (hd + 1) * 4)

        def mlp(tt):
            if split.ffn is not None:
                add("model", "mlp_out", "all-reduce", tt * d * a)

        if split.vocab is not None:
            add("model", "embed", "all-reduce", t * d * a)
        if cfg.family == "audio":
            te = b * cfg.encoder_seq
            cross = m > 1 and _fit_spec(mesh, (kv_seq,), (cfg.encoder_seq,))[0] == "model"
            if not step:
                for _ in range(cfg.encoder_layers):
                    attention(te, 0, False)
                    mlp(te)
            for _ in range(cfg.num_layers):
                attention(t, t, seq)
                attention(t, te, cross, self_kv=False)
                mlp(t)
        elif cfg.family == "hybrid":
            di, n, h = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_heads
            for i in range(cfg.num_layers):
                if split.ssm is not None:
                    add("model", "ssm_proj", "all-gather", t * (2 * di + 2 * n + h) * a)
                    add("model", "ssm_conv", "all-gather", t * (di + 2 * n) * a)
                    add("model", "ssm_norm", "all-reduce", t * 4)
                    # a step's SSM output is f32 (ssm.mamba2_block), and so is
                    # out_proj's product in any model dtype
                    add("model", "ssm_out", "all-reduce", t * d * (4 if step else a))
                if (i + 1) % cfg.attn_every == 0:
                    attention(t, t, seq)
                    mlp(t)
        elif cfg.family == "ssm":
            di, h = cfg.ssm_expand * d, cfg.ssm_heads
            hm = di // h
            for kind in cfg.block_pattern:
                if kind == "m" and split.mlstm is not None:
                    add("model", "mlstm_up", "all-gather", t * di * a)
                    add("model", "mlstm_gate", "all-gather", 2 * di * h * a)
                    if step:
                        add("model", "mlstm_qkv", "all-gather", 3 * b * di * a)
                        add("model", "mlstm_merge", "all-reduce", b * h * (hm + 1) * 4)
                    else:
                        # the cache's layout to the rank's heads and back
                        add("model", "mlstm_state", "all-gather",
                            (2 * b * h * hm * hm + 2 * b * h * hm + b * h) * 4)
                    add("model", "mlstm_norm", "all-reduce", t * 4)
                    add("model", "mlstm_out", "all-reduce", t * d * a)
                if kind == "s" and split.slstm is not None:
                    add("model", "slstm_pre", "all-gather", t * 4 * d * 4)
                    add("model", "slstm_state", "all-gather", 4 * b * d * 4)
                    add("model", "slstm_up", "all-gather", t * 2 * d * a)
                    add("model", "slstm_out", "all-reduce", t * d * a)
        for name, whole in fsdp_top.items():
            add("data", "fsdp_gather", "all-gather", whole)
        if fsdp_layers:
            n = split.data.size
            add("data", "fsdp_ids", "all-gather", n * t * 4)
            add("data", "fsdp_gather", "all-gather", n * t * d * a)
        for i in range(cfg.num_layers if cfg.family in ("dense", "moe", "vlm") else 0):
            if fsdp_layers:
                add("data", "fsdp_gather", "all-gather", fsdp_layers[i])
            attention(t, t, seq)
            if not cfg.is_moe:
                mlp(t)
                continue
            if split.batch is not None:
                add(bkey, "moe_counts", "all-gather", split.batch.size * e * 4)
                add(bkey, "moe_aux", "all-reduce", 2 * e * 4)
            if split.experts is not None or split.ffn is not None:
                add("model", "moe_out", "all-reduce", t * d * a)
            if split.experts is not None:
                add("model", "router_logits", "all-gather", t * e * a)
        if split.vocab is not None:
            add("model", "logits", "all-gather", b * cfg.vocab_size * 4)
        return axes

    return {"prefill": one(b * prompt, False), "step": one(b, True)}


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


def batch_axis(name: str) -> int:
    """The batch axis of a batch leaf, keyed on its name as the reference
    keys it: ``mrope_pos`` is ``(3, B, S)``, with a leading coordinate axis;
    every other leaf has the batch on axis 0 (a genuine batch of 3 too)."""
    return 1 if name == "mrope_pos" else 0


def _microbatches(data: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    """``n`` contiguous slices of every batch leaf along its batch axis
    (``batch_axis``; 0-d leaves go to every slice)."""
    out = [dict() for _ in range(n)]
    for name, x in data.items():
        if x.dim() == 0:
            for mb in out:
                mb[name] = x
            continue
        axis = batch_axis(name)
        if x.shape[axis] % n:
            raise ValueError(f"batch leaf {name!r} of {x.shape[axis]} rows does not "
                             f"split into {n} microbatches")
        for mb, part in zip(out, torch.chunk(x, n, dim=axis)):
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
    feature_keys = tuple(plan.feature_keys)
    heat_spec = heat_spec_from_axes(axes)
    n_total = float(cfg.num_clients if total is None else total)
    eta = cfg.server_lr
    static_heat = heat_counts is not None
    debug = bool(plan.debug_checks) and sparse     # dense plans: nothing to check
    table_paths = [name for name, _ in sparse_table_paths(heat_spec)]
    given = plan.sharding.shapes if plan.sharding is not None else None
    # the leaves' global shapes: a rank on a model split holds its part
    shapes = ({name: tuple(given[name]) for name in params_template} if given
              else {name: tuple(t.shape) for name, t in params_template.items()})
    vocabs = sorted({int(shapes[p][0]) for p in table_paths})
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

    def assemble_tel(data, used_ids, agg, counts, pre_sq, post_sq,
                     shard_union_sizes=None, vocab_split=None) -> RoundTelemetry:
        """``vocab_split``: the model axis the table and its heat are split
        over. The heat histogram is then each slice's over the union ids in
        it, and the aggregate's rows each slice's, both summed over it."""
        device = pre_sq.device
        union, dropped, mass, per_client = cohort_drop_tel(data, used_ids, device)
        union_size = ((union >= 0).sum(dtype=torch.int32) if union is not None
                      else torch.zeros((), dtype=torch.int32, device=device))
        hv = counts.get(heat_space) if (counts and heat_space) else None
        if union is None or hv is None:
            hist = torch.zeros(HEAT_BUCKETS, dtype=torch.float32, device=device)
        elif vocab_split is None:
            hist = heat_histogram(hv, union)
        else:
            local = union - vocab_split.rank * hv.shape[0]
            mine = (union >= 0) & (local >= 0) & (local < hv.shape[0])
            hist = vocab_split.psum(heat_histogram(hv, torch.where(mine, local, -1)),
                                    "telemetry:hist")
        agg_rows = tree_agg_rows(agg) if agg is not None else None
        if agg_rows is not None and vocab_split is not None:
            agg_rows = vocab_split.psum(agg_rows, "telemetry:rows")
        dens = (union_size.to(torch.float32) / vocab if vocab
                else torch.zeros((), dtype=torch.float32, device=device))
        return RoundTelemetry(
            dropped_ids=dropped, dropped_mass=mass, dropped_per_client=per_client,
            union_size=union_size, agg_rows=agg_rows,
            shard_union_sizes=shard_union_sizes, delta_norm_pre=torch.sqrt(pre_sq),
            delta_norm_post=torch.sqrt(post_sq), heat_hist=hist, density=dens)

    def model_parts() -> MeshParts:
        """The installed rules' split of the leaves on a sharded step
        (``MeshParts``); nothing split off the mesh. The global shapes are
        needed where a model axis above 1 splits what the step reads (the
        sparse transport, telemetry), and under FSDP."""
        mesh, rules = get_rules()
        if plan.sharding is None or mesh is None:
            return NO_PARTS
        m = int(mesh.shape.get("model", 1))
        fsdp = "data" in (rules.get("embed") or ()) and int(mesh.shape.get("data", 1)) > 1
        if not fsdp and (m == 1 or not (sparse or telemetry)):
            return NO_PARTS
        if not given:
            raise ValueError(
                "a model axis above 1 and FSDP need the parameters' global shapes: pass "
                "CohortSharding(shapes=...)")
        from repro_torch.launch.shardings import param_specs
        specs = param_specs(axes, shapes, mesh, rules)

        def over(axis):
            return frozenset(name for name, spec in specs.items()
                             if any(axis in ((p,) if isinstance(p, str) else p or ())
                                    for p in spec))

        data_leaves = over("data") if fsdp else frozenset()
        rest = [n for n in (rules.get("batch") or ())
                if n != "data" and int(mesh.shape.get(n, 1)) > 1]
        if len(rest) > 1:
            raise NotImplementedError(f"the cohort over {rules.get('batch')}")
        return MeshParts(mesh.axis("model") if m > 1 else None,
                         over("model") if m > 1 else frozenset(),
                         mesh.axis("data") if data_leaves else None, data_leaves,
                         mesh.axis(rest[0]) if rest and data_leaves else None)

    def table_split(table: str):
        """The model axis the rows of ``table`` are split over, or None."""
        parts = model_parts()
        return parts.model if table in parts.model_leaves else None

    def table_cols(table: str):
        """The data axis the columns of ``table`` are split over (FSDP), or
        None."""
        parts = model_parts()
        return parts.data if table in parts.data_leaves else None

    # run_local(params, data, sub_ids) -> (update, loss | None, used_ids | None, data)
    if isinstance(local, FedSgdLocal) and sparse:
        table = table_paths[0]

        def run_local(params, data, sub_ids):
            # next-token targets stay vocabulary ids: pin them before the remap
            data = pin_labels(data, feature_keys[0])
            if sub_ids is None:
                require_tables_for_ids()
                sub_ids = derive_flat_ids(data)
            loss, grads = submodel_value_and_grad(loss_fn, params, data, table,
                                                  feature_keys, sub_ids,
                                                  split=table_split(table),
                                                  cols=table_cols(table))
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
            data = pin_labels(data, feature_keys[0])
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

    if plan.sharding is not None:
        return _sharded_step(
            plan, loss_fn, heat_spec, n_total, vocab, debug, telemetry, run_local,
            check_ids, batch_counts, assemble_tel, apply_sparse, apply_dense, model_parts)

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


# ---------------------------------------------------------------------------
# cohort-sharded execution (plan.sharding): one rank's part of a round
# ---------------------------------------------------------------------------


class MeshParts(NamedTuple):
    """What a sharded step needs of the installed rules' split of the
    leaves: the model axis and the leaves split over it; under FSDP the
    data axis, the leaves whose ``d_model`` is split over it (their
    gradients arrive summed over ``data`` by ``gather_for_data``'s
    reduce-scatter), and the cohort's other axis (``pod``) those still sum
    over."""

    model: Optional[object] = None
    model_leaves: frozenset = frozenset()
    data: Optional[object] = None
    data_leaves: frozenset = frozenset()
    pod: Optional[object] = None


NO_PARTS = MeshParts()


def _own_cols(leaf, data):
    """This data rank's columns (axis 1) of a combined table update, dense
    or ``RowSparse``: the combine sums whole-width rows, and the rank keeps
    the columns of its slice of ``d_model``."""
    if is_rowsparse(leaf):
        w = leaf.rows.shape[1] // data.size
        return RowSparse(leaf.ids, leaf.rows.narrow(1, data.rank * w, w), leaf.num_rows)
    w = leaf.shape[1] // data.size
    return leaf.narrow(1, data.rank * w, w)


def _mask_clients(tree: Dict, wmask: torch.Tensor) -> Dict:
    """Zero the pad clients' contributions (RowSparse rows too)."""
    def m(x):
        return x * wmask.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)

    return {name: RowSparse(leaf.ids, m(leaf.rows), leaf.num_rows)
            if is_rowsparse(leaf) else m(leaf) for name, leaf in tree.items()}


def refuse_sharded_transport(plan: RoundPlan) -> None:
    """The reference's refusals of a transport under ``CohortSharding``
    (int8 rows; top-k on the flat path), raised before any collective."""
    transport = plan.transport
    if not transport.sparse or plan.sharding is None:
        return
    if transport.int8:
        raise ValueError(
            "CohortSharding does not compose with int8 transport yet: the "
            "stochastic-rounding noise is drawn over the full cohort stack and "
            "would not reproduce the single-device stream per shard")
    if transport.topk and isinstance(plan.local, FedSgdLocal):
        raise ValueError(
            "CohortSharding does not compose with top-k on the flat fused-gradient "
            "sparse path: top-k there selects rows of the whole-cohort union, which "
            "no per-shard selection reproduces; use a replicated local (per-client "
            "top-k shards exactly)")


def _sharded_step(plan: RoundPlan, loss_fn: Callable, heat_spec: HeatSpec, n_total: float,
                  vocab: int, debug: bool, telemetry: bool, run_local: Callable,
                  check_ids: Callable, batch_counts: Callable, assemble_tel: Callable,
                  apply_sparse: Callable, apply_dense: Callable,
                  model_parts: Callable) -> Callable:
    """The round step of a plan with ``CohortSharding``, run by every rank.

    Every rank is handed the full cohort batch and the replicated state. A
    stacked cohort of K clients is padded to a multiple of the ranks by
    repeating clients cyclically (the pads are masked out of every
    reduction, and the mean keeps ``1/K``), and rank r trains the clients
    of block r; a flat batch must divide, and rank r takes its block of
    examples (a caller's ``sub_ids`` goes to every rank as it is). The
    collectives all run on ``mesh`` under ``round_collective_budget``'s
    component names (telemetry's under ``"telemetry:norms"`` and
    ``"telemetry:ids"``), so every rank
    issues them in the same order with the same shapes, and every refusal
    raises before the first of them. Under ``debug_checks`` a caller's
    ``sub_ids`` are checked whole on every rank before the split; ids a rank
    derives are checked on that rank. The aggregate is the same on every
    rank: the ``psum`` combine's by construction; the ``union`` combine's
    as long as every rank sums the gathered rows in the same order.

    On a ``(data, model)`` mesh under installed rules (``model_parts``: the
    model axis and the leaves split over it), a rank's table rows and heat
    are its slice of the vocabulary, and the combine over ``mesh`` runs on
    the slice. ``sub_rows`` and ``density`` stay global; telemetry's norms
    add each split leaf's squares over the axes that split it.

    Under FSDP (the rules' ``embed`` over ``data``) a leaf whose ``d_model``
    is split over ``data`` arrives as the sum of the data ranks' gradients
    (``gather_for_data``'s reduce-scatter): it is summed over the cohort's
    other axis (``pod``, multi-pod) and divided by the shard count, not
    averaged over ``data`` again. On the sparse transport the table's rows
    are gathered whole-width, combined over the cohort axis as ever, and
    each rank keeps its columns. A stacked local refuses FSDP.
    """
    local, transport, server = plan.local, plan.transport, plan.server
    sharding = plan.sharding
    mesh, ndev = sharding.mesh, sharding.num_shards
    sparse = transport.sparse
    feature_keys = tuple(plan.feature_keys)
    refuse_sharded_transport(plan)

    def sq_sum(tree: Dict, parts: MeshParts) -> torch.Tensor:
        """``tree_sq_sum`` of the global tree: the squares of each leaf
        split over the model axis, over ``data`` (FSDP) or both summed over
        those axes, the whole leaves' once."""
        if parts.model is None and parts.data is None:
            return tree_sq_sum(tree)
        groups: Dict[Tuple[bool, bool], Dict] = {}
        for name, leaf in tree.items():
            key = (name in parts.model_leaves, name in parts.data_leaves)
            groups.setdefault(key, {})[name] = leaf
        total = None
        for (on_model, on_data), group in sorted(groups.items()):
            sq = tree_sq_sum(group)
            if on_data:
                sq = parts.data.psum(sq, "telemetry:norms")
            if on_model:
                sq = parts.model.psum(sq, "telemetry:norms")
            total = sq if total is None else total + sq
        return total

    def mean_leaf(g, name: str, parts: MeshParts, tag: str) -> torch.Tensor:
        """The mean of a flat shard's leaf over the cohort's shards: a
        ``pmean`` over ``mesh``, or for a leaf ``gather_for_data`` has
        already summed over ``data``, its sum over ``pod`` (multi-pod)
        divided by the shard count."""
        if name not in parts.data_leaves:
            return mesh.pmean(g, tag)
        if parts.pod is not None:
            g = parts.pod.psum(g, tag)
        return g / ndev

    def combine(leaf, name, counts, scale):
        space = heat_spec.leaf_spaces.get(name)
        h = counts.get(space[0]) if server.correct and space is not None else None
        return combine_rowsparse_partials(
            leaf, mesh, h, n_total, scale, combine=sharding.combine,
            union_backend=transport.union_backend, tag=f"combine:{name}")

    def correct_dense(mean, name, counts):
        if not server.correct:
            return mean
        return correct_dense_leaf(mean, heat_spec.leaf_spaces.get(name), counts, n_total)

    def stacked_shard(params, data, sub_ids, wmask, counts, k_real, parts):
        """This rank's clients: local steps, the partial, the combine.
        Returns the replicated aggregate, the loss, the sub-row count and
        telemetry's parts."""
        update, _, used_ids, data = run_local(params, data, sub_ids)
        check_ids(used_ids, data, derived=sub_ids is None)
        # the monitoring loss reads the pre-round parameters
        losses = vmap(lambda b: loss_fn(params, b))({k: v[:, 0] for k, v in data.items()})
        raw = update
        if sparse and transport.topk:
            update = compress_delta_tree(update, topk=transport.topk)
        update = _mask_clients(update, wmask)
        scale = 1.0 / float(k_real)
        agg = {}
        for name, leaf in update.items():
            if not sparse:
                if is_rowsparse(leaf):
                    leaf = _densify_stacked({name: leaf})[name]
                agg[name] = mesh.psum(leaf.sum(dim=0), "dense_tree") * scale
            elif is_rowsparse(leaf):
                part = aggregate_rowsparse_partial(leaf,
                                                   union_backend=transport.union_backend)
                agg[name] = combine(part, name, counts, scale)
            else:
                agg[name] = correct_dense(mesh.psum(leaf.sum(dim=0), "dense_leaves") * scale,
                                          name, counts)
        loss = mesh.psum((losses * wmask).sum(), "loss") / k_real
        if sparse and used_ids is not None:
            valid = (used_ids >= 0) & (wmask > 0)[:, None]
            sub_rows = mesh.psum(valid.sum(dtype=torch.int32), "sub_rows")
        else:
            sub_rows = torch.zeros((), dtype=torch.int32, device=wmask.device)
        if not telemetry:
            return agg, loss, sub_rows, None
        # norms over the real clients only (the pads are cyclic repeats)
        tel = {"pre": mesh.psum(sq_sum(_mask_clients(raw, wmask), parts), "telemetry:norms"),
               "post": mesh.psum(sq_sum(update, parts), "telemetry:norms")}
        if sparse:
            masked = torch.where((wmask > 0)[:, None], used_ids, -1)
            tel["used_ids"] = mesh.all_gather(masked, "telemetry:ids").flatten(0, 1)
            tel["shard_union"] = mesh.all_gather(count_unique_ids(masked.reshape(-1)),
                                                 "telemetry:ids")
        return agg, loss, sub_rows, tel

    def flat_shard(params, data, sub_ids, counts, parts):
        """This rank's examples of the pooled batch. Exact when ``loss_fn``
        is a uniform mean over the batch: the cohort gradient is then the
        mean of equal-sized shard gradients."""
        update, fwd_loss, used_ids, _ = run_local(params, data, sub_ids)
        check_ids(used_ids, data, derived=sub_ids is None)
        scale = 1.0 / float(ndev)
        if sparse:
            agg = {name: combine(leaf, name, counts, scale) if is_rowsparse(leaf)
                   else correct_dense(mean_leaf(leaf, name, parts, "dense_leaves"), name,
                                      counts)
                   for name, leaf in update.items()}
            for name, leaf in update.items():
                if is_rowsparse(leaf) and name in parts.data_leaves:
                    agg[name] = _own_cols(agg[name], parts.data)
            gathered = mesh.all_gather(used_ids, "used_ids")
            # the single-device union count: distinct ids across the ranks
            sub_rows = count_unique_ids(gathered.reshape(-1))
        else:
            agg = {name: mean_leaf(g, name, parts, "dense_tree") for name, g in update.items()}
            sub_rows = torch.zeros((), dtype=torch.int32, device=fwd_loss.device)
        loss = mesh.pmean(fwd_loss, "loss")
        if not telemetry:
            return agg, loss, sub_rows, None
        # the flat path never compresses under sharding, so pre == post:
        # the L2 of the replicated aggregate
        sq = sq_sum(agg, parts)
        tel = {"pre": sq, "post": sq}
        if sparse:
            tel["used_ids"] = gathered
            # one count per rank, of the rank's own union
            tel["shard_union"] = mesh.all_gather(
                (used_ids >= 0).sum(dtype=torch.int32), "telemetry:ids")
        return agg, loss, sub_rows, tel

    def sharded_step(state: ServerState, batch: Dict[str, torch.Tensor],
                     sub_ids: Optional[torch.Tensor] = None):
        params = state.params
        heat, data = split_heat_batch(batch)
        counts = batch_counts(heat)
        if debug and sub_ids is not None and vocab:
            sanitize.check_union_ids(sub_ids, vocab, name="sub_ids")
        r = mesh.rank
        # read first: a refusal raises before the round's first collective
        parts = model_parts()
        table = next((name for name in params if sparse and name in parts.model_leaves
                      and sparse_eligible(heat_spec.leaf_spaces.get(name))), None)
        if table is not None and local.stacked:
            raise NotImplementedError(
                "a stacked local on a vocabulary split over 'model': the per-client "
                "submodels gather whole rows; use FedSgdLocal")
        if parts.data_leaves and local.stacked:
            raise NotImplementedError(
                "a stacked local under FSDP: the per-client steps run under vmap, which "
                "the layers' gathers over 'data' do not support; use FedSgdLocal")
        if local.stacked:
            k_real = int(data[feature_keys[0]].shape[0])
            ks = -(-k_real // ndev)
            device = data[feature_keys[0]].device
            slots = torch.arange(r * ks, (r + 1) * ks, device=device)
            idx = slots % k_real
            wmask = (slots < k_real).to(torch.float32)
            mesh.reset_counters()
            agg, loss, sub_rows, tel = stacked_shard(
                params, {k: v.index_select(0, idx) for k, v in data.items()},
                None if sub_ids is None else sub_ids.index_select(0, idx), wmask, counts,
                k_real, parts)
        else:
            bleaf = feature_keys[0] if feature_keys[0] in data else next(iter(data))
            bsz = int(data[bleaf].shape[0])
            if bsz % ndev:
                raise ValueError(
                    f"flat cohort batch of {bsz} examples does not divide over {ndev} "
                    "shards: pad the batch to a multiple of the mesh axis, or use a "
                    "replicated local (which pads and masks per-client automatically)")
            nmb = max(getattr(local, "microbatches", 1), 1)
            if nmb > 1 and (bsz // ndev) % nmb:
                raise ValueError(
                    f"per-shard batch of {bsz // ndev} examples (batch {bsz} over {ndev} "
                    f"shards) does not divide into {nmb} microbatches: each shard runs "
                    "its own gradient accumulation, so B must be a multiple of ndev * "
                    "microbatches")
            k_real, b = None, bsz // ndev
            mesh.reset_counters()
            agg, loss, sub_rows, tel = flat_shard(
                params, {k: v if v.dim() == 0 else v.narrow(batch_axis(k), r * b, b)
                         for k, v in data.items()}, sub_ids, counts, parts)
        tel_out = None
        if telemetry:
            used = None
            if sparse and vocab:
                used = (tel["used_ids"][:k_real] if k_real is not None
                        else union_ids_vec(tel["used_ids"], vocab))
            # read before the stateless apply writes the tables in place
            tel_out = assemble_tel(data, used, agg if sparse else None, counts,
                                   tel["pre"], tel["post"],
                                   shard_union_sizes=tel.get("shard_union"),
                                   vocab_split=parts.model if table is not None else None)
        new_state = apply_sparse(state, agg) if sparse else apply_dense(state, agg, counts)
        metrics = {"loss": loss}
        if sparse and vocab:
            metrics["sub_rows"] = sub_rows
            metrics["density"] = sub_rows / (vocab if k_real is None else k_real * vocab)
        if telemetry:
            metrics["telemetry"] = tel_out
        return new_state, metrics

    return sharded_step
