"""Buffered-asynchronous federated engine on the sparse plane.

FedBuff-style server semantics for the paper's protocol: instead of a
barrier over a K-client cohort, the server absorbs per-client RowSparse
deltas as they arrive into a bounded buffer and fires one staleness-weighted
aggregate and apply every ``buffer_size`` arrivals. The run walks the event
stream an :class:`~repro_torch.federated.arrivals.ArrivalSim` compiled on
the host, in a Python loop over its numpy columns (the kind, slot and fire
flags are host values, so the loop branches without reading the device):

``DISPATCH`` event
    Run the client's local training against the server's current
    parameters and park the compressed delta in the event's in-flight slot,
    with its monitoring loss and telemetry scalars. Slots are bounded by the
    schedule's peak overlap, and their RowSparse leaves keep the sparse
    plane's ``(S, R, D)`` memory: no ``(V, D)`` tensor per client.
    Consecutive dispatches share one server version, so they train together
    as one cohort under ``vmap``, as the synchronous round does.
``ARRIVAL`` event
    Move the slot's delta into the aggregation buffer at position
    ``buf_count``, scaled by the staleness weight ``w(s)`` (constant, or
    ``1/(1+s)^a``); every ``buffer_size = M``-th arrival fires: the buffered
    stack goes through ``sparse_cohort_aggregate`` (the union kernel K1 on
    the card: cohort mean ``1/M`` and the FedSubAvg factor ``N/n_m`` in one
    pass over the non-zeros) and the stateless ``X += eta * update`` apply
    advances the server one version. Consecutive arrivals up to a fire move
    together.

Heat under asynchrony: ``heat="static"`` feeds the exact counts (the
synchronous contract); ``heat="ema"`` a streaming estimate, an exponential
moving average over per-arrival feature indicators, clamped into ``[1, N]``
as the randomized-response estimator is.

Degeneracy: a zero-delay schedule with ``buffer_size == clients_per_round``,
constant staleness weights and static heat replays the synchronous
``run_rounds``: each wave is K dispatches at one server version (one
``vmap`` over the cohort) then K arrivals whose buffer is the synchronous
cohort stack (the constant weight's multiply by 1.0 is skipped).

What does not compose, each rejected with its reason: ``CohortSharding``,
``DenseTransport``, int8 rows, stateful server algorithms, ``FedSgdLocal``
and ``debug_checks``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.profiler import record_function
from torch.func import vmap

from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import ServerState
from repro_torch.federated.arrivals import DISPATCH
from repro_torch.federated.client import (cohort_deltas, cohort_submodel_deltas,
                                          make_local_trainer,
                                          make_submodel_local_trainer)
from repro_torch.federated.plan import (FedSgdLocal, ReplicatedLocal, RoundPlan,
                                        SubmodelReplicatedLocal, _apply_plain,
                                        heat_spec_from_axes, sparse_table_paths)
from repro_torch.sparse.aggregate import sparse_cohort_aggregate
from repro_torch.sparse.compress import compress_delta_tree
from repro_torch.sparse.encode import encode_delta_tree, sparse_eligible
from repro_torch.sparse.rowsparse import PAD_ID, RowSparse, is_rowsparse
from repro_torch.telemetry.round import (HEAT_BUCKETS, STALENESS_BUCKETS,
                                         RoundTelemetry, drop_stats, heat_histogram,
                                         staleness_histogram, tree_agg_rows,
                                         tree_sq_per_client)

STALENESS_SCHEMES = ("constant", "polynomial")
HEAT_MODES = ("static", "ema")
#: stateless applies only: scaffold and fedadam state is defined per barrier
#: round and has no buffered-async analogue here
ASYNC_ALGORITHMS = ("fedavg", "fedprox", "fedsubavg")


def staleness_weight(staleness, scheme: str = "polynomial",
                     alpha: float = 0.5) -> torch.Tensor:
    """The staleness weight ``w(s)`` in float32.

    ``constant``: ``w(s) = 1`` (the buffer fire is the uniform ``1/M``
    mean). ``polynomial``: ``w(s) = 1 / (1 + s)^alpha``; ``w(0) = 1``, so
    the two schemes agree on a fresh buffer.
    """
    s = torch.as_tensor(staleness).to(torch.float32)
    if scheme == "constant":
        return torch.ones_like(s)
    if scheme == "polynomial":
        return (1.0 + s) ** (-float(alpha))
    raise ValueError(f"unknown staleness scheme {scheme!r}: expected one of "
                     f"{STALENESS_SCHEMES}")


@dataclass(frozen=True)
class BufferedAsyncServerUpdate:
    """The buffered-async server slot of a :class:`RoundPlan`.

    ``algorithm``: a stateless apply (fedavg, fedprox, fedsubavg); the
    FedSubAvg correction applies iff ``algorithm == "fedsubavg"``.
    ``buffer_size``: arrivals per server apply (FedBuff's M).
    ``staleness`` / ``staleness_alpha``: the weight ``w(s)`` of each
    buffered delta (:func:`staleness_weight`). ``heat`` / ``heat_beta``:
    the exact static counts, or the streaming EMA over arrival indicators
    (``p <- (1 - beta) p + beta * 1[feature in arrival]``, counts
    ``clip(N * p, 1, N)``).
    """

    algorithm: str = "fedsubavg"
    buffer_size: int = 8
    staleness: str = "constant"
    staleness_alpha: float = 0.5
    heat: str = "static"
    heat_beta: float = 0.05

    def __post_init__(self):
        if self.algorithm not in ASYNC_ALGORITHMS:
            raise ValueError(
                f"unknown/unsupported async server algorithm {self.algorithm!r}: "
                f"the buffered-async engine supports the stateless applies "
                f"{ASYNC_ALGORITHMS} (scaffold/fedadam server state is defined "
                "per barrier round)")
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.staleness not in STALENESS_SCHEMES:
            raise ValueError(f"unknown staleness scheme {self.staleness!r}: "
                             f"expected one of {STALENESS_SCHEMES}")
        if self.staleness_alpha < 0.0:
            raise ValueError(f"staleness_alpha must be >= 0, got {self.staleness_alpha}")
        if self.heat not in HEAT_MODES:
            raise ValueError(f"unknown heat mode {self.heat!r}: expected one of "
                             f"{HEAT_MODES}")
        if not 0.0 < self.heat_beta <= 1.0:
            raise ValueError(f"heat_beta out of (0, 1]: {self.heat_beta}")

    @property
    def correct(self) -> bool:
        return self.algorithm == "fedsubavg"

    @property
    def stateless(self) -> bool:
        return True


class AsyncState(NamedTuple):
    """Everything the event loop carries, and so everything a mid-run
    checkpoint needs: running ``events[:e]`` then ``events[e:]`` from a
    saved and restored state equals one uninterrupted run.

    ``slots``: the in-flight store (RowSparse leaves with ids ``(S, R)`` and
    rows ``(S, R, ...)``, dense leaves ``(S, ...)``); ``buffer``: the
    aggregation buffer, the same with leading ``M``, rows already
    staleness-weighted. The ``slot_*`` / ``buf_*`` vectors carry each
    delta's monitoring loss and telemetry stats (zeros with telemetry off).
    ``buf_count`` and ``arrivals`` are host integers (the schedule fixes
    them); ``heat_ema`` is the streaming heat ``p`` in [0, 1] per feature
    (``None`` under static heat).
    """

    server: ServerState
    slots: Dict[str, Any]
    slot_loss: torch.Tensor       # (S,) f32
    slot_pre_sq: torch.Tensor     # (S,) f32: squared L2 before compression
    slot_post_sq: torch.Tensor    # (S,) f32
    slot_drop: torch.Tensor       # (S,) i32: capacity-dropped distinct ids
    slot_mass: torch.Tensor       # (S,) f32
    buffer: Dict[str, Any]
    buf_loss: torch.Tensor        # (M,) f32
    buf_staleness: torch.Tensor   # (M,) i32
    buf_pre_sq: torch.Tensor      # (M,) f32
    buf_post_sq: torch.Tensor     # (M,) f32
    buf_drop: torch.Tensor        # (M,) i32
    buf_mass: torch.Tensor        # (M,) f32
    buf_count: int                # filled buffer positions
    heat_ema: Optional[torch.Tensor]  # (V,) f32 | None
    arrivals: int                 # total arrivals absorbed


class AsyncEngine(NamedTuple):
    """A built buffered-async engine: ``init`` builds the state, ``run``
    walks events, ``server`` echoes the plan's slot."""

    init: Callable
    run: Callable
    server: BufferedAsyncServerUpdate


def _group_end(kind: np.ndarray, fire: np.ndarray, e: int) -> int:
    """End of the event group starting at ``e``: a run of dispatches, or a
    run of arrivals that stops after a fire."""
    j, n = e + 1, kind.size
    if kind[e] == DISPATCH:
        while j < n and kind[j] == DISPATCH:
            j += 1
        return j
    while j < n and kind[j] != DISPATCH and not fire[j - 1]:
        j += 1
    return j


def build_async_engine(plan: RoundPlan, loss_fn: Callable, axes: Dict[str, Tuple],
                       params_template: Dict[str, torch.Tensor], cfg: FedConfig, *,
                       heat_counts: Optional[Dict[str, torch.Tensor]] = None,
                       total: Optional[float] = None,
                       telemetry: bool = False) -> AsyncEngine:
    """Build a buffered-async plan into its event-loop engine.

    ``plan.server`` must be a :class:`BufferedAsyncServerUpdate`; the local
    step and transport are the RoundPlan's (replicated locals on the
    RowSparse transport, optional top-k). ``heat_counts`` / ``total`` are
    the static heat, as ``build_round_step`` takes them; ``heat="ema"``
    starts from them.

    ``engine.run(state, events, tasks, sub_ids, feats=None)`` walks the
    event columns (``EventSchedule.event_arrays()``) over the stacked task
    data (leaves ``(T, I, B, ...)``) and the per-task sub-ids ``(T,
    capacity)``; ``feats``, the raw ``(T, M)`` feature ids, feeds the
    telemetry's drop counts only. It takes the state over (its stores are
    written in place, and a fire updates the table rows of
    ``state.server.params`` in place, as the synchronous step does) and
    returns ``(state, metrics)``: per-event ``loss`` (a tensor, the fire's
    buffered mean loss and 0 elsewhere), ``fired``, ``version`` and
    ``buf_fill`` (numpy) and, with ``telemetry``, a stacked
    :class:`RoundTelemetry` over the events (zeros on non-fire events)
    whose async fields are live.

    ``engine.init(server_state, num_slots=..., capacity=...)`` builds the
    :class:`AsyncState`; ``capacity`` is the sub-id capacity before top-k.
    """
    local, transport, server = plan.local, plan.transport, plan.server
    if not isinstance(server, BufferedAsyncServerUpdate):
        raise TypeError(
            f"build_async_engine needs a BufferedAsyncServerUpdate server slot, "
            f"got {type(server).__name__}: the synchronous ServerUpdate builds "
            "through build_round_step")
    if plan.sharding is not None:
        raise ValueError(
            "CohortSharding does not compose with the buffered-async engine: the "
            "event stream is inherently sequential (each arrival may advance the "
            "server before the next dispatch), so there is no cohort axis to shard")
    if not transport.sparse:
        raise ValueError(
            "the buffered-async engine runs the sparse plane only: the bounded "
            "in-flight slot store is O(R*D) per client because deltas stay "
            "RowSparse; use RowSparseTransport")
    if transport.int8:
        raise ValueError(
            "int8 transport does not compose with the buffered-async engine yet: "
            "the stochastic-rounding noise is keyed per synchronous round and has "
            "no per-event stream that would reproduce it")
    if isinstance(local, FedSgdLocal):
        raise ValueError(
            "FedSgdLocal pools the cohort into one fused gradient: there is no "
            "per-client delta to buffer; use ReplicatedLocal or "
            "SubmodelReplicatedLocal")
    if not isinstance(local, (ReplicatedLocal, SubmodelReplicatedLocal)):
        raise TypeError(f"unknown LocalStep: {local!r}")
    if plan.debug_checks:
        raise ValueError("debug_checks is not threaded through the async event "
                         "loop yet: build the plan with debug_checks=False")

    feature_keys = tuple(plan.feature_keys)
    heat_spec = heat_spec_from_axes(axes)
    paths = sparse_table_paths(heat_spec)
    table_paths = [p for p, _ in paths]
    if not table_paths:
        raise ValueError("the buffered-async engine needs at least one axis-0 "
                         "feature table (nothing rides the sparse plane otherwise)")
    vocabs = sorted({int(params_template[p].shape[0]) for p in table_paths})
    vocab = vocabs[-1]
    if isinstance(local, SubmodelReplicatedLocal) and len(vocabs) != 1:
        raise ValueError(f"submodel-replica feature tables disagree on vocab: {vocabs}")
    heat_space = paths[0][1][0]
    if server.heat == "ema":
        spaces = {s[0] for _, s in paths}
        if len(spaces) != 1 or len(vocabs) != 1:
            raise ValueError(
                "heat='ema' streams one indicator EMA over a single shared "
                f"feature-id space; found spaces {sorted(spaces)} over vocabs {vocabs}")
    if (server.correct or server.heat == "ema") and heat_counts is None:
        raise ValueError(
            "the FedSubAvg correction (and the EMA warm start) need baked "
            "heat_counts: pass heat_counts/total as build_round_step takes them")
    n_total = float(cfg.num_clients if total is None else total)
    eta = cfg.server_lr
    m_buf = int(server.buffer_size)
    beta = float(server.heat_beta)
    # the constant weight multiplies by exactly 1.0: skipping it keeps the
    # zero-delay buffer the synchronous cohort stack
    weighted = server.staleness != "constant"

    # ---- a cohort of dispatches: deltas and monitoring losses -------------
    if isinstance(local, SubmodelReplicatedLocal):
        submodel_train = make_submodel_local_trainer(
            loss_fn, cfg, table_paths, feature_keys, prox_mu=local.prox_mu)

        def train(params, data, ids):
            return cohort_submodel_deltas(submodel_train, params, data, ids)
    else:
        dense_train = make_local_trainer(loss_fn, cfg, prox_mu=local.prox_mu)

        def train(params, data, ids):
            return encode_delta_tree(cohort_deltas(dense_train, params, data),
                                     heat_spec, ids)

    def cohort_deltas_and_losses(params, data, ids):
        deltas = train(params, data, ids)
        first = {k: v[:, 0] for k, v in data.items()}
        return deltas, vmap(lambda b: loss_fn(params, b))(first)

    # ---- bounded stores ---------------------------------------------------
    def store_template(n: int, cap: int, device) -> Dict[str, Any]:
        out = {}
        for name, p in params_template.items():
            if sparse_eligible(heat_spec.leaf_spaces.get(name)):
                out[name] = RowSparse(
                    torch.full((n, cap), PAD_ID, dtype=torch.int32, device=device),
                    torch.zeros((n, cap) + tuple(p.shape[1:]), dtype=p.dtype,
                                device=device), int(p.shape[0]))
            else:
                out[name] = torch.zeros((n,) + tuple(p.shape), dtype=p.dtype,
                                        device=device)
        return out

    def store(dst: Dict, at, tree: Dict) -> None:
        for name, leaf in tree.items():
            d = dst[name]
            if is_rowsparse(d):
                d.ids[at] = leaf.ids.to(torch.int32)
                d.rows[at] = leaf.rows.to(d.rows.dtype)
            else:
                d[at] = leaf.to(d.dtype)

    def load(src: Dict, at) -> Dict:
        return {name: RowSparse(s.ids[at], s.rows[at], s.num_rows) if is_rowsparse(s)
                else s[at] for name, s in src.items()}

    def wscale(tree: Dict, w: torch.Tensor) -> Dict:
        def f(leaf):
            x = leaf.rows if is_rowsparse(leaf) else leaf
            y = x * w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            return RowSparse(leaf.ids, y, leaf.num_rows) if is_rowsparse(leaf) else y

        return {name: f(leaf) for name, leaf in tree.items()}

    # ---- streaming heat ---------------------------------------------------
    def ema_update(p: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        safe = torch.where(ids >= 0, ids, vocab).long()
        ind = torch.zeros(vocab + 1, dtype=torch.float32, device=p.device)
        ind[safe] = 1.0
        return (1.0 - beta) * p + beta * ind[:vocab]

    def fire_counts(heat_ema) -> Dict:
        if server.heat == "ema":
            # into [1, N], as clamp_heat_estimate: an EMA decaying a hot
            # feature toward 0 must not zero its row at the h > 0 gate
            return {heat_space: torch.clamp(heat_ema * n_total, 1.0, n_total)}
        return heat_counts if heat_counts is not None else {}

    # ---- telemetry ----------------------------------------------------------
    def tel_zero(device) -> RoundTelemetry:
        zi = torch.zeros((), dtype=torch.int32, device=device)
        zf = torch.zeros((), dtype=torch.float32, device=device)
        return RoundTelemetry(
            dropped_ids=zi, dropped_mass=zf,
            dropped_per_client=torch.zeros(m_buf, dtype=torch.int32, device=device),
            union_size=zi, agg_rows=zi, shard_union_sizes=None, delta_norm_pre=zf,
            delta_norm_post=zf,
            heat_hist=torch.zeros(HEAT_BUCKETS, dtype=torch.float32, device=device),
            density=zf,
            staleness_hist=torch.zeros(STALENESS_BUCKETS, dtype=torch.float32,
                                       device=device),
            buffer_occupancy=zi)

    def tel_fire(st: AsyncState, agg: Dict, counts: Dict, inflight: int) -> RoundTelemetry:
        union = next(agg[k].ids for k in sorted(agg) if is_rowsparse(agg[k]))
        union_size = (union >= 0).sum(dtype=torch.int32)
        hv = counts.get(heat_space) if counts else None
        hist = (heat_histogram(hv, union) if hv is not None
                else torch.zeros(HEAT_BUCKETS, dtype=torch.float32, device=union.device))
        return RoundTelemetry(
            dropped_ids=st.buf_drop.sum(dtype=torch.int32),
            dropped_mass=st.buf_mass.sum(),
            dropped_per_client=st.buf_drop.clone(),
            union_size=union_size, agg_rows=tree_agg_rows(agg),
            shard_union_sizes=None,
            delta_norm_pre=torch.sqrt(st.buf_pre_sq.sum()),
            delta_norm_post=torch.sqrt(st.buf_post_sq.sum()),
            heat_hist=hist, density=union_size.to(torch.float32) / vocab,
            staleness_hist=staleness_histogram(st.buf_staleness),
            buffer_occupancy=torch.tensor(int(inflight), dtype=torch.int32,
                                          device=union.device))

    # ---- init -------------------------------------------------------------
    def init(server_state: ServerState, *, num_slots: int, capacity: int,
             heat_ema=None) -> AsyncState:
        device = next(iter(server_state.params.values())).device
        slot_cap = (min(int(transport.topk), int(capacity)) if transport.topk
                    else int(capacity))
        p = None
        if server.heat == "ema":
            if heat_ema is not None:
                p = torch.as_tensor(heat_ema, dtype=torch.float32).to(device)
            else:
                p = torch.clamp(heat_counts[heat_space].to(device, torch.float32)
                                / n_total, 0.0, 1.0)
        s, m = int(num_slots), m_buf

        def f32(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        def i32(n):
            return torch.zeros(n, dtype=torch.int32, device=device)

        return AsyncState(
            server=ServerState(server_state.params, server_state.opt,
                               int(server_state.rounds)),
            slots=store_template(s, slot_cap, device), slot_loss=f32(s),
            slot_pre_sq=f32(s), slot_post_sq=f32(s), slot_drop=i32(s), slot_mass=f32(s),
            buffer=store_template(m, slot_cap, device), buf_loss=f32(m),
            buf_staleness=i32(m), buf_pre_sq=f32(m), buf_post_sq=f32(m),
            buf_drop=i32(m), buf_mass=f32(m), buf_count=0, heat_ema=p, arrivals=0)

    # ---- the event loop ---------------------------------------------------
    def run(state: AsyncState, events: Dict[str, np.ndarray], tasks: Dict,
            sub_ids: torch.Tensor, feats: Optional[torch.Tensor] = None):
        kind = np.asarray(events["kind"])
        task = np.asarray(events["task"], np.int64)
        slot = np.asarray(events["slot"], np.int64)
        stale = np.asarray(events["staleness"], np.int64)
        fire = np.asarray(events["fire"], bool)
        inflight = np.asarray(events["inflight"])
        n_events = int(kind.size)
        device = sub_ids.device
        st = state
        version = np.zeros(n_events, np.int64)
        buf_fill = np.zeros(n_events, np.int64)
        fires: List[Tuple[int, torch.Tensor, Optional[RoundTelemetry]]] = []

        def on_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def dispatch(st: AsyncState, e: int, j: int, tix, ids) -> None:
            six = on_device(slot[e:j])
            data = {k: v[tix] for k, v in tasks.items()}
            deltas, losses = cohort_deltas_and_losses(st.server.params, data, ids)
            sent = (compress_delta_tree(deltas, topk=transport.topk)
                    if transport.topk else deltas)
            store(st.slots, six, sent)
            st.slot_loss[six] = losses.to(torch.float32)
            if telemetry:
                st.slot_pre_sq[six] = tree_sq_per_client(deltas, j - e)
                st.slot_post_sq[six] = tree_sq_per_client(sent, j - e)
                if feats is not None:
                    dropped, mass = drop_stats(feats[tix], ids, vocab)
                    st.slot_drop[six] = dropped
                    st.slot_mass[six] = mass

        def arrive(st: AsyncState, e: int, j: int, ids) -> AsyncState:
            six = on_device(slot[e:j])
            d = load(st.slots, six)
            if weighted:
                d = wscale(d, staleness_weight(on_device(stale[e:j]), server.staleness,
                                               server.staleness_alpha))
            at = slice(st.buf_count, st.buf_count + (j - e))
            store(st.buffer, at, d)
            st.buf_loss[at] = st.slot_loss[six]
            st.buf_staleness[at] = on_device(stale[e:j]).to(torch.int32)
            if telemetry:
                st.buf_pre_sq[at] = st.slot_pre_sq[six]
                st.buf_post_sq[at] = st.slot_post_sq[six]
                st.buf_drop[at] = st.slot_drop[six]
                st.buf_mass[at] = st.slot_mass[six]
            heat_ema = st.heat_ema
            if server.heat == "ema":
                for r in range(j - e):
                    heat_ema = ema_update(heat_ema, ids[r])
            return st._replace(buf_count=st.buf_count + (j - e),
                               arrivals=st.arrivals + (j - e), heat_ema=heat_ema)

        def fire_buffer(st: AsyncState, e: int):
            counts = fire_counts(st.heat_ema)
            agg = sparse_cohort_aggregate(
                st.buffer, heat_spec, counts, n_total, m_buf,
                correct=server.correct, union_backend=transport.union_backend)
            loss = st.buf_loss.mean()
            # read before the apply writes the tables in place
            tel = tel_fire(st, agg, counts, inflight[e]) if telemetry else None
            srv = st.server
            st = st._replace(server=ServerState(_apply_plain(srv.params, agg, eta),
                                                srv.opt, srv.rounds + 1), buf_count=0)
            return st, (e, loss, tel)

        e = 0
        while e < n_events:
            j = _group_end(kind, fire, e)
            tix = on_device(task[e:j])
            ids = sub_ids[tix]
            if kind[e] == DISPATCH:
                with record_function("async_engine.dispatch"):
                    dispatch(st, e, j, tix, ids)
                buf_fill[e:j] = st.buf_count
            else:
                start = st.buf_count
                with record_function("async_engine.arrive"):
                    st = arrive(st, e, j, ids)
                buf_fill[e:j] = np.arange(start + 1, st.buf_count + 1)
            version[e:j] = st.server.rounds
            if fire[j - 1]:
                with record_function("async_engine.fire"):
                    st, fired = fire_buffer(st, j - 1)
                fires.append(fired)
                buf_fill[j - 1] = 0
                version[j - 1] = st.server.rounds
            e = j

        fired_at = on_device(np.asarray([f[0] for f in fires], np.int64))
        loss = torch.zeros(n_events, dtype=torch.float32, device=device)
        if fires:
            loss[fired_at] = torch.stack([f[1] for f in fires])
        metrics = {"loss": loss, "fired": fire.copy(), "version": version,
                   "buf_fill": buf_fill}
        if telemetry:
            cols = []
            for i, zero in enumerate(tel_zero(device)):
                if zero is None:
                    cols.append(None)
                    continue
                col = zero.expand((n_events,) + tuple(zero.shape)).clone()
                if fires:
                    col[fired_at] = torch.stack([f[2][i] for f in fires])
                cols.append(col)
            metrics["telemetry"] = RoundTelemetry(*cols)
        return st, metrics

    return AsyncEngine(init=init, run=run, server=server)
