"""Server orchestration of federated rounds (Algorithm 1, server process).

``FederatedTrainer`` runs the paper's protocol over a ``FederatedDataset``:
each round it samples K clients with a numpy generator, runs the plan's
round step and, on the sparse plan, derives the clients' submodel ids on
the device and prices the round's bytes. The numpy stream is consumed in the
same order as the JAX package's trainer, so the same seed draws the same
cohorts. CentralSGD (the paper's non-federated reference) shares the
interface: ``algorithm="central"`` takes I plain SGD steps per round on
pooled batches of ``local_batch * K`` samples.

Ported: every server algorithm, on the sparse plan (``FedConfig(sparse=
True)``, K1 ``union_segsum`` once per round, with submodel replicas or with
K dense replicas, ``sparse_local="replicated"``, optionally top-k and int8
rows) and the dense one (``sparse=False``, K dense replicas), for the
paper's three models (LR, LSTM and DIN, whose targets are feature ids
beside its histories), with heat exact, by secure aggregation or by
randomized response, optionally weighted by the clients' sample counts.
Each round records its :class:`~repro_torch.telemetry.round.RoundTelemetry`
(``telemetry=True``, the default) in ``telemetry_log`` and on a
:class:`~repro_torch.telemetry.sink.TraceSink`; ``run`` splits first
dispatches from steady ones and can profile itself (``profile_dir``); and
``run_async`` drives the buffered-async engine over an ``ArrivalSim``
schedule, K1 serving each buffer fire. ``mesh=`` (a
:class:`~repro_torch.launch.mesh.CohortMesh`) shards every round's cohort
over the mesh's ranks: each rank runs this same trainer, samples the same
cohorts and trains its own block of clients.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch import resolve_device
from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import ServerState, make_server_algorithm
from repro_torch.core.heat import (HeatStats, clamp_heat_estimate,
                                   estimate_heat_randomized_response)
from repro_torch.data.batching import pooled_batches, sample_cohort_batch
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.federated.arrivals import ArrivalSim
from repro_torch.federated.async_engine import (BufferedAsyncServerUpdate,
                                                build_async_engine)
from repro_torch.federated.metrics import (accuracy, auc, comm_summary,
                                           telemetry_summary)
from repro_torch.federated.plan import (CohortSharding, RoundPlan,
                                        SubmodelReplicatedLocal, build_round_step,
                                        heat_spec_from_axes, plan_from_config,
                                        sparse_table_paths)
from repro_torch.sparse.comm import CommStats, model_comm_meta
from repro_torch.sparse.rowsparse import count_unique_ids, unique_ids_padded
from repro_torch.telemetry import PhaseTimer, TraceSink
from repro_torch.telemetry.round import (RoundTelemetry, split_rounds,
                                         stack_rounds, telemetry_to_host)


@dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_metric: float
    bytes_up: float = 0.0            # cumulative sparse-plane uplink bytes
    bytes_down: float = 0.0          # cumulative sparse-plane downlink bytes
    density: float = 1.0             # mean per-client submodel density so far
    wall_time: float = 0.0           # steady mean seconds per round since the
                                     # last record (first dispatches excluded,
                                     # unless every dispatch was a first)
    compile_time: float = 0.0        # seconds of first dispatches since the
                                     # last record (0 once every key was seen)


# ---------------------------------------------------------------------------
# sub-id derivation (the server's cohort preprocessing, on the device)
# ---------------------------------------------------------------------------


def pow2_capacity(max_count: int, floor: int = 8) -> int:
    """Smallest power of two >= max(max_count, floor): sub-id capacities are
    bucketed so a run sees O(log V) distinct shapes."""
    cap = floor
    while cap < max_count:
        cap *= 2
    return cap


def _valid_ids(flat: torch.Tensor, num_features: int) -> torch.Tensor:
    """Ids outside ``[0, num_features)`` become -1 (the padding convention)."""
    flat = flat.to(torch.int32)
    return torch.where((flat >= 0) & (flat < num_features), flat, -1)


def count_sub_ids(feats: torch.Tensor, num_features: int) -> torch.Tensor:
    """Per-client distinct valid feature counts ``(K,)`` from ``(K, M)`` ids."""
    return count_unique_ids(_valid_ids(feats, num_features))


def derive_sub_ids(feats: torch.Tensor, num_features: int,
                   capacity: int) -> torch.Tensor:
    """Per-client sorted unique valid feature ids ``(K, capacity)``, -1 padded."""
    return unique_ids_padded(_valid_ids(feats, num_features), capacity)


class AsyncRun(NamedTuple):
    """One buffered-async run's inputs (``FederatedTrainer.prepare_async``)."""

    engine: Any                 # AsyncEngine
    schedule: Any               # EventSchedule
    state: Any                  # the initial AsyncState
    tasks: Dict[str, torch.Tensor]
    sub_ids: torch.Tensor       # (T, capacity)
    feats: Optional[torch.Tensor]   # (T, M) raw feature ids, telemetry only
    valid_counts: np.ndarray    # (T,) distinct valid ids per task
    capacity: int


class FederatedTrainer:
    """End-to-end federated training loop for the paper-scale models.

    ``make_params(device=...)`` returns ``(params, axes)``; ``loss_fn(params,
    batch)`` and ``predict_fn(params, test_data)`` take dicts of tensors on
    the trainer's device (the test split is moved there once).
    ``device=None`` means ``"cuda"`` and raises without a card.

    ``telemetry``: compute each round's :class:`RoundTelemetry` (pure reads:
    losses, parameters and the numpy stream are the same bit for bit
    either way) and collect it in ``telemetry_log``. ``sink``: a
    :class:`TraceSink` receiving the round and record events and the
    verbose reporting; an in-memory one when omitted, ``TraceSink(path)``
    to persist JSONL.

    ``mesh``: a :class:`~repro_torch.launch.mesh.CohortMesh` (e.g.
    ``make_cohort_mesh()`` under ``torchrun``) to shard every round's
    cohort over its ranks (``device`` then defaults to the mesh's). Every
    rank runs the same trainer: the host pipeline is untouched, each rank
    samples the full cohort from the same numpy stream and the step trains
    the rank's shard-major block, so sharded rounds reproduce unsharded
    ones to 1e-5. Pass a plan with an explicit ``CohortSharding`` for
    another axis or combine. On a mesh only rank 0 writes files
    (``writes_files``): the other ranks close the sink's file and keep its
    events in memory, and ``run(profile_dir=...)`` profiles rank 0 alone;
    save checkpoints where ``writes_files`` holds. The buffered-async
    engine does not run on a mesh.
    """

    def __init__(self, ds: FederatedDataset, make_params: Callable,
                 loss_fn: Callable, cfg: FedConfig,
                 predict_fn: Optional[Callable] = None,
                 metric: str = "auc", rng_seed: int = 0,
                 plan: Optional[RoundPlan] = None, device=None,
                 telemetry: bool = True, sink: Optional[TraceSink] = None,
                 mesh=None):
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.ds = ds
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.predict_fn = predict_fn
        self.metric = metric
        self.np_rng = np.random.default_rng(cfg.seed + rng_seed)

        params, axes = make_params(device=self.device)
        self._axes = axes
        self.heat = self._resolve_heat(ds, cfg)
        self._heat_spec = heat_spec_from_axes(axes)
        heat_counts = {"vocab": torch.as_tensor(self.heat.counts, dtype=torch.float32,
                                                device=self.device)}
        self._heat_counts = heat_counts
        self.alg = make_server_algorithm(cfg, heat_spec=self._heat_spec,
                                         heat_counts=heat_counts,
                                         total=self.heat.total)
        self.state = self.alg.init(params)
        self.history: List[RoundRecord] = []
        self.comm_log: List[CommStats] = []
        self._rounds_run = 0
        self._last_capacity: Optional[int] = None
        self._test_data = self._to_device(ds.test_data)
        self.plan: Optional[RoundPlan] = None
        self._is_sparse = False
        self.telemetry_enabled = bool(telemetry)
        self.sink = sink if sink is not None else TraceSink()
        self.timer = PhaseTimer()
        self.telemetry_log: List[Dict[str, Any]] = []
        self._dispatched_keys: set = set()
        self._last_dispatch_first = False
        # buffered-async engines by (server slot, telemetry); the streaming
        # heat's EMA persists across run_async calls
        self._async_engines: Dict[Any, Any] = {}
        self._async_heat_ema: Optional[torch.Tensor] = None

        self.writes_files = mesh is None or mesh.rank == 0
        if cfg.algorithm == "central":
            if plan is not None:
                raise ValueError("central training takes no RoundPlan")
            if mesh is not None:
                raise ValueError("central training takes no cohort mesh")
            self._central_step = self._make_central_step()
            return

        self.plan = self._resolve_trainer_plan(params, plan)
        if mesh is not None:
            if self.plan.sharding is not None and self.plan.sharding.mesh is not mesh:
                raise ValueError("mesh= conflicts with the explicit plan's "
                                 "CohortSharding: set the mesh on the plan only")
            if self.plan.sharding is None:
                self.plan = dataclasses.replace(self.plan, sharding=CohortSharding(mesh))
        if self.plan.sharding is not None:
            self.writes_files = self.plan.sharding.mesh.rank == 0
        if not self.writes_files:
            self.sink.close()
        self._is_sparse = self.plan.transport.sparse
        self._step = build_round_step(self.plan, loss_fn, axes, params, cfg,
                                      heat_counts=heat_counts,
                                      total=self.heat.total, server_alg=self.alg,
                                      telemetry=self.telemetry_enabled)
        self._comm_meta = model_comm_meta(params, set(self._sparse_paths))

    # ------------------------------------------------------------------
    def _resolve_trainer_plan(self, params, plan: Optional[RoundPlan]) -> RoundPlan:
        """Resolve FedConfig flags (or validate an explicit plan): which
        leaves ride the sparse plane, whether submodel replicas can be
        gathered, and which batch leaves carry feature ids (DIN's targets
        beside its histories)."""
        keys = (self.ds.feature_key,)
        if self.ds.feature_key == "hist" and "target" in self.ds.client_data:
            keys += ("target",)
        self._feature_batch_keys = keys
        self._sparse_paths = [p for p, _ in sparse_table_paths(self._heat_spec)]
        table_rows = [int(params[p].shape[0]) for p in self._sparse_paths]
        gatherable = (bool(self._sparse_paths)
                      and all(r == self.ds.num_features for r in table_rows))
        if plan is None:
            plan = plan_from_config(self.cfg, feature_keys=keys,
                                    gatherable=gatherable)
        else:
            if plan.server.algorithm != self.cfg.algorithm:
                raise ValueError(
                    f"plan.server.algorithm={plan.server.algorithm!r} "
                    f"disagrees with cfg.algorithm={self.cfg.algorithm!r}: "
                    "the trainer's server state is built from the config")
            if not plan.local.stacked:
                raise ValueError(
                    f"{type(plan.local).__name__} consumes a flat pooled "
                    "batch, but FederatedTrainer samples stacked cohorts")
            plan = dataclasses.replace(plan, feature_keys=keys)
        if isinstance(plan.local, SubmodelReplicatedLocal) and not gatherable:
            raise ValueError(
                "SubmodelReplicatedLocal needs axis-0 feature tables of "
                f"{self.ds.num_features} rows; found {table_rows}")
        return plan

    @staticmethod
    def _resolve_heat(ds: FederatedDataset, cfg: FedConfig) -> HeatStats:
        """Heat under the configured estimator (App. F) and, when
        ``weighted``, the App. D.4 weights (the clients' sample counts),
        composed with it: weighted randomized response weights the noisy
        reported bits; exact and secure aggregation (exact by construction,
        so its counts are the exact ones) sum the involving clients'
        weights. The randomized-response draw is ``default_rng(cfg.seed)``,
        a generator apart from the trainer's cohort stream."""
        key = ds.feature_key

        def client_ids(c):
            ids = ds.client_data[key][c].reshape(-1)
            ids = ids[ids >= 0]
            if key == "hist" and "target" in ds.client_data:
                t = ds.client_data["target"][c].reshape(-1)
                ids = np.concatenate([ids, t[t >= 0]])
            return np.unique(ids)

        w = ds.sample_counts.astype(np.float64) if cfg.weighted else None
        if cfg.heat_estimator == "randomized_response":
            ind = np.zeros((ds.num_clients, ds.num_features), bool)
            for c in range(ds.num_clients):
                ind[c, client_ids(c)] = True
            est = estimate_heat_randomized_response(
                ind, cfg.rr_flip_prob, np.random.default_rng(cfg.seed), weights=w)
            total = float(ds.num_clients) if w is None else float(w.sum())
            # into [1, total], not [0, total]: an estimate <= 0 would zero a
            # hot row's update at the correction's counts > 0 gate
            counts = clamp_heat_estimate(est, total)
        elif cfg.weighted:
            counts = np.zeros(ds.num_features)
            for c in range(ds.num_clients):
                counts[client_ids(c)] += w[c]
            total = float(w.sum())
        else:
            counts, total = ds.heat.counts, ds.heat.total
        return HeatStats(counts=np.asarray(counts, np.float64), total=float(total),
                         name="vocab")

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _sample_sparse_cohort(self):
        """One round's host work: sample the cohort and concatenate every
        feature-carrying leaf into its ``(K, M)`` feature ids."""
        cfg = self.cfg
        ids = self.np_rng.choice(self.ds.num_clients, size=cfg.clients_per_round,
                                 replace=False)
        cohort = sample_cohort_batch(self.ds, ids, cfg.local_iters,
                                     cfg.local_batch, self.np_rng)
        feats = np.concatenate([np.asarray(cohort[k]).reshape(len(ids), -1)
                                for k in self._feature_batch_keys], axis=1)
        return cohort, feats

    def _log_sparse_comm(self, valid_counts: np.ndarray, capacity: int):
        self.comm_log.append(self.plan.transport.round_comm(
            self._rounds_run, self._comm_meta, valid_counts,
            self.ds.num_features, capacity=capacity,
            submodel_downlink=isinstance(self.plan.local, SubmodelReplicatedLocal),
            local_iters=self.cfg.local_iters))

    def _mark_dispatch(self, key) -> None:
        """Record whether the next dispatch is the first of its kind.

        ``key`` names the shape of the work about to run: ``("step", cap)``,
        ``("engine", n, cap)``, ``("dense",)``, ``("central",)``,
        ``("async", ...)``. The first dispatch of a key pays one-time costs
        (the kernels' first load, the caching allocator's first growth), so
        ``run()`` books its time as ``compile_time``, apart from the steady
        rounds.
        """
        self._last_dispatch_first = key not in self._dispatched_keys
        self._dispatched_keys.add(key)

    def _record_telemetry(self, tel, rnd: int, comm: Optional[CommStats] = None) -> None:
        """Append one round's telemetry to ``telemetry_log`` and the sink,
        with the round's bytes under ``"comm"`` (their ``round`` and
        ``density`` keys would collide with telemetry fields at the top
        level). ``tel``: a :class:`RoundTelemetry` or its host dict."""
        if tel is None:
            return
        if isinstance(tel, RoundTelemetry):
            tel = telemetry_to_host(tel)
        event = {"event": "round", "round": int(rnd), **tel}
        if comm is not None:
            event["comm"] = comm.as_dict()
        self.telemetry_log.append(event)
        self.sink.emit(event)

    def _run_sparse_round(self) -> float:
        cohort, feats = self._sample_sparse_cohort()
        feats = torch.from_numpy(feats).to(self.device)
        valid_counts = count_sub_ids(feats, self.ds.num_features).cpu().numpy()
        capacity = pow2_capacity(int(valid_counts.max()))
        sub_ids = derive_sub_ids(feats, self.ds.num_features, capacity)
        self._mark_dispatch(("step", capacity))
        self.state, metrics = self._step(self.state, self._to_device(cohort),
                                         sub_ids)
        self._last_capacity = capacity
        self._log_sparse_comm(valid_counts, capacity)
        self._record_telemetry(metrics.get("telemetry"), self._rounds_run,
                               comm=self.comm_log[-1])
        return float(metrics["loss"])

    def _run_dense_round(self) -> float:
        cohort, feats = self._sample_sparse_cohort()
        sub_ids = None
        if isinstance(self.plan.local, SubmodelReplicatedLocal):
            feats = torch.from_numpy(feats).to(self.device)
            capacity = pow2_capacity(
                int(count_sub_ids(feats, self.ds.num_features).max()))
            sub_ids = derive_sub_ids(feats, self.ds.num_features, capacity)
        self._mark_dispatch(("dense",))
        self.state, metrics = self._step(self.state, self._to_device(cohort), sub_ids)
        self._record_telemetry(metrics.get("telemetry"), self._rounds_run)
        return float(metrics["loss"])

    def _make_central_step(self) -> Callable:
        """``(state, batches) -> (state, mean loss)``: one plain SGD step at
        ``cfg.lr`` per pooled batch (leaves ``(I, B, ...)``)."""
        g_fn = grad_and_value(self.loss_fn)
        lr = self.cfg.lr

        def central_step(state: ServerState, batches):
            p, losses = state.params, []
            for i in range(next(iter(batches.values())).shape[0]):
                g, loss = g_fn(p, {k: v[i] for k, v in batches.items()})
                p = {k: p[k] + g[k] * (-lr) for k in p}
                losses.append(loss)
            return ServerState(p, state.opt, state.rounds + 1), torch.stack(losses).mean()

        return central_step

    def run_round(self) -> float:
        cfg = self.cfg
        self._rounds_run += 1
        if cfg.algorithm == "central":
            batches = pooled_batches(self.ds, cfg.local_iters,
                                     cfg.local_batch * cfg.clients_per_round,
                                     self.np_rng)
            self._mark_dispatch(("central",))
            self.state, loss = self._central_step(self.state, self._to_device(batches))
            return float(loss)
        if self._is_sparse:
            return self._run_sparse_round()
        return self._run_dense_round()

    def _sample_waves(self, n: int):
        """``n`` cohorts from ``np_rng`` (the stream of ``n`` ``run_round``
        calls), their feature ids on the device, each client's distinct
        valid id count, and the pow2 sub-id capacity they share."""
        cohorts, feats = [], []
        for _ in range(n):
            c, f = self._sample_sparse_cohort()
            cohorts.append(c)
            feats.append(f)
        flat = torch.from_numpy(np.concatenate(feats)).to(self.device)
        valid_counts = count_sub_ids(flat, self.ds.num_features).cpu().numpy()
        return cohorts, flat, valid_counts, pow2_capacity(int(valid_counts.max()))

    def run_rounds(self, n: int) -> List[float]:
        """``n`` rounds with the JAX engine's semantics: all ``n`` cohorts are
        sampled up front (the same numpy stream as ``n`` ``run_round``
        calls) and share one pow2 sub-id capacity. The telemetry of the
        ``n`` rounds is read back after the last. Central and dense
        configurations run ``n`` ``run_round`` calls. Returns the per-round
        losses."""
        if n <= 0:
            return []
        if not self._is_sparse:
            return [self.run_round() for _ in range(n)]
        k = self.cfg.clients_per_round
        cohorts, flat, valid_counts, capacity = self._sample_waves(n)
        valid_counts = valid_counts.reshape(n, k)
        sub_ids = derive_sub_ids(flat, self.ds.num_features,
                                 capacity).reshape(n, k, capacity)
        self._mark_dispatch(("engine", n, capacity))
        losses, tels = [], []
        for r in range(n):
            self.state, metrics = self._step(
                self.state, self._to_device(cohorts[r]), sub_ids[r])
            losses.append(metrics["loss"])
            tels.append(metrics.get("telemetry"))
        self._last_capacity = capacity
        if self.telemetry_enabled:
            tels = split_rounds(stack_rounds(tels), n)
        for r in range(n):
            self._rounds_run += 1
            self._log_sparse_comm(valid_counts[r], capacity)
            self._record_telemetry(tels[r], self._rounds_run, comm=self.comm_log[-1])
        return torch.stack(losses).tolist()

    def run_async(self, sim: ArrivalSim,
                  server: Optional[BufferedAsyncServerUpdate] = None) -> List[float]:
        """Drive a buffered-async run over ``sim``'s event stream.

        The trainer samples ``sim.num_rounds`` waves of K clients from the
        same ``np_rng`` stream, in the same order, as
        ``run_rounds(sim.num_rounds)``, stacks them as per-task data and
        walks the :mod:`~repro_torch.federated.async_engine` event loop over
        the schedule. ``server`` overrides the async server slot; by default
        the plan's algorithm runs with ``buffer_size = K``, which on a
        zero-delay schedule reproduces ``run_rounds``.

        Each buffer fire is one server version: one round number, one comm
        entry (priced over the M arrivals it aggregated) and one telemetry
        event, like a synchronous round. Returns the per-fire buffered
        monitoring losses (arrivals that never complete a buffer are
        absorbed but not applied).
        """
        run = self.prepare_async(sim, server)
        srv, sch, capacity = run.engine.server, run.schedule, run.capacity
        self._mark_dispatch(("async", srv, sch.num_events, capacity, sch.num_slots))
        state, ys = run.engine.run(run.state, sch.event_arrays(), run.tasks, run.sub_ids,
                                   run.feats)
        self.state = state.server
        if srv.heat == "ema":
            self._async_heat_ema = state.heat_ema
        self._last_capacity = capacity

        fired = np.flatnonzero(sch.fire)
        at = torch.from_numpy(fired).to(self.device)
        losses = ys["loss"][at].tolist()
        tels = [None] * len(fired)
        if "telemetry" in ys:
            tels = split_rounds(RoundTelemetry(*[
                None if v is None else v[at] for v in ys["telemetry"]]), len(fired))
        m = srv.buffer_size
        for f in range(sch.num_fires):
            self._rounds_run += 1
            self._log_sparse_comm(run.valid_counts[sch.arrival_tasks[f * m:(f + 1) * m]],
                                  capacity)
            self._record_telemetry(tels[f], self._rounds_run, comm=self.comm_log[-1])
        return losses

    def prepare_async(self, sim: ArrivalSim,
                      server: Optional[BufferedAsyncServerUpdate] = None) -> AsyncRun:
        """Everything ``run_async`` hands the engine, without running it:
        the engine for ``server`` (built once per slot and telemetry flag),
        the compiled schedule, ``sim.num_rounds`` waves sampled from
        ``np_rng`` as task data and sub-ids on the device, and the initial
        :class:`AsyncState` over the trainer's state. A caller may run the
        events in parts (``EventSchedule.slice_events``) and checkpoint the
        state between them."""
        if self.plan is None or not self._is_sparse:
            raise ValueError("run_async needs a sparse federated plan "
                             "(RowSparseTransport)")
        if self.plan.sharding is not None:
            raise ValueError(
                "run_async does not compose with CohortSharding: the event stream "
                "is inherently sequential; run the synchronous engine on the mesh")
        cfg = self.cfg
        srv = server if server is not None else BufferedAsyncServerUpdate(
            algorithm=self.plan.server.algorithm, buffer_size=cfg.clients_per_round)
        key = (srv, self.telemetry_enabled)
        if key not in self._async_engines:
            self._async_engines[key] = build_async_engine(
                dataclasses.replace(self.plan, server=srv), self.loss_fn, self._axes,
                self.state.params, cfg, heat_counts=self._heat_counts,
                total=self.heat.total, telemetry=self.telemetry_enabled)
        eng = self._async_engines[key]
        sch = sim.compile(cfg.clients_per_round, srv.buffer_size)
        cohorts, flat, valid_counts, capacity = self._sample_waves(sim.num_rounds)
        tasks = self._to_device({k: np.concatenate([c[k] for c in cohorts])
                                 for k in cohorts[0]})
        state = eng.init(self.state, num_slots=sch.num_slots, capacity=capacity,
                         heat_ema=self._async_heat_ema if srv.heat == "ema" else None)
        return AsyncRun(eng, sch, state, tasks,
                        derive_sub_ids(flat, self.ds.num_features, capacity),
                        flat if self.telemetry_enabled else None, valid_counts, capacity)

    def evaluate(self) -> float:
        if self.predict_fn is None:
            return float("nan")
        with torch.no_grad():
            scores = self.predict_fn(self.state.params, self._test_data)
        scores = scores.cpu().numpy()
        labels = self.ds.test_data["label"]
        return auc(labels, scores) if self.metric == "auc" else accuracy(labels, scores)

    def train_loss(self, num_batches: int = 8, batch: int = 256) -> float:
        """Loss over a fixed random sample of the pooled training set."""
        rng = np.random.default_rng(123)
        batches = pooled_batches(self.ds, num_batches, batch, rng)
        tot = 0.0
        with torch.no_grad():
            for i in range(num_batches):
                b = self._to_device({k: v[i] for k, v in batches.items()})
                tot += float(self.loss_fn(self.state.params, b))
        return tot / num_batches

    def comm_summary(self) -> Dict[str, float]:
        """Aggregate comm accounting over all rounds so far."""
        return comm_summary(self.comm_log)

    def telemetry_summary(self) -> Dict[str, Any]:
        """Aggregate the per-round telemetry events collected so far."""
        return telemetry_summary(self.telemetry_log)

    def run(self, rounds: int, eval_every: int = 10, verbose: bool = False,
            engine: bool = False, profile_dir: Optional[str] = None) -> List[RoundRecord]:
        """Train for ``rounds`` rounds, evaluating every ``eval_every``.

        ``engine=True`` drives each stretch between evaluations through
        ``run_rounds``. Time is booked per dispatch: ``RoundRecord.wall_time``
        is the stretch's steady mean host seconds per round (a first
        dispatch of its kind excluded, unless every dispatch of the stretch
        was one), and ``RoundRecord.compile_time`` the seconds of first
        dispatches. Every round ends in a device sync (the loss is read
        back), so both cover the device work too. The same samples feed
        ``self.timer`` (phases ``"round"``, ``"eval"``, ``"train_loss"``);
        each record is also a ``"record"`` event on the sink.

        ``profile_dir``: run the call under ``torch.profiler`` (host
        activities, and the card's when the trainer is on one), with one
        ``record_function("rounds[a:b]")`` range per dispatched stretch,
        and write the trace under that directory
        (``tensorboard_trace_handler``); on a mesh, rank 0 alone.

        ``RoundRecord.round`` continues the trainer's round counter, so
        repeated calls append monotone history.
        """
        if profile_dir is None or not self.writes_files:
            return self._run_chunks(rounds, eval_every, verbose, engine, annotate=False)
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(str(profile_dir))):
            return self._run_chunks(rounds, eval_every, verbose, engine, annotate=True)

    def _run_chunks(self, rounds: int, eval_every: int, verbose: bool, engine: bool,
                    annotate: bool) -> List[RoundRecord]:
        use_engine = engine and self._is_sparse
        done = 0
        while done < rounds:
            chunk = min(eval_every - done % eval_every, rounds - done)
            ctx = (torch.profiler.record_function(
                f"rounds[{self._rounds_run}:{self._rounds_run + chunk}]")
                if annotate else contextlib.nullcontext())
            compile_s = 0.0
            steady: List[float] = []

            def account(dt: float, per_round: float):
                nonlocal compile_s
                if self._last_dispatch_first:
                    compile_s += dt
                    self.timer.add("round", dt, compile=True)
                else:
                    steady.append(per_round)
                    self.timer.add("round", per_round)

            t0 = time.perf_counter()
            with ctx:
                if use_engine:
                    self.run_rounds(chunk)
                    dt = time.perf_counter() - t0
                    account(dt, dt / chunk)
                else:
                    for _ in range(chunk):
                        t1 = time.perf_counter()
                        self.run_round()
                        dt = time.perf_counter() - t1
                        account(dt, dt)
            total = time.perf_counter() - t0
            wall = sum(steady) / len(steady) if steady else total / chunk
            done += chunk
            if done % eval_every == 0 or done == rounds:
                with self.timer.phase("eval"):
                    metric = self.evaluate()
                with self.timer.phase("train_loss"):
                    tl = self.train_loss()
                rec = RoundRecord(self._rounds_run, tl, metric, wall_time=wall,
                                  compile_time=compile_s)
                if self.comm_log:
                    s = self.comm_summary()
                    rec.bytes_up = s["bytes_up_sparse"]
                    rec.bytes_down = s["bytes_down_sparse"]
                    rec.density = s["mean_density"]
                self.history.append(rec)
                self.sink.emit({"event": "record", **dataclasses.asdict(rec)})
                if verbose and self.writes_files:
                    self.sink.report(
                        f"[{self.cfg.algorithm}] round {self._rounds_run}: "
                        f"loss={rec.train_loss:.4f} {self.metric}="
                        f"{rec.test_metric:.4f} ({wall * 1e3:.1f} ms/round)")
        return self.history
