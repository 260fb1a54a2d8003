"""Server orchestration of federated rounds (Algorithm 1, server process).

``FederatedTrainer`` runs the paper's protocol over a ``FederatedDataset``:
each round it samples K clients with a numpy generator, derives their
submodel ids on the device, runs the plan's round step (local training,
``union_segsum`` aggregation, apply) and prices the round's bytes. The
numpy stream is consumed in the same order as the JAX package's trainer, so
the same seed draws the same cohorts.

Ported: the sparse plans that ``FedConfig(sparse=True)`` resolves to. Dense
plans, central SGD, the private heat estimators, weighted heat, telemetry
and the async engine raise ``NotImplementedError`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import make_server_algorithm
from repro_torch.core.heat import HeatStats
from repro_torch.data.batching import pooled_batches, sample_cohort_batch
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.federated.metrics import accuracy, auc, comm_summary
from repro_torch.federated.plan import (RoundPlan, SubmodelReplicatedLocal,
                                        build_round_step, heat_spec_from_axes,
                                        plan_from_config, sparse_table_paths)
from repro_torch.sparse.comm import CommStats, model_comm_meta
from repro_torch.sparse.rowsparse import count_unique_ids, unique_ids_padded


@dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_metric: float
    bytes_up: float = 0.0            # cumulative sparse-plane uplink bytes
    bytes_down: float = 0.0          # cumulative sparse-plane downlink bytes
    density: float = 1.0             # mean per-client submodel density so far
    wall_time: float = 0.0           # mean seconds per round since the last record


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


class FederatedTrainer:
    """End-to-end federated training loop for the paper-scale models.

    ``make_params(device=...)`` returns ``(params, axes)``; ``loss_fn(params,
    batch)`` and ``predict_fn(params, test_data)`` take dicts of tensors on
    the trainer's device (the test split is moved there once).
    ``device=None`` means ``"cuda"`` and raises without a card.
    """

    def __init__(self, ds: FederatedDataset, make_params: Callable,
                 loss_fn: Callable, cfg: FedConfig,
                 predict_fn: Optional[Callable] = None,
                 metric: str = "auc", rng_seed: int = 0,
                 plan: Optional[RoundPlan] = None, device=None):
        self.device = resolve_device(device)
        if cfg.algorithm == "central":
            raise NotImplementedError(
                "central SGD is not ported yet (ROADMAP Queue 1, item 8)")
        self.ds = ds
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.predict_fn = predict_fn
        self.metric = metric
        self.np_rng = np.random.default_rng(cfg.seed + rng_seed)

        params, axes = make_params(device=self.device)
        self.heat = self._resolve_heat(ds, cfg)
        self._heat_spec = heat_spec_from_axes(axes)
        heat_counts = {"vocab": torch.as_tensor(self.heat.counts, dtype=torch.float32,
                                                device=self.device)}
        self.alg = make_server_algorithm(cfg, heat_spec=self._heat_spec,
                                         heat_counts=heat_counts,
                                         total=self.heat.total)
        self.state = self.alg.init(params)
        self.history: List[RoundRecord] = []
        self.comm_log: List[CommStats] = []
        self._rounds_run = 0
        self._last_capacity: Optional[int] = None

        self.plan = self._resolve_trainer_plan(params, plan)
        self._step = build_round_step(self.plan, loss_fn, axes, params, cfg,
                                      heat_counts=heat_counts,
                                      total=self.heat.total)
        self._comm_meta = model_comm_meta(params, set(self._sparse_paths))
        self._test_data = self._to_device(ds.test_data)

    # ------------------------------------------------------------------
    def _resolve_trainer_plan(self, params, plan: Optional[RoundPlan]) -> RoundPlan:
        """Resolve FedConfig flags (or validate an explicit plan): which
        leaves ride the sparse plane and whether submodel replicas can be
        gathered."""
        keys = (self.ds.feature_key,)
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
        """Exact heat (secure aggregation is exact by construction)."""
        if cfg.heat_estimator == "randomized_response" or cfg.weighted:
            raise NotImplementedError(
                "randomized-response and weighted heat are not ported yet "
                "(ROADMAP Queue 1, item 2)")
        return HeatStats(counts=np.asarray(ds.heat.counts, np.float64),
                         total=float(ds.heat.total), name="vocab")

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _sample_sparse_cohort(self):
        """One round's host work: sample the cohort and stack its feature ids
        ``(K, M)``."""
        cfg = self.cfg
        ids = self.np_rng.choice(self.ds.num_clients, size=cfg.clients_per_round,
                                 replace=False)
        cohort = sample_cohort_batch(self.ds, ids, cfg.local_iters,
                                     cfg.local_batch, self.np_rng)
        feats = np.asarray(cohort[self.ds.feature_key]).reshape(len(ids), -1)
        return cohort, feats

    def _log_sparse_comm(self, valid_counts: np.ndarray, capacity: int):
        self.comm_log.append(self.plan.transport.round_comm(
            self._rounds_run, self._comm_meta, valid_counts,
            self.ds.num_features, capacity=capacity, submodel_downlink=True,
            local_iters=self.cfg.local_iters))

    def _run_sparse_round(self) -> float:
        cohort, feats = self._sample_sparse_cohort()
        feats = torch.from_numpy(feats).to(self.device)
        valid_counts = count_sub_ids(feats, self.ds.num_features).cpu().numpy()
        capacity = pow2_capacity(int(valid_counts.max()))
        sub_ids = derive_sub_ids(feats, self.ds.num_features, capacity)
        self.state, metrics = self._step(self.state, self._to_device(cohort),
                                         sub_ids)
        self._last_capacity = capacity
        self._log_sparse_comm(valid_counts, capacity)
        return float(metrics["loss"])

    def run_round(self) -> float:
        self._rounds_run += 1
        return self._run_sparse_round()

    def run_rounds(self, n: int) -> List[float]:
        """``n`` rounds with the JAX engine's semantics: all ``n`` cohorts are
        sampled up front (the same numpy stream as ``n`` ``run_round``
        calls) and share one pow2 sub-id capacity. Returns the per-round
        losses."""
        if n <= 0:
            return []
        k = self.cfg.clients_per_round
        cohorts, feats = [], []
        for _ in range(n):
            c, f = self._sample_sparse_cohort()
            cohorts.append(c)
            feats.append(f)
        flat = torch.from_numpy(np.concatenate(feats)).to(self.device)
        valid_counts = count_sub_ids(flat, self.ds.num_features).cpu().numpy()
        valid_counts = valid_counts.reshape(n, k)
        capacity = pow2_capacity(int(valid_counts.max()))
        sub_ids = derive_sub_ids(flat, self.ds.num_features,
                                 capacity).reshape(n, k, capacity)
        losses = []
        for r in range(n):
            self.state, metrics = self._step(
                self.state, self._to_device(cohorts[r]), sub_ids[r])
            losses.append(metrics["loss"])
            self._rounds_run += 1
            self._log_sparse_comm(valid_counts[r], capacity)
        self._last_capacity = capacity
        return torch.stack(losses).tolist()

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

    def run(self, rounds: int, eval_every: int = 10, verbose: bool = False,
            engine: bool = False) -> List[RoundRecord]:
        """Train for ``rounds`` rounds, evaluating every ``eval_every``.

        ``engine=True`` drives each stretch between evaluations through
        ``run_rounds``. ``RoundRecord.wall_time`` is the stretch's mean host
        seconds per round; every round ends in a device sync (the loss is
        read back), so it covers the device work too.
        """
        done = 0
        while done < rounds:
            chunk = min(eval_every - done % eval_every, rounds - done)
            t0 = time.perf_counter()
            if engine:
                self.run_rounds(chunk)
            else:
                for _ in range(chunk):
                    self.run_round()
            wall = (time.perf_counter() - t0) / chunk
            done += chunk
            if done % eval_every == 0 or done == rounds:
                rec = RoundRecord(self._rounds_run, self.train_loss(),
                                  self.evaluate(), wall_time=wall)
                if self.comm_log:
                    s = self.comm_summary()
                    rec.bytes_up = s["bytes_up_sparse"]
                    rec.bytes_down = s["bytes_down_sparse"]
                    rec.density = s["mean_density"]
                self.history.append(rec)
                if verbose:
                    print(f"[{self.cfg.algorithm}] round {self._rounds_run}: "
                          f"loss={rec.train_loss:.4f} {self.metric}="
                          f"{rec.test_metric:.4f} ({wall * 1e3:.1f} ms/round)")
        return self.history
