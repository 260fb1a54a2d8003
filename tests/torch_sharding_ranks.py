"""Rank processes of ``tests/test_torch_sharding.py``.

Each function here runs in a process spawned by
``repro_torch.launch.mesh.spawn_ranks``: it joins a gloo mesh on the host
through a file store, runs a whole case matrix of the sharded round step and
trainer, and saves what it saw to ``rank{r}.pt`` for the test to read back.
This module imports torch, numpy and the port only (no JAX), so a rank
starts quickly; the test holds the results to the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.hlo_audit import comm_drift
from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import ServerState
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated.plan import (CohortSharding, DenseTransport, FedSgdLocal,
                                        RoundPlan, ServerUpdate, build_round_step,
                                        resolve_plan, round_collective_budget)
from repro_torch.federated.server import FederatedTrainer
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.models.recsys import lr_logits, lr_loss, lstm_loss, make_lr_params
from repro_torch.sparse.encode import batch_union_ids
from repro_torch.telemetry.round import telemetry_to_host

V, E = 128, 6                       # tests/test_shard_parity.py's LSTM
MODES = ("fedsgd", "sparse", "replicated", "sparse_replicated")
FLAT_MODES = ("fedsgd", "sparse")
TRAINER_CASES = {"sparse": dict(sparse=True), "dense": dict(sparse=False),
                 "fedadam": dict(sparse=True, algorithm="fedadam"),
                 "scaffold": dict(sparse=True, algorithm="scaffold")}


def flat_batch(seed: int, b: int = 8, s: int = 8) -> dict:
    """``tests/test_shard_parity.py::_flat_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, (b, s)).astype(np.int32),
            "label": rng.integers(0, 2, b).astype(np.int32),
            "heat_vocab": np.maximum(rng.integers(0, 6, V).astype(np.float32), 0)}


def cohort_batch(seed: int, k: int = 3, i: int = 2, b: int = 2, s: int = 6) -> dict:
    """``tests/test_shard_parity.py::_cohort_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(-1, V, (k, i, b, s)).astype(np.int32),
            "label": rng.integers(0, 2, (k, i, b)).astype(np.int32),
            "heat_vocab": np.maximum(rng.integers(0, 6, V).astype(np.float32), 0)}


def mode_batch(mode: str, seed: int, k: int = 3) -> dict:
    return flat_batch(seed) if mode in FLAT_MODES else cohort_batch(seed, k=k)


def fed(k: int = 3, **kw) -> FedConfig:
    return FedConfig(**{**dict(num_clients=16, clients_per_round=k, local_iters=2,
                               lr=0.1, algorithm="fedsubavg"), **kw})


def trainer_data():
    """``tests/test_shard_parity.py``'s trainer dataset."""
    return make_movielens_like(num_clients=40, num_items=40, mean_samples=15)


def make_trainer(ds, mesh=None, clients_per_round: int = 5, **kw) -> FederatedTrainer:
    """``tests/test_shard_parity.py::_trainer`` on the port."""
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=clients_per_round,
                    local_iters=3, local_batch=4, lr=0.5,
                    algorithm=kw.pop("algorithm", "fedsubavg"), **kw)
    return FederatedTrainer(
        ds, lambda device: make_lr_params(ds.num_features, device=device), lr_loss, cfg,
        predict_fn=lambda p, t: lr_logits(p, t["features"]), metric="auc",
        device="cpu", mesh=mesh)


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _host(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _run_steps(mesh, params0, axes, mode, correct=True, combine="auto", k=3, rounds=3,
               telemetry=False) -> dict:
    """``rounds`` sharded ``make_round_step`` steps on the
    ``tests/test_shard_parity.py`` batches; per step the loss, sub_rows,
    telemetry, whether the mesh's counters equal the budget and, on the
    sparse transport, their drift from ``sharded_combine_bytes``."""
    cfg = fed(k)
    plan = dataclasses.replace(resolve_plan(mode, cfg, correct=correct),
                               sharding=CohortSharding(mesh, combine=combine))
    step = make_round_step(lstm_loss, params0, axes, cfg, mode=plan, telemetry=telemetry)
    params = _host(params0)
    out = {"loss": [], "sub_rows": [], "telemetry": [], "counters_equal_budget": [],
           "counters": [], "budget": [], "drift": []}
    for r in range(rounds):
        batch = _tensors(mode_batch(mode, 100 + r, k))
        budget = round_collective_budget(plan, axes, params, cfg, batch)
        params, m = step(params, batch)
        out["loss"].append(float(m["loss"]))
        if "sub_rows" in m:
            out["sub_rows"].append(int(m["sub_rows"]))
        if telemetry:
            out["telemetry"].append(telemetry_to_host(m["telemetry"]))
        else:
            out["counters"].append(dict(mesh.counters))
            out["budget"].append(budget["components"])
            out["counters_equal_budget"].append(mesh.counters == budget["components"])
            if plan.transport.sparse:
                out["drift"].append(comm_drift(plan, axes, params, cfg, batch,
                                               measured=mesh.by_op()).to_dict())
    out["params"] = _host(params)
    return out


def _refusal(fn) -> str:
    """The message of the ValueError ``fn`` raises, or ''."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _cases_two(mesh, params0, axes) -> dict:
    res = {}
    for mode in MODES:
        for correct in (True, False):
            res[f"steps/{mode}/{correct}"] = _run_steps(mesh, params0, axes, mode, correct)
            res[f"tel/{mode}/{correct}"] = _run_steps(mesh, params0, axes, mode, correct,
                                                      telemetry=True)
        for combine in ("psum", "union"):
            res[f"combine/{mode}/{combine}"] = _run_steps(mesh, params0, axes, mode,
                                                          combine=combine)
    res["non_divisible"] = _run_steps(mesh, params0, axes, "sparse_replicated", k=5)

    cfg = fed()
    plan = resolve_plan("sparse", cfg)
    step = build_round_step(dataclasses.replace(plan, sharding=CohortSharding(mesh)),
                            lstm_loss, axes, params0, cfg)
    batch = _tensors(flat_batch(3))
    sub_ids = batch_union_ids(batch, ("tokens",), 64)
    st, m = step(ServerState(_host(params0), (), 0), batch, sub_ids)
    res["explicit_sub_ids"] = {"loss": float(m["loss"]), "sub_rows": int(m["sub_rows"]),
                               "params": _host(st.params)}

    fedsgd = dataclasses.replace(resolve_plan("fedsgd", cfg), sharding=CohortSharding(mesh))
    step = make_round_step(lstm_loss, params0, axes, cfg, mode=fedsgd)
    res["flat_must_divide"] = _refusal(
        lambda: step(_host(params0), _tensors(flat_batch(0, b=mesh.size + 1))))
    mb = RoundPlan(FedSgdLocal(microbatches=4), DenseTransport(), ServerUpdate("fedavg"),
                   sharding=CohortSharding(mesh))
    step = make_round_step(lstm_loss, params0, axes, fed(microbatches=4), mode=mb,
                           correct=False)
    res["microbatches"] = _refusal(
        lambda: step(_host(params0), _tensors(flat_batch(0, b=2 * mesh.size))))

    base = dataclasses.replace(resolve_plan("sparse_replicated", fed(8)),
                               sharding=CohortSharding(mesh))
    batch = _tensors(cohort_batch(0, k=8))
    for label, plan in (("plain", base), ("checked", dataclasses.replace(
            base, debug_checks=True))):
        step = build_round_step(plan, lstm_loss, axes, params0, fed(8))
        st, m = step(ServerState(_host(params0), (), 0), batch)
        res[f"debug/{label}"] = {"loss": float(m["loss"]), "params": _host(st.params)}
    return res


def _trainer_cases(mesh) -> dict:
    ds = trainer_data()
    res = {}
    for label, kw in TRAINER_CASES.items():
        tr = make_trainer(ds, mesh, **kw)
        n = 4 if label == "sparse" else 3
        losses = [tr.run_round() for _ in range(n)]
        res[f"trainer/{label}"] = {
            "loss": losses, "params": _host(tr.state.params),
            "opt": tr.state.opt,
            "comm": tr.comm_summary() if tr.comm_log else None,
            "telemetry": tr.telemetry_log, "auc": tr.evaluate()}
    tr = make_trainer(ds, mesh, sparse=True)
    losses = tr.run_rounds(4)
    res["trainer/engine"] = {"loss": losses, "params": _host(tr.state.params),
                             "telemetry": tr.telemetry_log}
    return res


def _cases_three(mesh, params0, axes) -> dict:
    res = {"non_divisible": _run_steps(mesh, params0, axes, "sparse_replicated", k=5)}
    for combine in ("psum", "union"):
        res[f"combine/{combine}"] = _run_steps(mesh, params0, axes, "sparse_replicated",
                                               combine=combine, k=5)
    res.update(_trainer_cases(mesh))
    return res


def run_matrix(rank: int, world: int, store: str, out_dir: str, params_path: str,
               with_trainer: bool) -> None:
    """One gloo rank on the host: the whole case matrix for ``world`` ranks,
    saved to ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(1)
    mesh = make_cohort_mesh(device="cpu", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        data = np.load(params_path)
        params0 = {k: torch.from_numpy(data[k].copy()) for k in data.files}
        from repro_torch.models.recsys import lstm_axes
        axes = lstm_axes(1)
        t0 = time.perf_counter()
        if world == 2:
            res = _cases_two(mesh, params0, axes)
            if with_trainer:
                res.update(_trainer_cases(mesh))
        else:
            res = _cases_three(mesh, params0, axes)
        res["seconds"] = time.perf_counter() - t0
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
        mesh.barrier()
    finally:
        mesh.destroy()


def stuck_rank(rank: int, world: int, store: str) -> None:
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    torch.set_num_threads(1)
    mesh = make_cohort_mesh(device="cpu", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    if rank == 0:
        mesh.psum(torch.ones(1), "stuck")
    else:
        time.sleep(600)


def failing_rank(rank: int, world: int, store: str) -> None:
    """Rank 1 raises before its first collective."""
    torch.set_num_threads(1)
    mesh = make_cohort_mesh(device="cpu", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    mesh.psum(torch.ones(1), "never")


def mrope_case():
    """Qwen2-VL's smoke model (f32, weights from seed 0) and a flat batch of
    4 x 16 tokens with patches and image-grid streams, for the flat shard's
    per-rank slice of ``mrope_pos`` (3, B, S)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.serve import image_grid_positions
    from repro_torch.models import transformer
    cfg = get_smoke_config("qwen2_vl_7b").replace(dtype="float32")
    params, axes = transformer.train_params(
        transformer.make_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                        .astype(np.int32)),
             "mrope_pos": image_grid_positions(4, 16, 2, 4),
             "patch_embeds": torch.from_numpy(rng.normal(
                 size=(4, cfg.num_patches, cfg.d_model)).astype(np.float32)),
             "heat_vocab": torch.ones(cfg.vocab_size)}
    return cfg, params, axes, batch


def mrope_flat_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank: the sharded FedSgdLocal step on ``mrope_case`` whole
    and in 2 microbatches; saves each step's loss, parameters and the shape
    of each ``mrope_pos`` the rank's loss saw."""
    from repro_torch.models.api import build_model
    torch.set_num_threads(1)
    mesh = make_cohort_mesh(device="cpu", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        cfg, params0, axes, batch = mrope_case()
        api = build_model(cfg)
        seen = []

        def loss(p, b):
            seen.append(tuple(b["mrope_pos"].shape))
            return api.loss(p, b)

        res = {}
        for nmb in (1, 2):
            fcfg = FedConfig(num_clients=10, lr=0.1, algorithm="fedsubavg", microbatches=nmb)
            plan = dataclasses.replace(resolve_plan("fedsgd", fcfg),
                                       sharding=CohortSharding(mesh))
            step = make_round_step(loss, params0, axes, fcfg, mode=plan)
            seen.clear()
            params, m = step(_host(params0), batch)
            res[nmb] = {"loss": float(m["loss"]), "params": _host(params),
                        "mrope_shapes": list(seen)}
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
        mesh.barrier()
    finally:
        mesh.destroy()
