"""Rank processes of ``tests/test_torch_sparse_tp.py``: the row-sparse
transport on a vocabulary split over ``model``, on a mesh of gloo ranks.

``run_cases`` runs in each of 4 processes spawned by
``repro_torch.launch.mesh.spawn_ranks``. Case after case it lays a mesh over
the world and trains a tiny model of ``launch.train.SCALES`` for two rounds
from the JAX package's initial parameters, with telemetry on: through
``train(mesh=..., sparse=True)``, or through ``make_round_step`` with an
explicit ``CohortSharding(combine=...)`` in the launcher's loop; and the same
on one device. It saves what it saw to ``rank{r}.pt``: losses, the
parameters gathered whole, the rank's part, its whole leaves after each
round, ``sub_rows``, ``density``, telemetry, uplink bytes, its collective
counters, ``tp_collective_budget`` and K1's calls. This module imports
torch, numpy and the port only (no JAX), so a rank starts quickly.
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import FedConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_lm_federated
from repro_torch.federated.plan import CohortSharding, tp_collective_budget
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import SCALES
from repro_torch.launch.shardings import (param_specs, shard_batch, shard_params,
                                          unshard_params)
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import make_plan, mesh_rules
from repro_torch.models.api import build_model
from repro_torch.sharding.context import get_rules, set_rules
from repro_torch.sparse import aggregate as aggregate_mod
from repro_torch.telemetry.round import telemetry_to_host

WORLD = 4
ROUNDS = 2
#: the reference launcher's defaults: 128 clients of 4 sequences, a cohort
#: of 8, 64 tokens, lr 0.05, fedsubavg
RUN = dict(rounds=ROUNDS, clients=128, cohort=8, seq=64, lr=0.05, algorithm="fedsubavg")
#: a vocabulary no model axis above 1 divides: the table stays whole
ODD_VOCAB = 2050
#: case -> (model, mesh shape, expert_parallel, entry, combine, transport)
#: entry "train" is ``train(mesh=...)``; "step" is ``make_round_step`` with
#: ``CohortSharding(combine=...)``
CASES = {
    "qwen_1x2": ("qwen", (1, 2), False, "train", "auto", "sparse"),
    "qwen_2x2": ("qwen", (2, 2), False, "train", "auto", "sparse"),
    "qwen_1x4": ("qwen", (1, 4), False, "train", "auto", "sparse"),
    "mixtral_ep_1x2": ("mixtral", (1, 2), True, "train", "auto", "sparse"),
    "qwen_2x2_psum": ("qwen", (2, 2), False, "step", "psum", "sparse"),
    "qwen_2x2_union": ("qwen", (2, 2), False, "step", "union", "sparse"),
    "odd_1x4": ("odd", (1, 4), False, "train", "auto", "sparse"),
    "qwen_dense_2x2": ("qwen", (2, 2), False, "train", "auto", "dense"),
}
#: the single-device runs each case is held to: (model, transport)
SINGLE = {("qwen", "sparse"), ("mixtral", "sparse"), ("odd", "sparse"), ("qwen", "dense")}
ARCH = {"qwen": "qwen2_5_14b", "mixtral": "mixtral_8x22b", "odd": "qwen2_5_14b"}


def tiny_config(model: str):
    cfg = get_config(ARCH[model]).replace(**SCALES["tiny"])
    return cfg.replace(vocab_size=ODD_VOCAB) if model == "odd" else cfg


def _host_metrics(metrics: dict) -> dict:
    out = {"loss": float(metrics["loss"])}
    if "sub_rows" in metrics:
        out["sub_rows"] = int(metrics["sub_rows"])
        out["density"] = float(metrics["density"])
    out["telemetry"] = telemetry_to_host(metrics["telemetry"])
    return out


def _count_k1():
    """Count ``aggregate_rowsparse``'s calls of K1's wrapper (its plain
    version on these CPU tensors)."""
    calls = []
    orig = aggregate_mod.union_segsum_torch

    def counted(ids, rows, heat, total, cap, num_rows, **kw):
        calls.append((tuple(ids.shape), tuple(rows.shape), int(num_rows)))
        return orig(ids, rows, heat, total, cap, num_rows, **kw)

    aggregate_mod.union_segsum_torch = counted
    return calls, orig


def _whole_leaves(local: dict, specs: dict) -> dict:
    return {n: t.clone() for n, t in local.items() if all(s is None for s in specs[n])}


def _train_case(cfg, params, axes, mesh, ep, sparse, gather, specs):
    """``train`` with telemetry; ``gather`` makes the rank's parameters
    whole after each round (None: they are)."""
    rounds, whole, per_round = [], [], []

    def on_round(r, local, metrics):
        rounds.append(_host_metrics(metrics))
        per_round.append(gather(local) if gather else {n: t.clone() for n, t in local.items()})
        if specs is not None:
            whole.append(_whole_leaves(local, specs))

    calls, orig = _count_k1()
    # the launcher's step with telemetry on (the launcher leaves it off)
    step = train_mod.make_round_step
    train_mod.make_round_step = functools.partial(step, telemetry=True)
    try:
        res = train_mod.train(cfg, **RUN, device="cpu",
                              params={k: v.clone() for k, v in params.items()}, axes=axes,
                              mesh=mesh, expert_parallel=ep, sparse=sparse, log_every=0,
                              on_round=on_round)
    finally:
        train_mod.make_round_step = step
        aggregate_mod.union_segsum_torch = orig
    return {"losses": res.losses, "rounds": rounds, "params": res.params,
            "per_round": per_round, "bytes_up": res.bytes_up_sparse,
            "counters": res.counters, "whole": whole, "k1": calls}


def _step_case(cfg, params, axes, mesh, rules, combine, gather, specs):
    """The launcher's loop through ``make_round_step`` with an explicit
    ``CohortSharding(combine=...)`` (``train`` leaves the combine on auto)."""
    full_shapes = {n: tuple(t.shape) for n, t in params.items()}
    plan = dataclasses.replace(
        make_plan(RUN["algorithm"], sparse=True),
        sharding=CohortSharding(mesh.axis("data"), combine=combine, shapes=full_shapes))
    # the sparse apply writes the table in place, and a whole leaf's part is
    # the tensor passed in
    local = shard_params({k: v.clone() for k, v in params.items()}, axes, mesh, rules)
    api = build_model(cfg)
    ds = make_lm_federated(num_clients=RUN["clients"], vocab=cfg.vocab_size,
                           seq_len=RUN["seq"], samples_per_client=4, zipf_a=1.2)
    fed = FedConfig(num_clients=ds.num_clients, clients_per_round=RUN["cohort"],
                    lr=RUN["lr"], algorithm=RUN["algorithm"])
    step = make_round_step(functools.partial(api.loss, remat=True), local, axes, fed,
                           mode=plan, telemetry=True)
    heat = shard_batch({"heat_vocab": torch.as_tensor(ds.heat.counts, dtype=torch.float32)},
                       mesh, rules)["heat_vocab"]
    rng = np.random.default_rng(0)
    tokens = ds.client_data["tokens"]
    out = {"losses": [], "rounds": [], "counters": [], "whole": [], "per_round": []}
    calls, orig = _count_k1()
    installed = get_rules()
    set_rules(mesh, rules)
    try:
        for _ in range(RUN["rounds"]):
            ids = rng.choice(ds.num_clients, size=RUN["cohort"], replace=False)
            sample = rng.integers(0, tokens.shape[1], size=RUN["cohort"])
            mesh.reset_counters()
            local, metrics = step(local, {"tokens": torch.from_numpy(tokens[ids, sample]),
                                          "heat_vocab": heat})
            out["losses"].append(float(metrics["loss"]))
            out["rounds"].append(_host_metrics(metrics))
            out["counters"].append(mesh.counters)
            out["whole"].append(_whole_leaves(local, specs))
            out["per_round"].append(gather(local))
    finally:
        set_rules(*installed)
        aggregate_mod.union_segsum_torch = orig
    out.update(params=local, k1=calls)
    return out


def _without_telemetry(counters: dict) -> dict:
    return {axis: {tag: c for tag, c in comps.items() if not tag.startswith("telemetry:")}
            for axis, comps in counters.items()}


def run_case(name: str, mesh, params, axes) -> dict:
    model, shape, ep, entry, combine, transport = CASES[name]
    cfg = tiny_config(model)
    full_shapes = {n: tuple(t.shape) for n, t in params.items()}
    rules = mesh_rules(cfg, mesh, ep)
    specs = param_specs(axes, full_shapes, mesh, rules)

    def gather(local):
        return unshard_params(local, full_shapes, axes, mesh, rules)

    if entry == "train":
        res = _train_case(cfg, params, axes, mesh, ep, transport == "sparse", gather, specs)
    else:
        res = _step_case(cfg, params, axes, mesh, rules, combine, gather, specs)
    budget = tp_collective_budget(cfg, mesh, {"tokens": torch.zeros(RUN["cohort"], RUN["seq"])},
                                  rules=rules, sparse=transport == "sparse", combine=combine)
    return {"losses": res["losses"], "rounds": res["rounds"], "per_round": res["per_round"],
            "local": res["params"], "whole": res["whole"], "k1": res["k1"],
            "bytes_up": res.get("bytes_up"),
            "counters": [_without_telemetry(c) for c in res["counters"]],
            "telemetry_tags": sorted({f"{axis}/{tag}" for c in res["counters"]
                                      for axis, comps in c.items() for tag in comps
                                      if tag.startswith("telemetry:")}),
            "budget": budget["axes"], "coords": mesh.coords, "mesh_ranks": mesh.ranks,
            "split_leaves": sorted(n for n, spec in specs.items() if any(spec))}


def run_cases(rank: int, store: str, init_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    out = {}
    try:
        inits = {}
        for model in ARCH:
            init = dict(np.load(Path(init_dir) / f"{model}.npz"))
            inits[model] = params_from_jax(init, device="cpu", cfg=tiny_config(model),
                                           flat=True)
        for model, transport in sorted(SINGLE):
            params, axes = inits[model]
            res = _train_case(tiny_config(model), params, axes, None, False,
                              transport == "sparse", None, None)
            out[f"single/{model}/{transport}"] = {
                "losses": res["losses"], "rounds": res["rounds"], "per_round": res["per_round"],
                "bytes_up": res["bytes_up"], "k1": res["k1"]}
        for name, case in CASES.items():
            mesh = make_device_mesh(case[1], device="cpu")
            out[name] = run_case(name, mesh, *inits[case[0]])
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
