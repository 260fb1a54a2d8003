"""Rank processes of ``tests/test_torch_tp.py``: the transformer's training
round split over a ``(data, model)`` mesh of gloo ranks.

``run_cases`` runs in each of 4 processes spawned by
``repro_torch.launch.mesh.spawn_ranks``. Case after case it lays a mesh over
the world (a ``(1, 2)`` mesh twice over, a ``(2, 2)`` or ``(1, 4)`` once),
trains the tiny model of the case for two rounds through
``repro_torch.launch.train.train(mesh=...)`` from the JAX package's initial
parameters, and trains it on one device the same way. It saves what it saw
to ``rank{r}.pt``: losses, the rank's parameters, the parameters gathered
whole, its replicated leaves after each round, its collective counters and
``tp_collective_budget``, and the MoE's routing. This module imports torch,
numpy and the port only (no JAX), so a rank starts quickly; the test holds
the results to the JAX package and to each other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.federated.plan import tp_collective_budget
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import SCALES
from repro_torch.launch.shardings import param_specs, shard_params, unshard_params
from repro_torch.launch.train import mesh_rules, train
from repro_torch.models import layers

WORLD = 4
ROUNDS = 2
#: the reference launcher's defaults (``repro/launch/train.py``): 128
#: clients of 4 sequences, a cohort of 8, 64 tokens, lr 0.05, fedsubavg
RUN = dict(rounds=ROUNDS, clients=128, cohort=8, seq=64, lr=0.05, algorithm="fedsubavg")
#: case -> (arch, mesh shape, expert_parallel, the JAX package's case or None)
CASES = {
    "qwen_1x2": ("qwen2_5_14b", (1, 2), False, "qwen_m2"),
    "qwen_2x2": ("qwen2_5_14b", (2, 2), False, "qwen_m2"),
    "qwen_1x4": ("qwen2_5_14b", (1, 4), False, "qwen_m4"),
    "mixtral_tp_2x2": ("mixtral_8x22b", (2, 2), False, "mixtral_tp"),
    "mixtral_ep_1x2": ("mixtral_8x22b", (1, 2), True, "mixtral_ep"),
    "qwen3_1x4": ("qwen3_32b", (1, 4), False, None),
    "vlm_1x2": ("qwen2_vl_7b", (1, 2), False, None),
}
#: the case whose gathered checkpoint the test loads into the JAX package
CKPT_CASE = "qwen_2x2"


def tiny_config(arch: str):
    return get_config(arch).replace(**SCALES["tiny"])


def vlm_inputs(cfg) -> dict:
    """Patch embeddings and M-RoPE streams for every round's cohort."""
    rng = np.random.default_rng(5)
    b, s = RUN["cohort"], RUN["seq"]
    pos = np.broadcast_to(np.arange(s), (3, b, s)).copy()
    pos[1:, :, :cfg.num_patches] = rng.integers(0, 4, (2, b, cfg.num_patches))
    return {"patch_embeds": torch.from_numpy(
                rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)),
            "mrope_pos": torch.from_numpy(pos.astype(np.int64))}


def _recording_routes(out: list):
    """Wrap ``layers.moe_route`` to append each call's expert ids and
    kept assignments (the rank's tokens')."""
    orig = layers.moe_route

    def rec(*a, **kw):
        r = orig(*a, **kw)
        out.append((r.expert_ids.tolist(), r.keep.tolist()))
        return r

    layers.moe_route = rec
    return orig


def _train(cfg, params, axes, mesh=None, ep=False, ckpt="", on_round=None):
    """``train`` of the case, with the MoE's routing recorded."""
    routes: list = []
    orig = _recording_routes(routes)
    try:
        inputs = vlm_inputs(cfg) if cfg.family == "vlm" else None
        res = train(cfg, **RUN, device="cpu", params={k: v.clone() for k, v in params.items()},
                    axes=axes, mesh=mesh, expert_parallel=ep, log_every=0, ckpt=ckpt,
                    inputs=inputs, on_round=on_round)
    finally:
        layers.moe_route = orig
    return res, routes


def run_case(name: str, mesh, init_dir: Path, out_dir: Path) -> dict:
    arch, shape, ep, _ = CASES[name]
    cfg = tiny_config(arch)
    init = dict(np.load(init_dir / f"{arch}.npz"))
    params, axes = params_from_jax(init, device="cpu", cfg=cfg, flat=True)
    single, single_routes = _train(cfg, params, axes)
    full_shapes = {n: tuple(t.shape) for n, t in params.items()}
    rules = mesh_rules(cfg, mesh, ep)
    specs = param_specs(axes, full_shapes, mesh, rules)
    replicated: list = []

    def on_round(r, local, metrics):
        replicated.append({n: t.clone() for n, t in local.items()
                           if all(s is None for s in specs[n])})

    ckpt = str(out_dir / name) if name == CKPT_CASE else ""
    res, routes = _train(cfg, params, axes, mesh, ep, ckpt, on_round)
    budget = tp_collective_budget(cfg, mesh, {"tokens": torch.zeros(RUN["cohort"], RUN["seq"])},
                                  rules=res.rules)
    whole = unshard_params(res.params, full_shapes, axes, mesh, rules)
    # shard_params then unshard_params gives the input back, bit for bit
    back = unshard_params(shard_params(params, axes, mesh, rules), full_shapes, axes, mesh,
                          rules)
    round_trip = all(torch.equal(back[n], params[n]) for n in params)
    return {"losses": res.losses, "single_losses": single.losses,
            "params": whole, "single_params": single.params, "local": res.params,
            "specs": specs, "replicated": replicated, "counters": res.counters,
            "budget": budget["axes"], "routes": routes, "single_routes": single_routes,
            "round_trip": round_trip, "coords": mesh.coords, "mesh_ranks": mesh.ranks,
            "split_leaves": sorted(n for n, spec in specs.items() if any(spec))}


def run_cases(rank: int, store: str, init_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    out = {}
    try:
        for name, (_, shape, _, _) in CASES.items():
            mesh = make_device_mesh(shape, device="cpu")
            out[name] = run_case(name, mesh, Path(init_dir), Path(out_dir))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
