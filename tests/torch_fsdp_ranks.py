"""Rank processes of ``tests/test_torch_fsdp.py``: the dry run's other
layouts on gloo ranks, FSDP (each weight's ``d_model`` split over
``data``, gathered per layer) and the multi-pod ``(pod, data, model)`` mesh.

``run_cases`` runs in each of 4 processes spawned by
``repro_torch.launch.mesh.spawn_ranks``. Case after case it lays a mesh over
the world (a ``(2, 1)`` mesh twice over; ``(2, 2)``, ``(2, 1, 2)`` and
``(2, 2, 1)`` once) and trains the tiny model of the case for two rounds
through ``repro_torch.launch.train.train(mesh=..., layout=...)`` from the
JAX package's initial parameters, or serves it (a prefill and ``GEN``
greedy steps) through ``serve(mesh=..., layout=...)``; it runs the same on
one device. It saves what it saw to ``rank{r}.pt``: losses, the parameters
gathered whole after each round, the rank's own part at the end, its
collective counters and the budget, and the served logits and tokens of its
rows. This module imports torch, numpy and the port only (no JAX); the test
holds the results to the JAX package and to each other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.federated.plan import serve_collective_budget, tp_collective_budget
from repro_torch.launch.mesh import MESH_AXES, make_device_mesh
from repro_torch.launch.serve import SCALES, prompt_tokens, serve
from repro_torch.launch.shardings import _index, param_specs, shard_params, unshard_params
from repro_torch.launch.train import train

import torch_tp_ranks

WORLD = 4
ROUNDS = 2
RUN = torch_tp_ranks.RUN
#: the served batch, prompt and greedy steps
BATCH, PROMPT, GEN = 4, 18, 6
#: training case -> (arch, mesh shape, layout, expert_parallel, sparse)
TRAIN_CASES = {
    "qwen_fsdp_2x1": ("qwen2_5_14b", (2, 1), "fsdp", False, False),
    "qwen_fsdp_2x2": ("qwen2_5_14b", (2, 2), "fsdp", False, False),
    "qwen_sparse_fsdp_2x2": ("qwen2_5_14b", (2, 2), "fsdp", False, True),
    "mixtral_tp_fsdp_2x2": ("mixtral_8x22b", (2, 2), "fsdp", False, False),
    "mixtral_ep_fsdp_2x2": ("mixtral_8x22b", (2, 2), "fsdp", True, False),
    "qwen_tp_2x1x2": ("qwen2_5_14b", (2, 1, 2), "tp", False, False),
    "qwen_fsdp_2x2x1": ("qwen2_5_14b", (2, 2, 1), "fsdp", False, False),
    "vlm_fsdp_2x2": ("qwen2_vl_7b", (2, 2), "fsdp", False, False),
}
#: serving case -> (arch, mesh shape, layout)
SERVE_CASES = {
    "qwen_serve_fsdp_2x2": ("qwen2_5_14b", (2, 2), "fsdp"),
    "qwen_serve_tp_2x1x2": ("qwen2_5_14b", (2, 1, 2), "tp"),
}
#: the case whose gathered checkpoint the test loads into the JAX package
CKPT_CASE = "qwen_fsdp_2x2"


def tiny_config(arch: str):
    return get_config(arch).replace(**SCALES["tiny"])


def serve_tokens() -> np.ndarray:
    """The prompts ``serve`` draws for the tiny Qwen2.5."""
    return prompt_tokens(tiny_config("qwen2_5_14b"), BATCH, PROMPT).numpy()


def _init(arch: str, in_dir: Path):
    cfg = tiny_config(arch)
    init = dict(np.load(in_dir / f"{arch}.npz"))
    params, axes = params_from_jax(init, device="cpu", cfg=cfg, flat=True)
    return cfg, params, axes


def _train(cfg, params, axes, mesh=None, **kw):
    """``train`` of the case, with the parameters (gathered whole on a
    mesh) and ``sub_rows`` after each round."""
    full = {n: tuple(t.shape) for n, t in params.items()}
    per_round, sub_rows = [], []

    def on_round(r, local, metrics):
        whole = local if mesh is None else unshard_params(local, full, axes, mesh, rules[0])
        per_round.append({n: t.clone() for n, t in whole.items()})
        if "sub_rows" in metrics:
            sub_rows.append(int(metrics["sub_rows"]))

    rules = [None]
    if mesh is not None:
        from repro_torch.launch.train import mesh_rules
        rules[0] = mesh_rules(cfg, mesh, kw.get("expert_parallel", False),
                              kw.get("layout", "tp"))
    inputs = torch_tp_ranks.vlm_inputs(cfg) if cfg.family == "vlm" else None
    res = train(cfg, **RUN, device="cpu", params={k: v.clone() for k, v in params.items()},
                axes=axes, mesh=mesh, log_every=0, inputs=inputs, on_round=on_round, **kw)
    return res, per_round, sub_rows


def run_train_case(name: str, mesh, in_dir: Path, out_dir: Path, singles: dict) -> dict:
    arch, shape, layout, ep, sparse = TRAIN_CASES[name]
    cfg, params, axes = _init(arch, in_dir)
    if (arch, sparse) not in singles:
        singles[(arch, sparse)] = _train(cfg, params, axes, sparse=sparse)
    single, single_rounds, single_rows = singles[(arch, sparse)]
    ckpt = str(out_dir / name) if name == CKPT_CASE else ""
    res, rounds, rows = _train(cfg, params, axes, mesh, layout=layout, expert_parallel=ep,
                               sparse=sparse, ckpt=ckpt)
    full = {n: tuple(t.shape) for n, t in params.items()}
    budget = tp_collective_budget(cfg, mesh, {"tokens": torch.zeros(RUN["cohort"], RUN["seq"])},
                                  rules=res.rules, sparse=sparse)
    # the split and its gather round trip, also with d_model over a joint axis
    # (every leaf's embed dim over ("pod", "data") on the 3-D meshes)
    joint = dict(res.rules, embed=res.rules["batch"])
    back = unshard_params(shard_params(params, axes, mesh, joint), full, axes, mesh, joint)
    return {"round_trip": all(torch.equal(back[n], params[n]) for n in params),
            "joint_specs": param_specs(axes, full, mesh, joint),"losses": res.losses, "single_losses": single.losses, "rounds": rounds,
            "single_rounds": single_rounds, "sub_rows": rows, "single_sub_rows": single_rows,
            "local": res.params, "specs": param_specs(axes, full, mesh, res.rules),
            "full_shapes": full, "counters": res.counters, "budget": budget["axes"],
            "rules": res.rules, "coords": mesh.coords, "mesh_ranks": mesh.ranks,
            "axis_names": mesh.axis_names}


def run_serve_case(name: str, mesh, in_dir: Path) -> dict:
    arch, shape, layout = SERVE_CASES[name]
    cfg, params, axes = _init(arch, in_dir)
    kw = dict(batch=BATCH, prompt=PROMPT, gen=GEN, device="cpu")
    single = serve(cfg, params=params, **kw)
    res = serve(cfg, params=(params, axes), mesh=mesh, layout=layout, **kw)
    budget = serve_collective_budget(cfg, mesh, BATCH, PROMPT, GEN, rules=res.rules)
    return {"logits": res.logits, "tokens": res.tokens, "single_logits": single.logits,
            "single_tokens": single.tokens, "counters_prefill": res.counters_prefill,
            "counters_steps": res.counters_steps, "budget": budget,
            "rows": _index(mesh, res.rules["batch"]), "coords": mesh.coords,
            "mesh_ranks": mesh.ranks, "axis_names": mesh.axis_names}


def run_cases(rank: int, store: str, in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    out, singles = {}, {}
    try:
        for name, (_, shape, _, _, _) in TRAIN_CASES.items():
            mesh = make_device_mesh(shape, MESH_AXES[len(shape)], device="cpu")
            out[name] = run_train_case(name, mesh, Path(in_dir), Path(out_dir), singles)
        for name, (_, shape, _) in SERVE_CASES.items():
            mesh = make_device_mesh(shape, MESH_AXES[len(shape)], device="cpu")
            out[name] = run_serve_case(name, mesh, Path(in_dir))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
