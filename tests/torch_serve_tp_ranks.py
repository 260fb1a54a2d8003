"""Rank processes of ``tests/test_torch_serve_tp.py``: the transformer served
on a ``(data, model)`` mesh of gloo ranks under ``make_rules("decode")``.

``run_cases`` runs in each of 4 processes spawned by
``repro_torch.launch.mesh.spawn_ranks``. Case after case it lays a mesh over
the world (a ``(1, 2)`` mesh twice over, a ``(2, 2)`` or ``(1, 4)`` once),
serves the tiny model of the case from the JAX package's initial parameters
through ``repro_torch.launch.serve.serve(mesh=...)`` (a prefill and
``GEN`` greedy steps), and serves it on one device the same way. It saves
what it saw to ``rank{r}.pt``: the rank's rows of every step's logits and
of the greedy tokens, the single-device run's, its collective counters and
``serve_collective_budget``, and the bytes of its part of the cache. This
module imports torch, numpy and the port only (no JAX), so a rank starts
quickly; the test holds the results to the JAX package and to each other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.federated.plan import serve_collective_budget
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import SCALES, decode_mrope_pos, prompt_tokens, serve

WORLD = 4
BATCH = 4
GEN = 6
#: case -> (arch, mesh shape, expert_parallel, config overrides, prompt).
#: Qwen2.5's 18 + 6 slots split over 2 and 4 model ranks; Mixtral's 40-token
#: prompt passes its 32-slot window, so the ring is split; 13 + 6 = 19 slots
#: do not divide 2 (the cache stays whole on each model rank); 6 query heads
#: do not divide 4 (whole heads on every rank, the sequence still split)
CASES = {
    "qwen_1x2": ("qwen2_5_14b", (1, 2), False, {}, 18),
    "qwen_2x2": ("qwen2_5_14b", (2, 2), False, {}, 18),
    "qwen_1x4": ("qwen2_5_14b", (1, 4), False, {}, 18),
    "mixtral_tp_2x2": ("mixtral_8x22b", (2, 2), False, {"sliding_window": 32}, 40),
    "mixtral_ep_1x2": ("mixtral_8x22b", (1, 2), True, {"sliding_window": 32}, 40),
    "qwen3_1x4": ("qwen3_32b", (1, 4), False, {}, 18),
    "vlm_1x2": ("qwen2_vl_7b", (1, 2), False, {}, 18),
    "whole_cache_1x2": ("qwen2_5_14b", (1, 2), False, {}, 13),
    "heads6_1x4": ("qwen2_5_14b", (1, 4), False, {"num_heads": 6}, 18),
}


def tiny_config(case: str):
    arch, _, _, over, _ = CASES[case]
    return get_config(arch).replace(**SCALES["tiny"]).replace(**over)


def init_key(case: str) -> str:
    """The initial parameters a case serves: one file per architecture and
    head count (the window changes no parameter)."""
    arch, _, _, over, _ = CASES[case]
    return arch + ("_h%d" % over["num_heads"] if "num_heads" in over else "")


def case_inputs(case: str) -> dict:
    """The prompts ``serve`` draws (``prompt_tokens``) and, for Qwen2-VL,
    patch embeddings and M-RoPE streams (an image's grid on the first
    patches), with each decode step's streams: whole-batch numpy arrays."""
    cfg = tiny_config(case)
    prompt = CASES[case][4]
    out = {"tokens": prompt_tokens(cfg, BATCH, prompt).numpy()}
    if cfg.family == "vlm":
        rng = np.random.default_rng(7)
        pos = np.broadcast_to(np.arange(prompt), (3, BATCH, prompt)).copy()
        pos[1:, :, :cfg.num_patches] = rng.integers(0, 4, (2, BATCH, cfg.num_patches))
        out["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
        out["mrope_pos"] = pos.astype(np.int32)
        out["steps_pos"] = decode_mrope_pos(torch.from_numpy(out["mrope_pos"]), GEN).numpy()
    return out


def run_case(name: str, mesh, in_dir: Path) -> dict:
    arch, shape, ep, _, prompt = CASES[name]
    cfg = tiny_config(name)
    init = dict(np.load(in_dir / f"{init_key(name)}.npz"))
    flat, axes = params_from_jax(init, device="cpu", cfg=cfg, flat=True)
    extra = {k: torch.from_numpy(v) for k, v in np.load(in_dir / f"{name}_inputs.npz").items()
             if k in ("patch_embeds", "mrope_pos")}
    kw = dict(batch=BATCH, prompt=prompt, gen=GEN, device="cpu", **extra)
    single = serve(cfg, params=flat, **kw)
    res = serve(cfg, params=(flat, axes), mesh=mesh, expert_parallel=ep, **kw)
    budget = serve_collective_budget(cfg, mesh, BATCH, prompt, GEN, rules=res.rules)
    whole = single.cache_bytes
    return {"logits": res.logits, "tokens": res.tokens, "single_logits": single.logits,
            "single_tokens": single.tokens, "counters_prefill": res.counters_prefill,
            "counters_steps": res.counters_steps, "budget": budget,
            "cache_bytes": res.cache_bytes, "single_cache_bytes": whole,
            "coords": mesh.coords, "mesh_ranks": mesh.ranks, "cache_pos": res.cache_pos}


def run_cases(rank: int, store: str, in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    out = {}
    try:
        for name, (_, shape, _, _, _) in CASES.items():
            mesh = make_device_mesh(shape, device="cpu")
            out[name] = run_case(name, mesh, Path(in_dir))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
