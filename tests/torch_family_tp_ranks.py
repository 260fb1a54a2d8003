"""Rank processes of ``tests/test_torch_family_tp.py``: Whisper, Zamba2 and
xLSTM trained and served on a ``(data, model)`` mesh of gloo ranks.

``run_cases`` runs in each of 4 processes spawned by
``repro_torch.launch.mesh.spawn_ranks``. Case after case it lays a mesh over
the world (a ``(1, 2)`` mesh twice over, a ``(2, 2)`` or ``(1, 4)`` once).
Serving first: the tiny model of the case, from the JAX package's initial
parameters, through ``serve(mesh=...)`` (a prefill and ``GEN`` greedy
steps) and on one device, each rank's cache recorded after the prefill and
every step beside ``local_cache`` of the one-device cache. Then training:
two rounds through ``train(mesh=...)`` on the dense or the row-sparse
transport and the same on one device. For Zamba2 and xLSTM the second round of both
starts from the JAX package's parameters after its first round
(``teacher``, read from the file the JAX subprocess writes; the rank waits
for it): their gradients move far more than a round's float noise under a
last-ulp change of the parameters, so each round is held from a common
start. It saves
what it saw to ``rank{r}.pt``. This module imports torch, numpy and the
port only (no JAX), so a rank starts quickly.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.federated.plan import serve_collective_budget, tp_collective_budget
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import SCALES, default_frames, serve, serve_rules
from repro_torch.launch.shardings import (local_cache, param_specs, shard_params,
                                          unshard_params)
from repro_torch.launch.train import mesh_rules, train

WORLD = 4
ROUNDS = 2
#: the reference launcher's defaults (``repro/launch/train.py``): 128
#: clients of 4 sequences, a cohort of 8, lr 0.05, fedsubavg; sequences of
#: 32 tokens rather than 64, for time
RUN = dict(rounds=ROUNDS, clients=128, cohort=8, seq=32, lr=0.05, algorithm="fedsubavg")
BATCH, PROMPT, GEN = 4, 16, 4
#: model -> (arch, overrides of the tiny scale). Zamba2 at ``attn_every``
#: 2: at the tiny scale's 2 layers its 6 gives no attention site. xLSTM
#: with a 2-block pattern, one block of each kind: through the tiny scale's
#: 24 blocks a 1e-7 relative change of the parameters moves its gradients
#: by ~2e-3, which no 1e-5 comparison survives (through 4 blocks ~1e-5,
#: where one device's first round already parts from the JAX package's by
#: 0.9e-5 of the embedding). A 2,046-row vocabulary divides 2 model ranks
#: but not 4 (Whisper's 51,866 at full size)
MODELS = {
    "zamba": ("zamba2_1_2b", {"attn_every": 2}),
    "xlstm": ("xlstm_350m", {"block_pattern": ("m", "s")}),
    "whisper": ("whisper_large_v3", {}),
    "whisper_v2046": ("whisper_large_v3", {"vocab_size": 2046}),
}
#: the models the JAX package trains and serves (on (2, 2) and (1, 2))
JAX_MODELS = ("zamba", "xlstm", "whisper")
#: the models whose second round starts from the JAX package's first: a
#: 1e-7 relative change of Zamba2's or xLSTM's parameters moves their
#: gradients by ~1e-5 (xLSTM's 4-block pattern) or ~3e-6 (its 2 blocks,
#: Zamba2), which one round's heat-corrected update carries past 1e-5 of
#: the embedding; Whisper's two free-running rounds agree within 1e-7
TEACHER_MODELS = ("zamba", "xlstm")
#: training case -> (model, mesh shape, sparse transport)
TRAIN_CASES = {f"{m}_{s[0]}x{s[1]}_{'sparse' if sp else 'dense'}": (m, s, sp)
               for m in ("whisper", "xlstm", "zamba")
               for s in ((1, 2), (2, 2), (1, 4)) for sp in (False, True)}
TRAIN_CASES["whisper_v2046_1x4_sparse"] = ("whisper_v2046", (1, 4), True)
#: serving case -> (model, mesh shape)
SERVE_CASES = {f"{m}_{s[0]}x{s[1]}": (m, s) for m in ("zamba", "xlstm", "whisper")
               for s in ((1, 2), (1, 4))}
SERVE_CASES["whisper_v2046_1x4"] = ("whisper_v2046", (1, 4))
#: the training cases whose gathered checkpoint the JAX package loads
CKPT_CASES = {f"{m}_2x2_dense" for m in JAX_MODELS}
JAX_WAIT_S = 240.0


def tiny_config(model: str):
    arch, over = MODELS[model]
    cfg = get_config(arch)
    scale = dict(SCALES["tiny"])
    if cfg.family == "ssm":
        scale.pop("d_ff", None)
    return cfg.replace(**scale).replace(**over)


def frames_for(cfg, batch: int):
    """The reference launcher's frames of 0.02, or None for a model
    without an audio frontend."""
    return default_frames(cfg, batch) if cfg.frontend == "audio_frames" else None


def _wait_for(path: Path) -> Path:
    """``path`` once a JAX subprocess has written it (it renames a whole
    file into place)."""
    deadline = time.monotonic() + JAX_WAIT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written in {JAX_WAIT_S:.0f} s")
        time.sleep(0.2)
    return path


def _flat(model: str, in_dir: Path):
    """The JAX package's initial parameters of ``model`` as the port's flat
    training dict and its axes."""
    npz = dict(np.load(_wait_for(in_dir / f"{model}.npz")))
    return params_from_jax(npz, device="cpu", cfg=tiny_config(model), flat=True)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(t) for t in tree))
    if isinstance(tree, tuple):
        return tuple(_clone(t) for t in tree)
    return tree


def serve_case(name: str, mesh, in_dir: Path) -> dict:
    model, _ = SERVE_CASES[name]
    cfg = tiny_config(model)
    flat, axes = _flat(model, in_dir)
    rules = serve_rules(cfg, mesh)
    kw = dict(batch=BATCH, prompt=PROMPT, gen=GEN, device="cpu", frames=frames_for(cfg, BATCH))
    wants, gots = [], []
    single = serve(cfg, params=flat, on_step=lambda i, c: wants.append(
        local_cache(c, mesh, rules)), **kw)
    res = serve(cfg, params=(flat, axes), mesh=mesh, on_step=lambda i, c: gots.append(
        _clone(c)), **kw)
    budget = serve_collective_budget(cfg, mesh, BATCH, PROMPT, GEN, rules=res.rules)
    return {"logits": res.logits, "tokens": res.tokens, "single_logits": single.logits,
            "single_tokens": single.tokens, "counters_prefill": res.counters_prefill,
            "counters_steps": res.counters_steps, "budget": budget, "caches": gots,
            "want_caches": wants, "cache_bytes": res.cache_bytes,
            "single_cache_bytes": single.cache_bytes, "coords": mesh.coords,
            "mesh_ranks": mesh.ranks, "cache_pos": res.cache_pos}


def _teacher(model: str, in_dir: Path):
    """The JAX package's parameters after its first round, whole, or None
    for a model whose rounds run free (``TEACHER_MODELS``)."""
    if model not in TEACHER_MODELS:
        return None
    with open(_wait_for(in_dir / f"jax_train_{model}.pkl"), "rb") as fh:
        first = pickle.load(fh)["params"][0]
    return params_from_jax(first, device="cpu", cfg=tiny_config(model), flat=True)[0]


def _train(cfg, params, axes, sparse: bool, teacher, mesh=None, ckpt: str = ""):
    """``train`` of the case; each round's (rank's) parameters recorded,
    the second round started from ``teacher`` when given."""
    rounds: list = []
    rules = mesh_rules(cfg, mesh) if mesh is not None else None

    def on_round(r, local, metrics):
        rounds.append({n: t.clone() for n, t in local.items()})
        if r == 0 and teacher is not None:
            src = teacher if mesh is None else shard_params(teacher, axes, mesh, rules)
            for n, t in local.items():
                t.copy_(src[n])

    frames = frames_for(cfg, RUN["cohort"])
    res = train(cfg, **RUN, device="cpu", params={k: v.clone() for k, v in params.items()},
                axes=axes, sparse=sparse, mesh=mesh, log_every=0, ckpt=ckpt,
                inputs=None if frames is None else {"frames": frames}, on_round=on_round)
    return res, rounds


def train_case(name: str, mesh, in_dir: Path, out_dir: Path, single: dict) -> dict:
    model, _, sparse = TRAIN_CASES[name]
    cfg = tiny_config(model)
    params, axes = _flat(model, in_dir)
    full = {n: tuple(t.shape) for n, t in params.items()}
    teacher = _teacher(model, in_dir)
    key = (model, sparse)
    if key not in single:
        res, rounds = _train(cfg, params, axes, sparse, teacher)
        single[key] = {"losses": res.losses, "params": rounds}
    rules = mesh_rules(cfg, mesh)
    specs = param_specs(axes, full, mesh, rules)
    ckpt = str(out_dir / name) if name in CKPT_CASES else ""
    res, rounds = _train(cfg, params, axes, sparse, teacher, mesh, ckpt)
    budget = tp_collective_budget(cfg, mesh, {"tokens": torch.zeros(RUN["cohort"], RUN["seq"])},
                                  rules=res.rules, sparse=sparse)
    whole = [unshard_params(p, full, axes, mesh, rules) for p in rounds]
    back = unshard_params(shard_params(params, axes, mesh, rules), full, axes, mesh, rules)
    replicated = [{n: t for n, t in p.items() if all(s is None for s in specs[n])}
                  for p in rounds]
    return {"losses": res.losses, "single_losses": single[key]["losses"],
            "params": whole, "single_params": single[key]["params"], "local": rounds[-1],
            "replicated": replicated, "counters": res.counters, "budget": budget["axes"],
            "round_trip": all(torch.equal(back[n], params[n]) for n in params),
            "coords": mesh.coords, "mesh_ranks": mesh.ranks,
            "split_leaves": sorted(n for n, spec in specs.items() if any(spec))}


def run_cases(rank: int, store: str, in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    out = {"serve": {}, "train": {}}
    single: dict = {}
    try:
        for name, (_, shape) in SERVE_CASES.items():
            mesh = make_device_mesh(shape, device="cpu")
            out["serve"][name] = serve_case(name, mesh, Path(in_dir))
        for name, (_, shape, _) in TRAIN_CASES.items():
            mesh = make_device_mesh(shape, device="cpu")
            out["train"][name] = train_case(name, mesh, Path(in_dir), Path(out_dir), single)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
