"""Federated LLM training launcher: port of ``repro/launch/train.py`` with
the plan flags of ``examples/federated_llm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_14b \\
        --scale tiny --rounds 50 [--sparse] [--topk 256] [--int8]

builds the model of any registered architecture (the transformer's dense,
MoE and VLM families, Zamba2, xLSTM or Whisper), draws a Zipf-heat
federated corpus (``make_lm_federated``) and runs FedSGD
rounds (``FedSgdLocal``: one gradient of the cohort's pooled batch) through
``make_round_step`` on the dense transport, or on the row-sparse one with
``--sparse`` (``--topk`` and ``--int8`` imply it), with the heat read from
the batch's ``heat_vocab``. As the reference's, the batch carries no
``heat_expert``, so the experts' leaves go uncorrected, and no patch
embeddings or M-RoPE streams unless ``train``'s caller adds them
(``inputs``). Whisper's loss reads the batch's ``frames``, which the
reference's launcher does not give (it cannot train Whisper): without the
caller's, every round carries the serving launcher's frames of 0.02
(``serve.default_frames``, ``(cohort, encoder_seq, d)``). ``remat`` (on,
as the reference's ``loss_fn``) recomputes each layer in the backward.
It runs on the card unless ``--device cpu``. ``--layers`` cuts the depth;
``--smoke`` is ``examples/federated_llm.py``'s CPU-sized model and corpus.
Weights are drawn from seed 0 and the cohorts from ``default_rng(0)`` as
the reference draws them; ``--ckpt`` saves the final parameters in the
reference's npz layout (each family's layers stacked as the reference
stacks them: ``transformer.stack_layers``). ``train`` is the body, for
callers that want its numbers.

On a mesh (``train(..., mesh=...)``, or ``--model-parallel m`` under
torchrun: ``make_host_mesh(m)``, a ``(ranks / m, m)`` mesh of axes
``("data", "model")``) every family trains as the reference's
launcher trains them under ``set_rules(mesh, make_rules("train"))``: the
rules completed for the architecture (``complete_rules``), every rank draws
the full model from the seed and keeps its part (``shard_params``), the
round step splits the cohort batch over ``data`` (``CohortSharding``) and
the layers over ``model`` (``transformer.model_split``; ``--expert-parallel``
splits the experts instead of their columns; Whisper's ``frames`` split over
``data`` with the batch), and the heat is each rank's slice of
``heat_vocab``. On the row-sparse transport (``--sparse``) each
model rank gathers the union rows of its slice of the embedding, one
all-reduce over ``model`` makes the sub-table whole for the loss, and the
rank corrects and combines over ``data`` only the rows of its slice (K1 on
the slice under the ``union`` combine). ``--topk`` and ``--int8`` refuse a
mesh, as the reference's sharded step refuses them. ``--ckpt`` gathers the
parameters whole (``unshard_params``) and rank 0 writes them. One process
per rank:

    torchrun --nproc_per_node=4 -m repro_torch.launch.train --arch qwen2_5_14b \
        --scale tiny --model-parallel 2 [--expert-parallel] [--sparse]

On the card each rank takes ``cuda:LOCAL_RANK`` (NCCL); ``--device cpu``
runs gloo ranks on the host.

``--layout`` takes the reference dry run's layouts (``mesh_rules``):
``tp`` (the default, the launcher's rules), ``fsdp`` (each weight's
``d_model`` also split over ``data`` and gathered per layer; the
transformer families only) or ``auto`` (``rules.choose_layout``).
``--mesh-shape P,D,M`` lays the multi-pod ``(pod, data, model)`` mesh over
the ranks instead, the cohort split over ``("pod", "data")``. ``--ckpt``
gathers whole leaves from any of them.
"""
from __future__ import annotations

import argparse
import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import FedConfig, ModelConfig, get_config
from repro_torch.data.synthetic import make_lm_federated
from repro_torch.federated.plan import (CohortSharding, DenseTransport, FedSgdLocal,
                                        RoundPlan, RowSparseTransport, ServerUpdate,
                                        plan_comm_meta, refuse_sharded_transport)
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch.mesh import axis_key
from repro_torch.launch.serve import SCALES, default_frames, make_mesh
from repro_torch.launch.shardings import shard_batch, shard_params, unshard_params
from repro_torch.models.api import build_model
from repro_torch.models.transformer import stack_layers, train_params
from repro_torch.sharding.context import get_rules, set_rules
from repro_torch.sharding.rules import LAYOUTS, complete_rules, layout_rules, make_rules

#: examples/federated_llm.py's --smoke model (its corpus: 32 clients, 32
#: tokens, zipf 1.3, cohort 8), with Whisper's encoder cut as ``--scale
#: tiny`` cuts it (the fields touch no other family)
SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512, dtype="float32", query_chunk=64, kv_chunk=64,
             encoder_layers=2, encoder_seq=64)


@dataclass
class TrainResult:
    """What one training run did: the loss and host-clock milliseconds of
    every round (each ends in a device sync when its loss is read) and, on
    the sparse transport, each round's uplink bytes against the dense
    protocol's."""

    device: torch.device
    params: Dict[str, torch.Tensor]
    plan: str
    losses: List[float]
    ms_per_round: List[float]
    bytes_up_sparse: List[float] = field(default_factory=list)
    bytes_up_dense: List[float] = field(default_factory=list)
    #: on a mesh: the rules the run installed, and each round's collectives
    #: per axis (``DeviceMesh.counters``); ``params`` are then the rank's part
    rules: Optional[Dict] = None
    counters: List[Dict] = field(default_factory=list)
    #: on a mesh on the card: the peak device bytes from the moment the rank
    #: kept its part (the whole draw freed) to the end of the rounds
    peak_bytes: int = 0


def make_plan(algorithm: str = "fedsubavg", sparse: bool = False, topk: int = 0,
              int8: bool = False, mesh=None, shapes=None,
              batch_axes: Sequence[str] = ("data",)) -> RoundPlan:
    """``FedSgdLocal`` on the dense transport, or on the row-sparse one
    (``topk`` and ``int8`` imply it), under ``ServerUpdate(algorithm)``;
    with ``mesh``, its cohort split over the rules' ``batch_axes`` (one
    axis, or the joint ``("pod", "data")`` of the multi-pod mesh),
    ``shapes`` the parameters' global shapes."""
    sparse = sparse or topk > 0 or int8
    transport = RowSparseTransport(topk=topk, int8=int8) if sparse else DenseTransport()
    sharding = None if mesh is None else CohortSharding(
        mesh.axis(batch_axes), axis=axis_key(batch_axes), shapes=shapes)
    return RoundPlan(FedSgdLocal(), transport, ServerUpdate(algorithm), sharding=sharding)


def mesh_rules(cfg: ModelConfig, mesh, expert_parallel: bool = False,
               layout: str = "tp") -> Dict:
    """``make_rules("train")`` completed for ``cfg`` on ``mesh``'s model
    axis, as the reference's launcher and dry run install them: multi-pod
    on a mesh with a ``pod`` axis, laid out by ``layout`` (``"tp"``, the
    launcher's; ``"fsdp"``; ``"auto"``, the dry run's choice)."""
    rules = complete_rules(cfg, make_rules("train", multi_pod="pod" in mesh.axis_names,
                                           expert_parallel=expert_parallel),
                           int(mesh.shape["model"]))
    return layout_rules(cfg, rules, layout)


def train(cfg: ModelConfig, *, rounds: int = 50, clients: int = 128, cohort: int = 8,
          seq: int = 64, lr: float = 0.05, algorithm: str = "fedsubavg",
          sparse: bool = False, topk: int = 0, int8: bool = False, zipf_a: float = 1.2,
          device=None, params: Optional[Dict[str, torch.Tensor]] = None,
          axes: Optional[Dict[str, tuple]] = None, ckpt: str = "",
          log_every: int = 10, remat: bool = True,
          inputs: Optional[Mapping[str, torch.Tensor]] = None, mesh=None,
          expert_parallel: bool = False, layout: str = "tp",
          on_round: Optional[Callable[[int, Dict, Dict], None]] = None) -> TrainResult:
    """``rounds`` FedSGD rounds of ``cohort`` clients on ``clients`` clients'
    corpus of ``seq``-token sequences. ``params``/``axes`` (the flat training
    dict on ``device``; whole, also on a mesh) skip the random init.
    ``remat`` goes to ``loss_fn``; ``inputs`` are added to every round's
    cohort batch (``patch_embeds`` ``(cohort, P, d)``, ``mrope_pos`` ``(3,
    cohort, seq)``, ``frames`` ``(cohort, encoder_seq, d)``; an audio
    model's ``frames`` default to ``serve.default_frames``).

    ``mesh`` (a ``launch.mesh.DeviceMesh``, its device the run's) trains on
    it, as the module docstring says, with ``expert_parallel`` choosing the
    MoE's split and ``layout`` the rules' (``mesh_rules``); the result's
    ``params`` are the rank's part and its ``counters`` each round's
    collectives. ``on_round(r, params, metrics)``
    is called after each round."""
    rules = None
    if mesh is not None:
        rules = mesh_rules(cfg, mesh, expert_parallel, layout)
        # before the model is drawn: the reference's refusals on a mesh
        refuse_sharded_transport(make_plan(algorithm, sparse, topk, int8, mesh,
                                           batch_axes=rules["batch"]))
        device = mesh.device
    dev = resolve_device(device)
    api = build_model(cfg)
    if params is None:
        params, axes = train_params(api.init(torch.Generator(device=dev).manual_seed(0), dev))
    full_shapes = {name: tuple(t.shape) for name, t in params.items()}
    if mesh is not None:
        params = shard_params(params, axes, mesh, rules)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    ds = make_lm_federated(num_clients=clients, vocab=cfg.vocab_size, seq_len=seq,
                           samples_per_client=4, zipf_a=zipf_a)
    fed = FedConfig(num_clients=ds.num_clients, clients_per_round=cohort, lr=lr,
                    algorithm=algorithm)
    plan = make_plan(algorithm, sparse, topk, int8, mesh, full_shapes,
                     batch_axes=rules["batch"] if rules else ("data",))
    step = make_round_step(functools.partial(api.loss, remat=remat), params, axes, fed,
                           mode=plan)
    extra = {k: v.to(dev) for k, v in (inputs or {}).items()}
    if cfg.frontend == "audio_frames" and "frames" not in extra:
        extra["frames"] = default_frames(cfg, cohort).to(dev)
    heat = torch.as_tensor(ds.heat.counts, dtype=torch.float32).to(dev)
    if mesh is not None:
        heat = shard_batch({"heat_vocab": heat}, mesh, rules)["heat_vocab"]
    # the uplink is one device's: priced from the whole shapes, not the rank's
    meta = (plan_comm_meta({name: torch.empty(full_shapes[name], dtype=t.dtype, device="meta")
                            for name, t in params.items()}, axes)
            if plan.transport.sparse else None)
    tokens = ds.client_data["tokens"]
    rng = np.random.default_rng(0)
    # the result takes the parameters at the end: holding the initial ones
    # through the run would keep a second copy of the model alive
    res = TrainResult(dev, {}, plan.describe(), [], [], rules=rules)
    talk = log_every and (mesh is None or mesh.rank == mesh.ranks[0])
    installed = get_rules()
    if mesh is not None:
        set_rules(mesh, rules)
    try:
        for r in range(rounds):
            t0 = time.perf_counter()
            ids = rng.choice(ds.num_clients, size=cohort, replace=False)
            sample = rng.integers(0, tokens.shape[1], size=cohort)
            batch = {"tokens": torch.from_numpy(tokens[ids, sample]).to(dev),
                     "heat_vocab": heat, **extra}
            if mesh is not None:
                mesh.reset_counters()
            params, metrics = step(params, batch)
            res.losses.append(float(metrics["loss"]))
            res.ms_per_round.append((time.perf_counter() - t0) * 1e3)
            if mesh is not None:
                res.counters.append(mesh.counters)
            if on_round is not None:
                on_round(r, params, metrics)
            if meta is not None:
                stats = plan.transport.round_comm(
                    r, meta, np.asarray([int(metrics["sub_rows"])]), cfg.vocab_size)
                res.bytes_up_sparse.append(stats.bytes_up_sparse)
                res.bytes_up_dense.append(stats.bytes_up_dense)
            if talk and ((r + 1) % log_every == 0 or r + 1 == rounds):
                line = (f"round {r + 1:4d} loss={res.losses[-1]:.4f} "
                        f"{res.ms_per_round[-1]:.1f} ms")
                if meta is not None:
                    line += f" density={float(metrics['density']):.3f}"
                print(line, flush=True)
    finally:
        set_rules(*installed)
    res.params = params
    if mesh is not None and dev.type == "cuda":
        res.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if ckpt:
        whole = params if mesh is None else unshard_params(params, full_shapes, axes, mesh,
                                                           rules)
        if mesh is None or mesh.rank == 0:
            stacked, stacked_axes = stack_layers(whole, axes)
            save_checkpoint(ckpt, stacked, step=rounds, axes=stacked_axes,
                            extra={"arch": cfg.name, "algorithm": algorithm})
        del whole
    return res


def main(argv: Optional[List[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_14b")
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--smoke", action="store_true",
                    help="examples/federated_llm.py's tiny model and corpus")
    ap.add_argument("--sparse", action="store_true",
                    help="row-sparse submodel transport (gather before backward)")
    ap.add_argument("--topk", type=int, default=0, help="top-k delta rows (implies --sparse)")
    ap.add_argument("--int8", action="store_true", help="int8 rows (implies --sparse)")
    ap.add_argument("--algorithm", default="fedsubavg", choices=["fedsubavg", "fedavg"])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=128)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--ckpt", default="", help="checkpoint path (without .npz)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted (raises without one)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="split the layers over this many ranks of a (data, model) mesh "
                         "over torchrun's ranks")
    ap.add_argument("--mesh-shape", default="",
                    help="the mesh over torchrun's ranks instead: 'D,M' for (data, model), "
                         "'P,D,M' for the multi-pod (pod, data, model)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="on the mesh, split the MoE's experts rather than their columns")
    ap.add_argument("--layout", default="tp", choices=LAYOUTS,
                    help="on the mesh: tp (weights resident on their model ranks), fsdp "
                         "(each weight's d_model also split over data, gathered per layer) "
                         "or auto (the dry run's choice by size)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    clients, cohort, seq, zipf_a = args.clients, args.cohort, args.seq, 1.2
    if args.smoke:
        cfg = cfg.replace(**SMOKE)
        clients, cohort, seq, zipf_a = 32, 8, 32, 1.3
    elif SCALES[args.scale]:
        cfg = cfg.replace(**SCALES[args.scale])
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    mesh = make_mesh(args.model_parallel, args.mesh_shape, args.device)
    try:
        res = train(cfg, rounds=args.rounds, clients=clients, cohort=cohort, seq=seq,
                    lr=args.lr, algorithm=args.algorithm, sparse=args.sparse,
                    topk=args.topk, int8=args.int8, zipf_a=zipf_a, device=args.device,
                    ckpt=args.ckpt, mesh=mesh, expert_parallel=args.expert_parallel,
                    layout=args.layout)
    finally:
        if mesh is not None:
            mesh.destroy()
    if mesh is not None and mesh.rank != 0:
        return res
    n = sum(p.numel() for p in res.params.values())
    where = "" if mesh is None else f" (rank 0's part) mesh={mesh.shape} layout={args.layout}"
    print(f"arch={cfg.name} layers={cfg.num_layers} params={n / 1e6:.1f}M{where} "
          f"device={res.device} plan: {res.plan}")
    steady = res.ms_per_round[1:] or res.ms_per_round
    print(f"{len(res.losses)} rounds: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"{float(np.median(steady)):.1f} ms/round (median after the first)")
    if res.bytes_up_sparse:
        print(f"uplink (last round, cohort as one union): {res.bytes_up_sparse[-1] / 1e6:.2f} "
              f"MB sparse vs {res.bytes_up_dense[-1] / 1e6:.2f} MB dense")
    if args.ckpt:
        print(f"checkpoint: {args.ckpt}.npz")
    return res


if __name__ == "__main__":
    main()
