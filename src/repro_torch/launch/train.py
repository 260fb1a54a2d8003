"""Federated LLM training launcher: port of ``repro/launch/train.py`` with
the plan flags of ``examples/federated_llm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_14b \\
        --scale tiny --rounds 50 [--sparse] [--topk 256] [--int8]

builds a dense transformer, draws a Zipf-heat federated corpus
(``make_lm_federated``) and runs FedSGD rounds (``FedSgdLocal``: one
gradient of the cohort's pooled batch) through ``make_round_step`` on the
dense transport, or on the row-sparse one with ``--sparse`` (``--topk`` and
``--int8`` imply it), with the heat read from the batch's ``heat_vocab``.
It runs on the card unless ``--device cpu``. ``--layers`` cuts the depth;
``--smoke`` is ``examples/federated_llm.py``'s CPU-sized model and corpus.
Weights are drawn from seed 0 and the cohorts from ``default_rng(0)`` as
the reference draws them; ``--ckpt`` saves the final parameters in the
reference's npz layout. The sharded LLM step (``jax.sharding`` rules in the
reference) is not ported. ``train`` is the body, for callers that want its
numbers.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import FedConfig, ModelConfig, get_config
from repro_torch.data.synthetic import make_lm_federated
from repro_torch.federated.plan import (DenseTransport, FedSgdLocal, RoundPlan,
                                        RowSparseTransport, ServerUpdate, plan_comm_meta)
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch.serve import SCALES
from repro_torch.models.api import build_model
from repro_torch.models.transformer import stack_layers, train_params

#: examples/federated_llm.py's --smoke model (its corpus: 32 clients, 32
#: tokens, zipf 1.3, cohort 8)
SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512, dtype="float32", query_chunk=64, kv_chunk=64)


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


def make_plan(algorithm: str = "fedsubavg", sparse: bool = False, topk: int = 0,
              int8: bool = False) -> RoundPlan:
    """``FedSgdLocal`` on the dense transport, or on the row-sparse one
    (``topk`` and ``int8`` imply it), under ``ServerUpdate(algorithm)``."""
    sparse = sparse or topk > 0 or int8
    transport = RowSparseTransport(topk=topk, int8=int8) if sparse else DenseTransport()
    return RoundPlan(FedSgdLocal(), transport, ServerUpdate(algorithm))


def train(cfg: ModelConfig, *, rounds: int = 50, clients: int = 128, cohort: int = 8,
          seq: int = 64, lr: float = 0.05, algorithm: str = "fedsubavg",
          sparse: bool = False, topk: int = 0, int8: bool = False, zipf_a: float = 1.2,
          device=None, params: Optional[Dict[str, torch.Tensor]] = None,
          axes: Optional[Dict[str, tuple]] = None, ckpt: str = "",
          log_every: int = 10) -> TrainResult:
    """``rounds`` FedSGD rounds of ``cohort`` clients on ``clients`` clients'
    corpus of ``seq``-token sequences. ``params``/``axes`` (the flat training
    dict on ``device``) skip the random init."""
    dev = resolve_device(device)
    api = build_model(cfg)
    if params is None:
        params, axes = train_params(api.init(torch.Generator(device=dev).manual_seed(0), dev))
    ds = make_lm_federated(num_clients=clients, vocab=cfg.vocab_size, seq_len=seq,
                           samples_per_client=4, zipf_a=zipf_a)
    fed = FedConfig(num_clients=ds.num_clients, clients_per_round=cohort, lr=lr,
                    algorithm=algorithm)
    plan = make_plan(algorithm, sparse, topk, int8)
    step = make_round_step(api.loss, params, axes, fed, mode=plan)
    heat = torch.as_tensor(ds.heat.counts, dtype=torch.float32).to(dev)
    meta = plan_comm_meta(params, axes) if plan.transport.sparse else None
    tokens = ds.client_data["tokens"]
    rng = np.random.default_rng(0)
    # the result takes the parameters at the end: holding the initial ones
    # through the run would keep a second copy of the model alive
    res = TrainResult(dev, {}, plan.describe(), [], [])
    for r in range(rounds):
        t0 = time.perf_counter()
        ids = rng.choice(ds.num_clients, size=cohort, replace=False)
        sample = rng.integers(0, tokens.shape[1], size=cohort)
        batch = {"tokens": torch.from_numpy(tokens[ids, sample]).to(dev),
                 "heat_vocab": heat}
        params, metrics = step(params, batch)
        res.losses.append(float(metrics["loss"]))
        res.ms_per_round.append((time.perf_counter() - t0) * 1e3)
        if meta is not None:
            stats = plan.transport.round_comm(r, meta, np.asarray([int(metrics["sub_rows"])]),
                                              cfg.vocab_size)
            res.bytes_up_sparse.append(stats.bytes_up_sparse)
            res.bytes_up_dense.append(stats.bytes_up_dense)
        if log_every and ((r + 1) % log_every == 0 or r + 1 == rounds):
            line = (f"round {r + 1:4d} loss={res.losses[-1]:.4f} "
                    f"{res.ms_per_round[-1]:.1f} ms")
            if meta is not None:
                line += f" density={float(metrics['density']):.3f}"
            print(line, flush=True)
    res.params = params
    if ckpt:
        stacked, stacked_axes = stack_layers(params, axes)
        save_checkpoint(ckpt, stacked, step=rounds, axes=stacked_axes,
                        extra={"arch": cfg.name, "algorithm": algorithm})
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
    res = train(cfg, rounds=args.rounds, clients=clients, cohort=cohort, seq=seq,
                lr=args.lr, algorithm=args.algorithm, sparse=args.sparse, topk=args.topk,
                int8=args.int8, zipf_a=zipf_a, device=args.device, ckpt=args.ckpt)
    n = sum(p.numel() for p in res.params.values())
    print(f"arch={cfg.name} layers={cfg.num_layers} params={n / 1e6:.1f}M "
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
