#!/usr/bin/env python3
"""The paper's Table 2 and Table 3 protocols through the port on one card.

    python3 tools/paper_tables.py [--sparse] [--din] [--device cpu]

Table 2 (``benchmarks/bench_table2.py``): rounds to reach a target train
loss for CentralSGD, FedAvg, FedProx, Scaffold, FedAdam and FedSubAvg on
``make_movielens_like(num_clients=150, num_items=120, mean_samples=30)``
(V = 1,209), K = 10; the target is CentralSGD's best loss x 1.02 over 60
rounds, ``server_lr`` 1.0 (FedAdam 0.03), the train loss read every 5
rounds. Table 3 (``bench_table3.py``): FedSubAvg at K = 5, 10 and 30 to
CentralSGD's best x 1.05. Both tables take the same CentralSGD run, which
``bench_table3.py`` repeats with the same inputs. The federated runs use the
dense plan, as ``benchmarks/common.py::rounds_to_target`` builds its
``FedConfig``; ``--sparse`` runs them on the sparse plan (K1 once per
round). ``60+`` marks a target not reached in 60 rounds.

``--din`` instead trains DIN (emb 18, hidden 36) with fedsubavg and fedavg
for 100 rounds at 2,000 users of Amazon Electronics' width (63,001 goods),
K = 100, on the sparse plan, and prints the test AUC and train loss every
20 rounds.

Each table prints ms per round (the host clock around ``run_round``, whose
loss read is a device sync; median over the run's rounds after the first)
and the card's name and power limit. ``--device cpu`` runs on the host.
"""
from __future__ import annotations

import argparse
import functools
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data.synthetic import (FederatedDataset,  # noqa: E402
                                        make_amazon_like, make_movielens_like)
from repro_torch.federated.server import FederatedTrainer  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from tools.aggregation_times import card_line  # noqa: E402

TABLE_DATA = dict(num_clients=150, num_items=120, mean_samples=30)
ALGOS = ("central", "fedavg", "fedprox", "scaffold", "fedadam", "fedsubavg")
MAX_ROUNDS = 60
TABLE3_K = (5, 10, 30)
#: DIN at Amazon Electronics' 63,001 goods, 2,000 of its 192,403 users
DIN_DATA = dict(num_clients=2000, num_items=63001, hist_len=10, mean_samples=9, seed=0)
DIN_ROUNDS = 100


def task_bindings(ds: FederatedDataset, seed: int = 0):
    """``(make_params, loss, predict)`` for the dataset's task; DIN's and the
    LSTM's random leaves are drawn on the host from ``seed``."""
    v = ds.num_features
    if ds.task == "lr":
        return (functools.partial(recsys.make_lr_params, v), recsys.lr_loss,
                lambda p, t: recsys.lr_logits(p, t["features"]))
    make, loss, predict = {
        "lstm": (recsys.make_lstm_params, recsys.lstm_loss,
                 lambda p, t: recsys.lstm_logits(p, t["tokens"],
                                                 (t["tokens"] >= 0).float())),
        "din": (recsys.make_din_params, recsys.din_loss,
                lambda p, t: recsys.din_logits(p, t["hist"], t["target"])),
    }[ds.task]

    def make_params(device):
        params, axes = make(v, device="cpu", generator=torch.Generator().manual_seed(seed))
        return {k: x.to(device) for k, x in params.items()}, axes

    return make_params, loss, predict


def rounds_to_target(ds: FederatedDataset, algorithm: str, target_loss: float,
                     max_rounds: int, fed_kw: Optional[Dict] = None,
                     eval_every: int = 5, seed: int = 0,
                     device=None) -> Tuple[int, float, float, float]:
    """``(rounds or max_rounds + 1, best train loss, wall s, ms per round)``:
    the protocol of ``benchmarks/common.py::rounds_to_target``, with the
    median host time of a round after the first beside it."""
    mk, loss_fn, predict = task_bindings(ds)
    kw = dict(num_clients=ds.num_clients, clients_per_round=10, local_iters=5,
              local_batch=5, lr=0.5, algorithm=algorithm)
    kw.update(fed_kw or {})
    tr = FederatedTrainer(ds, mk, loss_fn, FedConfig(**kw), predict_fn=predict,
                          metric="auc", rng_seed=seed, device=device, telemetry=False)
    t0 = time.perf_counter()
    best, reached, ms = float("inf"), None, []
    for r in range(max_rounds):
        t1 = time.perf_counter()
        tr.run_round()                      # reads the loss back: a sync
        ms.append((time.perf_counter() - t1) * 1e3)
        if (r + 1) % eval_every == 0:
            cur = tr.train_loss(num_batches=4, batch=256)
            best = min(best, cur)
            if cur <= target_loss and reached is None:
                reached = r + 1
                break
    wall = time.perf_counter() - t0
    round_ms = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    return (reached if reached is not None else max_rounds + 1, best, wall, round_ms)


def _rounds(r: int, max_rounds: int) -> str:
    return f"{max_rounds}+" if r > max_rounds else str(r)


def tables(sparse: bool = False, device=None) -> Dict[str, List[dict]]:
    """Table 2 and Table 3 rows: algorithm (or K), rounds to target, best
    loss and ms per round, with the targets."""
    ds = make_movielens_like(**TABLE_DATA)
    plan = {"sparse": sparse}
    _, central_best, _, central_ms = rounds_to_target(ds, "central", -1.0, MAX_ROUNDS,
                                                      device=device)
    out = {"table2": [], "table3": [], "central_best": central_best}
    out["table2"].append({"name": "central", "rounds": "-", "best": central_best,
                          "ms": central_ms})
    target2 = central_best * 1.02
    for alg in ALGOS[1:]:
        kw = {**plan, "server_lr": 0.03 if alg == "fedadam" else 1.0}
        r, best, _, ms = rounds_to_target(ds, alg, target2, MAX_ROUNDS, fed_kw=kw,
                                          device=device)
        out["table2"].append({"name": alg, "rounds": _rounds(r, MAX_ROUNDS),
                              "best": best, "ms": ms})
    target3 = central_best * 1.05
    for k in TABLE3_K:
        r, best, _, ms = rounds_to_target(ds, "fedsubavg", target3, MAX_ROUNDS,
                                          fed_kw={**plan, "clients_per_round": k},
                                          device=device)
        out["table3"].append({"name": f"K={k}", "rounds": _rounds(r, MAX_ROUNDS),
                              "best": best, "ms": ms})
    out["target2"], out["target3"] = target2, target3
    return out


def print_tables(out: Dict, sparse: bool, card: str) -> None:
    plan = "sparse" if sparse else "dense"
    for key, title, target in (("table2", "Table 2", out["target2"]),
                               ("table3", "Table 3 (fedsubavg)", out["target3"])):
        print(f"{title}, {plan} plan, V = 1,209, target {target:.4f} "
              f"(central best {out['central_best']:.4f}); {card}")
        print(f"  {'':10s} {'rounds':>7s} {'best loss':>10s} {'ms/round':>9s}")
        for row in out[key]:
            print(f"  {row['name']:10s} {row['rounds']:>7s} {row['best']:10.4f} "
                  f"{row['ms']:9.3f}")


def din_order(device=None, rounds: int = DIN_ROUNDS, eval_every: int = 20) -> Dict:
    """DIN fedsubavg and fedavg for ``rounds`` rounds at 2,000 users: test
    AUC and train loss every ``eval_every`` rounds, ms per round."""
    ds = make_amazon_like(**DIN_DATA)
    mk, loss_fn, predict = task_bindings(ds)
    out = {}
    for alg in ("fedsubavg", "fedavg"):
        cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100,
                        local_iters=5, local_batch=5, lr=0.5, algorithm=alg,
                        sparse=True, seed=0)
        tr = FederatedTrainer(ds, mk, loss_fn, cfg, predict_fn=predict, device=device,
                              telemetry=False)
        hist = tr.run(rounds, eval_every=eval_every)
        out[alg] = [(h.round, h.test_metric, h.train_loss, h.wall_time * 1e3)
                    for h in hist]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sparse", action="store_true",
                    help="federated runs on the sparse plan (default: dense)")
    ap.add_argument("--din", action="store_true",
                    help="DIN fedsubavg against fedavg, 100 rounds, 2,000 users")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("paper_tables: no CUDA device (pass --device cpu for the host)",
              file=sys.stderr)
        return 1
    card = card_line() if args.device is None else f"host ({args.device})"
    if args.din:
        for alg, rows in din_order(args.device).items():
            for rnd, auc, loss, ms in rows:
                print(f"DIN {alg:9s} round {rnd:3d}: auc={auc:.5f} "
                      f"train_loss={loss:.5f} {ms:.2f} ms/round; {card}")
        return 0
    print_tables(tables(args.sparse, args.device), args.sparse, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
