"""Server-side federated optimization algorithms.

    FedAvg     X <- X + eta * mean_i(Delta_i)
    FedSubAvg  X_m <- X_m + eta * (N / n_m) * mean_i(Delta_i,m)     (Alg. 1 l.9)
    FedProx    server-side identical to FedAvg (the prox term is local)

Each is an ``(init, apply)`` pair over a flat parameter dict. The stateful
server optimizers (scaffold, fedadam) are not ported yet (ROADMAP Queue 1,
item 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.aggregate import HeatSpec, correct_dense_leaf

Params = Dict[str, torch.Tensor]


class ServerState(NamedTuple):
    params: Params
    opt: Any                 # algorithm-specific slots (none for the ported ones)
    rounds: int


@dataclass(frozen=True)
class ServerAlgorithm:
    name: str
    init: Callable[[Params], ServerState]
    apply: Callable[[ServerState, Params], ServerState]   # (state, cohort mean delta)


def _base_init(params: Params) -> ServerState:
    return ServerState(params=params, opt=(), rounds=0)


def make_server_algorithm(cfg, heat_spec: Optional[HeatSpec] = None,
                          heat_counts: Optional[Dict[str, torch.Tensor]] = None,
                          total: Optional[float] = None) -> ServerAlgorithm:
    name = cfg.algorithm
    eta = cfg.server_lr

    if name in ("fedavg", "fedprox", "central"):

        def apply(state: ServerState, delta: Params) -> ServerState:
            new = {k: p + delta[k] * eta for k, p in state.params.items()}
            return ServerState(new, state.opt, state.rounds + 1)

        return ServerAlgorithm(name, _base_init, apply)

    if name == "fedsubavg":
        if heat_spec is None or heat_counts is None or total is None:
            raise ValueError("fedsubavg requires heat_spec, heat_counts and total N")

        def apply(state: ServerState, delta: Params) -> ServerState:
            new = {k: p + correct_dense_leaf(delta[k], heat_spec.leaf_spaces[k],
                                             heat_counts, total) * eta
                   for k, p in state.params.items()}
            return ServerState(new, state.opt, state.rounds + 1)

        return ServerAlgorithm(name, _base_init, apply)

    if name in ("scaffold", "fedadam"):
        raise NotImplementedError(
            f"server algorithm {name!r} is not ported yet (ROADMAP Queue 1, "
            "item 3): the port runs fedavg, fedprox and fedsubavg")
    raise ValueError(f"unknown server algorithm: {name!r}")
