"""Server-side federated optimization algorithms.

    FedAvg     X <- X + eta * mean_i(Delta_i)
    FedSubAvg  X_m <- X_m + eta * (N / n_m) * mean_i(Delta_i,m)     (Alg. 1 l.9)
    FedProx    server-side identical to FedAvg (the prox term is local)
    Scaffold   the paper's server approximation (App. D.2, eq. 47):
               g <- (1 - K/N) g + (K/N) mean_i(Delta_i);  X <- X + eta g
    FedAdam    server Adam over the cohort mean delta (Reddi et al.)

Each is an ``(init, apply)`` pair over a flat parameter dict. ``apply``
builds new tensors; it never writes into the state it is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregate import HeatSpec, correct_update_tree

Params = Dict[str, torch.Tensor]


class ServerState(NamedTuple):
    params: Params
    opt: Any                 # scaffold: a dict like params; fedadam: (m, v) dicts
    rounds: int


@dataclass(frozen=True)
class ServerAlgorithm:
    name: str
    init: Callable[[Params], ServerState]
    apply: Callable[[ServerState, Params], ServerState]   # (state, cohort mean delta)


def _base_init(params: Params) -> ServerState:
    return ServerState(params=params, opt=(), rounds=0)


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


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
            corrected = correct_update_tree(delta, heat_spec, heat_counts, total)
            new = {k: p + corrected[k] * eta for k, p in state.params.items()}
            return ServerState(new, state.opt, state.rounds + 1)

        return ServerAlgorithm(name, _base_init, apply)

    if name == "scaffold":
        frac = cfg.clients_per_round / cfg.num_clients

        def init(params: Params) -> ServerState:
            return ServerState(params, _zeros_like(params), 0)

        def apply(state: ServerState, delta: Params) -> ServerState:
            g = {k: (1.0 - frac) * state.opt[k] + frac * delta[k] for k in delta}
            new = {k: p + g[k] * eta for k, p in state.params.items()}
            return ServerState(new, g, state.rounds + 1)

        return ServerAlgorithm(name, init, apply)

    if name == "fedadam":
        b1, b2, eps = cfg.server_beta1, cfg.server_beta2, cfg.server_eps

        def init(params: Params) -> ServerState:
            return ServerState(params, (_zeros_like(params), _zeros_like(params)), 0)

        def apply(state: ServerState, delta: Params) -> ServerState:
            m0, v0 = state.opt
            t = state.rounds + 1
            m = {k: b1 * m0[k] + (1 - b1) * d for k, d in delta.items()}
            v = {k: b2 * v0[k] + (1 - b2) * d * d for k, d in delta.items()}
            # the bias corrections in float32 from the round count, as the
            # reference computes them (``b1 ** t.astype(float32)``), on the
            # host: a device scalar would cost a copy and a sync per round
            tf, one = np.float32(t), np.float32(1.0)
            c1 = float(one / (one - np.float32(b1) ** tf))
            c2 = float(one / (one - np.float32(b2) ** tf))
            new = {k: p + eta * (m[k] * c1) / (torch.sqrt(v[k] * c2) + eps)
                   for k, p in state.params.items()}
            return ServerState(new, (m, v), t)

        return ServerAlgorithm(name, init, apply)
    raise ValueError(f"unknown server algorithm: {name!r}")
