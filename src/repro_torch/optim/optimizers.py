"""Minimal functional optimizers over parameter dicts."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]   # (grads, state, params)


def _zeros_like(tree: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """``-lr * g``, or ``-lr * m`` with ``m <- momentum * m + g``."""
    if momentum == 0.0:
        return Optimizer(init=lambda p: (),
                         update=lambda g, s, p: ({k: -lr * x for k, x in g.items()}, s))

    def update(g, s, p):
        s = {k: momentum * s[k] + x for k, x in g.items()}
        return {k: -lr * m for k, m in s.items()}, s

    return Optimizer(init=_zeros_like, update=update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction; the step count is an int32 scalar tensor
    on the parameters' device, so an update makes no host sync."""
    def init(p):
        dev = next(iter(p.values())).device
        return _zeros_like(p), _zeros_like(p), torch.zeros((), dtype=torch.int32, device=dev)

    def update(g, s, p):
        m, v, t = s
        t = t + 1
        m = {k: b1 * m[k] + (1 - b1) * x for k, x in g.items()}
        v = {k: b2 * v[k] + (1 - b2) * x * x for k, x in g.items()}
        tf = t.to(torch.float32)
        c1, c2 = 1 - torch.pow(b1, tf), 1 - torch.pow(b2, tf)
        up = {k: -lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) for k in m}
        return up, (m, v, t)

    return Optimizer(init=init, update=update)
