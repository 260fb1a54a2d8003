"""Uniform model API: port of ``repro/models/api.py`` for the serving path.

``build_model(cfg)`` returns a ``ModelApi`` whose functions have the
reference's signatures, so the serving launcher treats every ported family
the same way:

    init(generator=None, device=None)      -> parameters (a ``Transformer``)
    init_cache(batch, max_seq, device=None) -> KVCache
    prefill(params, batch, cache)          -> (logits, cache)
    decode_step(params, cache, batch)      -> (logits, cache)

Only the dense family is ported; ``loss`` (training) comes with the LLM
training slice (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 9)")

    def init(generator=None, device=None):
        return T.make_params(cfg, generator, device)

    def init_cache(batch: int, max_seq: int, device=None):
        return T.init_cache(cfg, batch, max_seq, device)

    def prefill(params, batch, cache):
        return T.prefill(cfg, params, batch["tokens"], cache)

    def decode_step(params, cache, batch):
        return T.decode_step(cfg, params, cache, batch["tokens"])

    return ModelApi(cfg=cfg, init=init, prefill=prefill, decode_step=decode_step,
                    init_cache=init_cache)
