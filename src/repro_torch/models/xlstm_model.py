"""The xLSTM language model: port of ``repro/models/xlstm_model.py``.

A pattern of mLSTM and sLSTM blocks (``models/xlstm.py``), grouped into
runs of one kind as the reference stacks them; the reference's scan over
each run becomes a Python loop over its layers. No layer launches a repo
kernel: the cells are plain PyTorch.

The parameters are a ``layers.ModelTree``: ``embedding``, per layer
``runs.{r}.{m|s}.{i}.*``, ``final_norm`` and ``lm_head``, with ``axes``. ``transformer.stack_layers``
stacks each run into the reference's ``runs.{r}.{m|s}.*`` and
``unstack_layers`` takes it back. Under installed rules the mLSTM blocks
split by whole heads and the sLSTM's projections by columns
(``xlstm.mlstm_block``'s and ``slstm_block``'s ``mesh``), and the states
are the rank's parts of the cache (``launch.shardings.cache_specs``). With remat each layer is a
``transformer._Remat``.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.layers import ParamTree


def pattern_runs(pattern) -> List[Tuple[str, int]]:
    """Consecutive blocks of one kind: ``("m", "m", "s")`` -> ``[("m", 2),
    ("s", 1)]``."""
    runs: List[Tuple[str, int]] = []
    for b in pattern:
        if runs and runs[-1][0] == b:
            runs[-1] = (b, runs[-1][1] + 1)
        else:
            runs.append((b, 1))
    return runs


def make_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, state=None) -> L.ModelTree:
    """The model's parameters on ``device`` (the card unless ``"cpu"``),
    drawn from ``generator`` (seed 0 when omitted) with the reference's
    distributions or taken from ``state`` by ``state_dict`` name, as
    ``transformer.make_params``."""
    dev = resolve_device(device)
    if generator is None and state is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    root = T._Factory(T.model_dtype(cfg), dev, generator, state)
    d = cfg.d_model
    embedding = root("embedding", (cfg.vocab_size, d), ("vocab", "embed"), init="normal")
    runs = []
    for r, (kind, n) in enumerate(pattern_runs(cfg.block_pattern)):
        make = X.make_mlstm_params if kind == "m" else X.make_slstm_params
        runs.append(ParamTree({kind: nn.ModuleList(
            [make(root.scope(f"runs.{r}.{kind}.{i}"), cfg) for i in range(n)])}))
    final_norm = T._make_rmsnorm(root, "final_norm", d)
    lm_head = root("lm_head", (d, cfg.vocab_size), ("embed", "vocab"))
    return L.ModelTree({"embedding": embedding, "runs": nn.ModuleList(runs),
                        "final_norm": final_norm, "lm_head": lm_head}, root.axes)


class XLSTMCache(NamedTuple):
    """Per m-run a stacked ``MLSTMState`` (``(n, B, ...)``), per s-run a
    stacked ``SLSTMState``; ``pos`` a host int."""

    m_states: Tuple
    s_states: Tuple
    pos: int


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> XLSTMCache:
    """All zeros, the stabilisers too, as the reference's ``init_cache``
    makes them (a prefill from it starts from m = 0, not -1e30)."""
    dev = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    h = cfg.ssm_heads
    hd_m = di // h
    d = cfg.d_model

    def mk(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    m_states, s_states = [], []
    for kind, n in pattern_runs(cfg.block_pattern):
        if kind == "m":
            m_states.append(X.MLSTMState(mk(n, batch, h, hd_m, hd_m), mk(n, batch, h, hd_m),
                                         mk(n, batch, h)))
        else:
            s_states.append(X.SLSTMState(mk(n, batch, d), mk(n, batch, d), mk(n, batch, d),
                                         mk(n, batch, d)))
    return XLSTMCache(tuple(m_states), tuple(s_states), 0)


def _block(cfg: ModelConfig, kind: str, lp, x: torch.Tensor, st=None,
           single_step: bool = False, split: T.Split = T.NO_SPLIT):
    """One layer: ``(x + block(x), the block's new state)``."""
    if kind == "m":
        h, new = X.mlstm_block(cfg, lp, L.rmsnorm(lp["norm"], x, cfg.norm_eps),
                               chunk=min(cfg.query_chunk, 256), state=st,
                               single_step=single_step, mesh=split.mlstm)
    else:
        h, new = X.slstm_block(cfg, lp, x, state=st, single_step=single_step,
                               mesh=split.slstm)
    return T.constrain(x + h, ("batch", None, None), (None, x.shape[1], cfg.d_model)), new


def _remat_layer(cfg: ModelConfig, kind: str, names: Tuple[str, ...],
                 split: T.Split = T.NO_SPLIT):
    """``_Remat``'s function of one layer of ``kind`` from the zero state;
    ``split`` taken when the layer is built, as ``transformer._layer_fn``
    takes it."""
    def run(x, positions, mrope_pos, *tensors):
        return (_block(cfg, kind, T.FlatParams(dict(zip(names, tensors))), x,
                       split=split)[0],)
    return run


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *, remat: bool = True,
            cache: Optional[XLSTMCache] = None, single_step: bool = False):
    """Forward over the module or the flat training dict. Returns (hidden,
    (new m-run states, new s-run states)), each run's a list of its layers'
    states (none under remat).
    ``cache`` gives each layer's starting state (else the zero state with
    the -1e30 stabiliser); ``remat`` (in grad mode, without a cache, not
    single-step) keeps only each layer's input for the backward. Under
    installed rules the blocks split by their inner dims
    (``transformer.model_split``) and the states are the cache's parts."""
    p = T.as_tree(params)
    split = T.model_split(cfg)
    x = T.embed_tokens(cfg, p, tokens, split=split)
    rematted = remat and not single_step and cache is None and torch.is_grad_enabled()
    new = {"m": [], "s": []}
    for r, (kind, n) in enumerate(pattern_runs(cfg.block_pattern)):
        run = p["runs"][r][kind]
        if rematted:
            layer_fn = functools.partial(_remat_layer, cfg, kind, split=split)
            for i in range(n):
                names, ts = T._layer_leaves(run[i])
                x = T._Remat.apply(layer_fn, (tuple(names),), x, None, None, *ts)[0]
            continue
        stacked = (cache.m_states if kind == "m" else cache.s_states)[len(new[kind])] \
            if cache is not None else None
        states = []
        for i in range(n):
            st = type(stacked)(*(t[i] for t in stacked)) if stacked is not None else None
            x, st = _block(cfg, kind, run[i], x, st, single_step, split)
            states.append(st)
        new[kind].append(states)
    hidden = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return hidden, (tuple(new["m"]), tuple(new["s"]))


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = True) -> torch.Tensor:
    """Causal LM loss through ``transformer.chunked_xent`` on the batch's
    ``transformer.lm_targets``."""
    tokens, targets, mask = T.lm_targets(batch)
    hidden, _ = forward(cfg, params, tokens, remat=remat)
    return T.chunked_xent(cfg, params, hidden, targets, mask, split=T.model_split(cfg))


def _write(cache: XLSTMCache, new) -> None:
    """Each layer's new state into its slice of the cache's stacked run."""
    for old_runs, new_runs in zip((cache.m_states, cache.s_states), new):
        for old, per_layer in zip(old_runs, new_runs):
            for i, st in enumerate(per_layer):
                for o, u in zip(old, st):
                    o[i].copy_(u)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache: XLSTMCache
            ) -> Tuple[torch.Tensor, XLSTMCache]:
    """Run the prompt from the cache's states, write the new ones into it
    (in place); return last-token logits (f32) and the cache at ``S``.
    Under installed rules the cache is the rank's part
    (``launch.shardings.local_cache``) before and after."""
    hidden, new = forward(cfg, params, tokens, remat=False, cache=cache)
    _write(cache, new)
    return (T._whole_logits(T.as_tree(params), hidden[:, -1], T.model_split(cfg)),
            cache._replace(pos=tokens.shape[1]))


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache: XLSTMCache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, XLSTMCache]:
    """One decode step: tokens (B,), each layer's single-step update; the
    cache updated in place; returns f32 logits and the cache at ``pos + 1``."""
    hidden, new = forward(cfg, params, tokens[:, None], remat=False, cache=cache,
                          single_step=True)
    _write(cache, new)
    return (T._whole_logits(T.as_tree(params), hidden[:, 0], T.model_split(cfg)),
            cache._replace(pos=cache.pos + 1))
