"""Zamba2-style hybrid: port of ``repro/models/zamba.py``.

A Mamba2 backbone (``models/ssm.py``) with one *shared* attention block
applied after every ``attn_every``-th layer (the shared-transformer design
of arXiv:2411.15242): one parameter set at every site, one KV cache per
site. The block is the transformer's ``attention_block`` and gated MLP, so
its attention is K3 at prefill and in training (its gradient K3's backward)
and K4 at decode, on the card.

The parameters are a ``layers.ModelTree``: ``embedding``, ``mamba.{i}.*``
per layer, ``shared_attn.*``, ``final_norm`` and ``lm_head``, with
``axes``, so ``transformer.train_params`` and the round plans take it
unchanged. Under installed rules the Mamba2 layers split by whole SSM
heads (``ssm.mamba2_block``'s ``mesh``), the shared block as the
transformer's layers, and the KV cache by sequence as
``transformer.decode_step``'s. The reference's ``lax.scan`` over
the layers becomes a Python loop and its ``lax.cond`` on the site a Python
``if`` on the layer index. With remat each layer is a
``transformer._Remat``; a site's layer takes the shared block's tensors as
inputs of its own, so their gradient sums over the sites.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamTree


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
    q_dim, kv_dim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    embedding = root("embedding", (cfg.vocab_size, d), ("vocab", "embed"), init="normal")
    mamba = nn.ModuleList([S.make_mamba2_params(root.scope(f"mamba.{i}"), cfg)
                           for i in range(cfg.num_layers)])
    sp = root.scope("shared_attn")
    shared_attn = ParamTree({
        "norm": T._make_rmsnorm(sp, "norm", d),
        "wq": T._make_linear(sp, "wq", d, q_dim, ("embed", "heads")),
        "wk": T._make_linear(sp, "wk", d, kv_dim, ("embed", "kv")),
        "wv": T._make_linear(sp, "wv", d, kv_dim, ("embed", "kv")),
        "wo": T._make_linear(sp, "wo", q_dim, d, ("heads", "embed")),
        "ffn_norm": T._make_rmsnorm(sp, "ffn_norm", d),
        "ffn": L.make_mlp(sp.scope("ffn"), d, cfg.d_ff),
    })
    final_norm = T._make_rmsnorm(root, "final_norm", d)
    lm_head = root("lm_head", (d, cfg.vocab_size), ("embed", "vocab"))
    return L.ModelTree({"embedding": embedding, "mamba": mamba, "shared_attn": shared_attn,
                        "final_norm": final_norm, "lm_head": lm_head}, root.axes)


def num_attn_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def is_site(cfg: ModelConfig, i: int) -> bool:
    """Whether the shared block follows layer ``i``."""
    return (i + 1) % cfg.attn_every == 0


class ZambaCache(NamedTuple):
    """Per-layer SSM and conv states and per-site KV caches. ``pos``: tokens
    already written, a host int as ``layers.KVCache`` keeps it. On a mesh
    (``launch.shardings.local_cache``) a rank holds its SSM heads and conv
    channels and, where the rules split the slots, slots ``[start, start +
    S_local)`` of a KV cache of ``slots``, as ``layers.KVCache`` does."""

    ssm_state: torch.Tensor      # (L, B, H, p, n) f32
    conv_state: torch.Tensor     # (L, B, W-1, conv_dim)
    k: torch.Tensor              # (sites, B, KV, S, hd)
    v: torch.Tensor
    pos: int
    slots: int = 0
    start: int = 0

    @property
    def capacity(self) -> int:
        return self.slots or self.k.shape[3]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> ZambaCache:
    dev = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    p_dim = di // cfg.ssm_heads
    conv_dim = di + 2 * cfg.ssm_state
    dt = T.model_dtype(cfg)
    kv = (num_attn_sites(cfg), batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return ZambaCache(
        torch.zeros((cfg.num_layers, batch, cfg.ssm_heads, p_dim, cfg.ssm_state),
                    dtype=torch.float32, device=dev),
        torch.zeros((cfg.num_layers, batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dt,
                    device=dev),
        torch.zeros(kv, dtype=dt, device=dev), torch.zeros(kv, dtype=dt, device=dev), 0)


def _shared_attn_apply(cfg: ModelConfig, sp, x: torch.Tensor, positions: torch.Tensor,
                       split: T.Split = T.NO_SPLIT):
    h, kv = T.attention_block(cfg, sp, L.rmsnorm(sp["norm"], x, cfg.norm_eps), positions,
                              split=split)
    x = x + h
    x = x + L.mlp(sp["ffn"], L.rmsnorm(sp["ffn_norm"], x, cfg.norm_eps), mesh=split.ffn)
    return x, kv


def _layer(cfg: ModelConfig, mp, sp, x: torch.Tensor, positions: torch.Tensor,
           split: T.Split = T.NO_SPLIT):
    """One Mamba2 layer, then the shared block when ``sp`` is given:
    ``(x, SSDState, (k, v) or None)``."""
    h, st = S.mamba2_block(cfg, mp, L.rmsnorm(mp["norm"], x, cfg.norm_eps),
                           chunk=min(cfg.query_chunk, 256), mesh=split.ssm)
    x = T.constrain(x + h, ("batch", None, None), (None, x.shape[1], cfg.d_model))
    kv = None
    if sp is not None:
        x, kv = _shared_attn_apply(cfg, sp, x, positions, split)
    return x, st, kv


def _remat_layer(cfg: ModelConfig, names: Tuple[str, ...], split: T.Split = T.NO_SPLIT):
    """``_Remat``'s function of one layer whose tensors are named ``mamba.*``
    and, at a site, ``shared_attn.*``. ``split`` is taken when the layer is
    built, as ``transformer._layer_fn`` takes it."""
    site = any(n.startswith("shared_attn.") for n in names)

    def run(x, positions, mrope_pos, *tensors):
        p = T.FlatParams(dict(zip(names, tensors)))
        return (_layer(cfg, p["mamba"], p["shared_attn"] if site else None, x, positions,
                       split)[0],)
    return run


class ForwardOut(NamedTuple):
    hidden: torch.Tensor                   # (B, S, d) final-norm'd
    states: Optional[List[S.SSDState]]     # per layer, with ``collect_cache``
    kv: Optional[List[Tuple]]              # per site (k, v), each (B, S, KV, hd)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *, remat: bool = True,
            collect_cache: bool = False, positions: Optional[torch.Tensor] = None
            ) -> ForwardOut:
    """Full-sequence forward (train / prefill) over the module or the flat
    training dict. ``remat`` (in grad mode, without ``collect_cache``)
    keeps only each layer's input for the backward. Under installed rules
    the Mamba2 layers split by SSM heads and the shared block as the
    transformer's layers (``transformer.model_split``)."""
    p = T.as_tree(params)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    split = T.model_split(cfg)
    x = T.embed_tokens(cfg, p, tokens, split=split)
    sp = p["shared_attn"]
    states = [] if collect_cache else None
    kvs = [] if collect_cache else None
    if remat and not collect_cache and torch.is_grad_enabled():
        shared_names, shared = T._layer_leaves(sp)
        shared_names = tuple(f"shared_attn.{n}" for n in shared_names)
        layer_fn = functools.partial(_remat_layer, cfg, split=split)
        for i in range(cfg.num_layers):
            names, ts = T._layer_leaves(p["mamba"][i])
            names = tuple(f"mamba.{n}" for n in names)
            if is_site(cfg, i):
                names, ts = names + shared_names, list(ts) + list(shared)
            x = T._Remat.apply(layer_fn, (names,), x, positions, None, *ts)[0]
    else:
        for i in range(cfg.num_layers):
            x, st, kv = _layer(cfg, p["mamba"][i], sp if is_site(cfg, i) else None, x,
                               positions, split)
            if collect_cache:
                states.append(st)
                if kv is not None:
                    kvs.append(kv)
    return ForwardOut(L.rmsnorm(p["final_norm"], x, cfg.norm_eps), states, kvs)


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = True) -> torch.Tensor:
    """Causal LM loss through ``transformer.chunked_xent`` on the batch's
    ``transformer.lm_targets``."""
    tokens, targets, mask = T.lm_targets(batch)
    out = forward(cfg, params, tokens, remat=remat)
    return T.chunked_xent(cfg, params, out.hidden, targets, mask, split=T.model_split(cfg))


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache: ZambaCache
            ) -> Tuple[torch.Tensor, ZambaCache]:
    """Run the prompt; write each layer's SSM and conv states and each
    site's K and V from slot 0 into the cache (in place); return last-token
    logits (f32) and the cache at position ``S``. Under installed rules the
    rank's states are its heads' and channels' as the split computes them,
    and it keeps its slice of each site's slots (``transformer.prefill``)."""
    p = T.as_tree(params)
    split = T.model_split(cfg)
    s = tokens.shape[1]
    out = forward(cfg, params, tokens, remat=False, collect_cache=True)
    for i, st in enumerate(out.states):
        cache.ssm_state[i].copy_(st.state)
        cache.conv_state[i].copy_(st.conv)
    for j, (k, v) in enumerate(out.kv):
        T.write_prefill_kv(cache.k[j], cache.v[j], k, v, split, cache.start)
    return T._whole_logits(p, out.hidden[:, -1], split), cache._replace(pos=s)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache: ZambaCache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, ZambaCache]:
    """One decode step: tokens (B,) at position ``cache.pos``. Each layer's
    single-step Mamba2 update; at each site the token's K and V written into
    that site's cache before attending through K4. The cache is updated in
    place; returns f32 logits and the cache at ``pos + 1``. Under installed
    rules each site attends as ``transformer.decode_step`` does (K4 on the
    rank's slice of the slots, merged over ``model``)."""
    p = T.as_tree(params)
    split = T.model_split(cfg)
    seq = T._seq_mesh(cache)
    b = tokens.shape[0]
    pos = cache.pos
    dev = tokens.device
    x = T.embed_tokens(cfg, p, tokens[:, None], split=split)
    sp = p["shared_attn"]
    positions = torch.full((b, 1), pos, device=dev)
    width = cache.k.shape[3]
    slot_pos = L.cache_slot_positions(pos + 1, cache.capacity, False, dev)
    slot_pos = slot_pos[cache.start:cache.start + width].contiguous()
    for i in range(cfg.num_layers):
        mp = p["mamba"][i]
        h, st = S.mamba2_block(cfg, mp, L.rmsnorm(mp["norm"], x, cfg.norm_eps),
                               state=S.SSDState(cache.ssm_state[i], cache.conv_state[i]),
                               single_step=True, mesh=split.ssm)
        cache.ssm_state[i].copy_(st.state)
        cache.conv_state[i].copy_(st.conv)
        x = x + h
        if is_site(cfg, i):
            site = (i + 1) // cfg.attn_every - 1
            q, k, v = T._project_qkv(cfg, sp, L.rmsnorm(sp["norm"], x, cfg.norm_eps), positions,
                                     split=split)
            k, v = T.decode_kv(k[:, 0], v[:, 0], split)
            kc, vc = L.cache_write(cache.k[site], cache.v[site], pos, k, v, False, cache.slots,
                                   cache.start)
            o = T.decode_attend(q[:, 0], kc, vc, slot_pos, pos, split, seq)
            x = x + L.linear(sp["wo"], o.reshape(b, -1), reduce=split.heads,
                             tag="attn_out")[:, None]
            x = x + L.mlp(sp["ffn"], L.rmsnorm(sp["ffn_norm"], x, cfg.norm_eps),
                          mesh=split.ffn)
    hidden = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return T._whole_logits(p, hidden[:, 0], split), cache._replace(pos=pos + 1)
