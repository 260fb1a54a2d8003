"""Whisper-style encoder-decoder (transformer backbone only): port of
``repro/models/whisper.py``.

The mel/conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``(B, encoder_seq, d)``. The encoder is
non-causal self-attention over the frames plus the sinusoidal table; the
decoder is causal self-attention over the tokens, cross-attention to the
encoder's output, and the gated MLP. Every attention goes through
``layers.mea_attention``, so K3 on the card (non-causal over the frames and
against them), its gradient K3's backward; decode attends through K4, to
its own growing cache and to the cross-attention cache of the frames,
written once at prefill. As the reference's, the MLP is gated (``wi``,
``wg``, ``wo``) and the decoder's positions are sinusoidal, where OpenAI's
Whisper has a plain MLP and learned positions.

The parameters are a ``layers.ModelTree``: ``encoder.{i}.*``,
``encoder_norm``, ``decoder.{i}.*``, ``embedding``, ``final_norm`` and
``lm_head``, with ``axes``, so ``transformer.train_params`` and the round
plans take it unchanged. The reference's ``lax.scan`` over each stack
becomes a Python loop. Remat: the reference always checkpoints each encoder
layer and each decoder layer under ``remat``; both are
``transformer._Remat`` here. A decoder layer takes the encoder's output as
one of its tensors, so that its gradient, summed over the decoder's
layers, reaches the encoder through cross-attention. Under installed rules
every attention and MLP splits as the transformer's, and serving splits
both caches by sequence: K4's log-sum-exp instance runs on the rank's
slice of each and the ranks' partials are merged.
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
from repro_torch.models.layers import ParamTree
from repro_torch.sharding.context import get_rules
from repro_torch.sharding.parallel import copy_to_model

#: the name under which a decoder layer's ``_Remat`` takes the encoder's output
ENC_OUT = "enc_out"


def _attn_params(pf: T._Factory, d: int, q_dim: int, kv_dim: int) -> ParamTree:
    # biases on wq, wv and wo, none on wk, as the reference's
    return ParamTree({
        "norm": T._make_rmsnorm(pf, "norm", d),
        "wq": T._make_linear(pf, "wq", d, q_dim, ("embed", "heads"), bias=True),
        "wk": T._make_linear(pf, "wk", d, kv_dim, ("embed", "kv")),
        "wv": T._make_linear(pf, "wv", d, kv_dim, ("embed", "kv"), bias=True),
        "wo": T._make_linear(pf, "wo", q_dim, d, ("heads", "embed"), bias=True),
    })


def make_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, state=None) -> L.ModelTree:
    """The model's parameters on ``device`` (the card unless ``"cpu"``),
    drawn from ``generator`` (seed 0 when omitted) with the reference's
    distributions or taken from ``state`` by ``state_dict`` name, as
    ``transformer.make_params``. Norm scales are f32 in any model dtype."""
    dev = resolve_device(device)
    if generator is None and state is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    root = T._Factory(T.model_dtype(cfg), dev, generator, state)
    d = cfg.d_model
    q_dim, kv_dim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def encoder_layer(pf):
        return ParamTree({"attn": _attn_params(pf.scope("attn"), d, q_dim, kv_dim),
                          "ffn_norm": T._make_rmsnorm(pf, "ffn_norm", d),
                          "ffn": L.make_mlp(pf.scope("ffn"), d, cfg.d_ff)})

    def decoder_layer(pf):
        return ParamTree({"self_attn": _attn_params(pf.scope("self_attn"), d, q_dim, kv_dim),
                          "cross_attn": _attn_params(pf.scope("cross_attn"), d, q_dim, kv_dim),
                          "ffn_norm": T._make_rmsnorm(pf, "ffn_norm", d),
                          "ffn": L.make_mlp(pf.scope("ffn"), d, cfg.d_ff)})

    encoder = nn.ModuleList([encoder_layer(root.scope(f"encoder.{i}"))
                             for i in range(cfg.encoder_layers)])
    encoder_norm = T._make_rmsnorm(root, "encoder_norm", d)
    decoder = nn.ModuleList([decoder_layer(root.scope(f"decoder.{i}"))
                             for i in range(cfg.num_layers)])
    embedding = root("embedding", (cfg.vocab_size, d), ("vocab", "embed"), init="normal")
    final_norm = T._make_rmsnorm(root, "final_norm", d)
    lm_head = root("lm_head", (d, cfg.vocab_size), ("embed", "vocab"))
    return L.ModelTree({"encoder": encoder, "encoder_norm": encoder_norm, "decoder": decoder,
                        "embedding": embedding, "final_norm": final_norm,
                        "lm_head": lm_head}, root.axes)


def _mha(cfg: ModelConfig, ap, xq: torch.Tensor, xkv: torch.Tensor, *, causal: bool,
         split: T.Split = T.NO_SPLIT):
    """Attention of ``xq`` to ``xkv`` through ``mea_attention``: (out, (k, v)).

    Split (``split.heads``), as ``transformer.attention_block``: the rank
    projects its query heads (and its KV heads, or all of them where the KV
    heads are whole: their weights and biases then take ``copy_to_model``),
    attends with them through K3, and ``wo``'s row-parallel partial products
    are summed before its bias. The inputs' gradients are summed over the
    ranks: ``attn_in`` for the queries' input (and the keys' in
    self-attention), ``cross_in`` for the encoder's output."""
    b, sq = xq.shape[:2]
    skv = xkv.shape[1]
    mesh = split.heads
    hl, kvl, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wk, wv = ap["wk"], ap["wv"]
    if mesh is not None:
        same = xkv is xq
        xq = copy_to_model(xq, mesh, "attn_in")
        xkv = xq if same else copy_to_model(xkv, mesh, "cross_in")
        hl //= mesh.size
        if split.kv is not None:
            kvl //= mesh.size
        else:
            wk, wv = T._copied(wk, mesh, "attn_kv"), T._copied(wv, mesh, "attn_kv")
    q = L.linear(ap["wq"], xq).reshape(b, sq, hl, hd)
    k = L.linear(wk, xkv).reshape(b, skv, kvl, hd)
    v = L.linear(wv, xkv).reshape(b, skv, kvl, hd)
    T.constrain(q, ("batch", None, "heads_act", None), (None, sq, cfg.num_heads, hd))
    T.constrain(k, ("batch", None, "kv_act", None), (None, skv, cfg.num_kv_heads, hd))
    T.constrain(v, ("batch", None, "kv_act", None), (None, skv, cfg.num_kv_heads, hd))
    ka, va = k, v
    if mesh is not None and split.kv is None:
        ka, va = T._rank_kv(cfg, k, v, mesh.rank, hl)
    o = L.mea_attention(q, ka, va, causal=causal, query_chunk=cfg.query_chunk,
                        kv_chunk=cfg.kv_chunk)
    return L.linear(ap["wo"], o.reshape(b, sq, hl * hd), reduce=mesh, tag="attn_out"), (k, v)


def _encoder_layer(cfg: ModelConfig, lp, x: torch.Tensor, split: T.Split = T.NO_SPLIT
                   ) -> torch.Tensor:
    h = L.rmsnorm(lp["attn"]["norm"], x, cfg.norm_eps)
    x = x + _mha(cfg, lp["attn"], h, h, causal=False, split=split)[0]
    x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps), mesh=split.ffn)
    return T.constrain(x, ("batch", None, None), (None, x.shape[1], cfg.d_model))


def _decoder_layer(cfg: ModelConfig, lp, x: torch.Tensor, enc_out: torch.Tensor,
                   split: T.Split = T.NO_SPLIT):
    """One decoder layer: ``(x, self-attention (k, v), cross-attention (k, v))``."""
    sa, ca = lp["self_attn"], lp["cross_attn"]
    h = L.rmsnorm(sa["norm"], x, cfg.norm_eps)
    o, self_kv = _mha(cfg, sa, h, h, causal=True, split=split)
    x = x + o
    o, cross_kv = _mha(cfg, ca, L.rmsnorm(ca["norm"], x, cfg.norm_eps), enc_out, causal=False,
                       split=split)
    x = x + o
    x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps), mesh=split.ffn)
    return T.constrain(x, ("batch", None, None), (None, x.shape[1], cfg.d_model)), \
        self_kv, cross_kv


def _remat_encoder_layer(cfg: ModelConfig, names: Tuple[str, ...],
                         split: T.Split = T.NO_SPLIT):
    def run(x, positions, mrope_pos, *tensors):
        return (_encoder_layer(cfg, T.FlatParams(dict(zip(names, tensors))), x, split),)
    return run


def _remat_decoder_layer(cfg: ModelConfig, names: Tuple[str, ...],
                         split: T.Split = T.NO_SPLIT):
    """A decoder layer's tensors, the encoder's output last (``ENC_OUT``)."""
    def run(x, positions, mrope_pos, *tensors):
        p = T.FlatParams(dict(zip(names, tensors)))
        return (_decoder_layer(cfg, p, x, p[ENC_OUT], split)[0],)
    return run


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames ``(B, S, d)`` precomputed frame embeddings (the frontend
    stub) -> the encoder's final-norm'd output ``(B, S, d)``. In grad mode
    each layer keeps only its input for the backward (the reference's
    ``jax.checkpoint``, always on). Under installed rules each layer splits
    as the transformer's (``transformer.model_split``): the rank's query
    heads through K3, the MLP's columns then rows."""
    p = T.as_tree(params)
    s, d = frames.shape[1:]
    dt = T.model_dtype(cfg)
    split = T.model_split(cfg)
    x = frames.to(dt) + L.sinusoidal_positions(s, d, frames.device).to(dt)
    x = T.constrain(x, ("batch", None, None), (None, s, d))
    remat = torch.is_grad_enabled()
    layer_fn = functools.partial(_remat_encoder_layer, cfg, split=split)
    for i in range(cfg.encoder_layers):
        lp = p["encoder"][i]
        if remat:
            names, ts = T._layer_leaves(lp)
            x = T._Remat.apply(layer_fn, (tuple(names),), x, None, None, *ts)[0]
        else:
            x = _encoder_layer(cfg, lp, x, split)
    return L.rmsnorm(p["encoder_norm"], x, cfg.norm_eps)


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 remat: bool = True, collect_kv: bool = False
                 ) -> Tuple[torch.Tensor, Optional[List[Tuple]]]:
    """The decoder over whole sequences (train / prefill): final-norm'd
    hidden states ``(B, S, d)`` and, with ``collect_kv``, each layer's
    ``((k, v) self, (k, v) cross)``, each ``(B, S, KV, hd)`` (the rank's KV
    heads under installed rules). ``remat`` (in grad mode, without
    ``collect_kv``) keeps only each layer's input and the encoder's output
    for the backward."""
    p = T.as_tree(params)
    s = tokens.shape[1]
    split = T.model_split(cfg)
    x = T.embed_tokens(cfg, p, tokens, split=split)
    x = x + L.sinusoidal_positions(s, cfg.d_model, tokens.device).to(x.dtype)
    kvs = [] if collect_kv else None
    if remat and not collect_kv and torch.is_grad_enabled():
        layer_fn = functools.partial(_remat_decoder_layer, cfg, split=split)
        for i in range(cfg.num_layers):
            names, ts = T._layer_leaves(p["decoder"][i])
            x = T._Remat.apply(layer_fn, (tuple(names) + (ENC_OUT,),), x, None, None, *ts,
                               enc_out)[0]
    else:
        for i in range(cfg.num_layers):
            x, self_kv, cross_kv = _decoder_layer(cfg, p["decoder"][i], x, enc_out, split)
            if collect_kv:
                kvs.append((self_kv, cross_kv))
    return L.rmsnorm(p["final_norm"], x, cfg.norm_eps), kvs


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = True) -> torch.Tensor:
    """Next-token loss of the decoder on the batch's ``frames``, through
    ``transformer.chunked_xent`` on ``transformer.lm_targets``."""
    tokens, targets, mask = T.lm_targets(batch)
    enc_out = encode(cfg, params, batch["frames"])
    hidden, _ = decode_train(cfg, params, tokens, enc_out, remat=remat)
    return T.chunked_xent(cfg, params, hidden, targets, mask, split=T.model_split(cfg))


class WhisperCache(NamedTuple):
    """The decoder's self-attention cache and the cross-attention cache of
    the frames (written at prefill, read by every step). ``pos``: tokens
    already written, a host int as ``layers.KVCache`` keeps it. On a mesh
    (``launch.shardings.local_cache``) a rank holds, where the rules split
    them, slots ``[start, start + S_local)`` of a self-attention cache of
    ``slots`` (as ``layers.KVCache``) and its block of the frames' slots."""

    k: torch.Tensor              # (L, B, KV, S, hd)
    v: torch.Tensor
    ck: torch.Tensor             # (L, B, KV, encoder_seq, hd)
    cv: torch.Tensor
    pos: int
    slots: int = 0
    start: int = 0

    @property
    def capacity(self) -> int:
        return self.slots or self.k.shape[3]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> WhisperCache:
    dev = resolve_device(device)
    dt = T.model_dtype(cfg)
    s_shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    c_shape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)
    return WhisperCache(*(torch.zeros(shape, dtype=dt, device=dev)
                          for shape in (s_shape, s_shape, c_shape, c_shape)), 0)


def _cross_mesh(cfg: ModelConfig, cache: WhisperCache):
    """The model axis's mesh when the cross-attention cache is this rank's
    block of the ``encoder_seq`` frames' slots, else None."""
    width = cache.ck.shape[3]
    if width == cfg.encoder_seq:
        return None
    mesh = get_rules()[0]
    if mesh is None or width * int(mesh.shape["model"]) != cfg.encoder_seq:
        raise ValueError(f"a cross-attention cache of {width} of {cfg.encoder_seq} frames "
                         f"on mesh {None if mesh is None else dict(mesh.shape)}")
    return mesh.axis("model")


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, frames: torch.Tensor,
            cache: WhisperCache) -> Tuple[torch.Tensor, WhisperCache]:
    """Encode the frames, run the prompt, write each layer's self-attention
    K and V from slot 0 and its cross-attention K and V of the frames into
    the cache (in place); return last-token logits (f32) and the cache at
    position ``S``. Under installed rules the rank encodes and decodes on its
    heads, gathers the KV heads where they are split (``prefill_kv``), and
    keeps its slices of both caches' slots."""
    p = T.as_tree(params)
    split = T.model_split(cfg)
    cross = _cross_mesh(cfg, cache)
    cw = cache.ck.shape[3]
    if frames.shape[1] != cw * (cross.size if cross is not None else 1):
        raise ValueError(f"whisper.prefill: {frames.shape[1]} frames for a cross-attention "
                         f"cache of {cfg.encoder_seq}")
    s = tokens.shape[1]
    enc_out = encode(cfg, params, frames)
    hidden, kvs = decode_train(cfg, params, tokens, enc_out, remat=False, collect_kv=True)
    c0 = cross.rank * cw if cross is not None else 0
    for i, ((k, v), (ck, cv)) in enumerate(kvs):
        T.write_prefill_kv(cache.k[i], cache.v[i], k, v, split, cache.start)
        T.write_prefill_kv(cache.ck[i], cache.cv[i], ck, cv, split, c0)
    return T._whole_logits(p, hidden[:, -1], split), cache._replace(pos=s)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache: WhisperCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, WhisperCache]:
    """One decode step: tokens (B,) at position ``cache.pos``, plus the
    sinusoid's row ``pos``. Each layer writes the token's K and V into its
    self-attention cache before attending to it through K4, then attends
    through K4 to the frames' cache, every slot valid. The cache is updated
    in place; returns f32 logits and the cache at ``pos + 1``. Under
    installed rules both attentions run as ``transformer.decode_step``'s:
    q gathered over ``model``, K4 on every head against the rank's slice of
    the slots, the partials merged by their log-sum-exp, the rank's heads
    into ``wo``."""
    p = T.as_tree(params)
    split = T.model_split(cfg)
    seq, cross = T._seq_mesh(cache), _cross_mesh(cfg, cache)
    b = tokens.shape[0]
    pos = cache.pos
    dev = tokens.device
    hd = cfg.head_dim
    x = T.embed_tokens(cfg, p, tokens[:, None], split=split)
    x = x + L.sinusoidal_positions(cache.capacity, cfg.d_model, dev)[pos:pos + 1].to(x.dtype)
    width = cache.k.shape[3]
    slot_pos = L.cache_slot_positions(pos + 1, cache.capacity, False, dev)
    slot_pos = slot_pos[cache.start:cache.start + width].contiguous()
    enc_len = cache.ck.shape[3]
    enc_pos = torch.arange(enc_len, dtype=torch.int32, device=dev)
    for i in range(cfg.num_layers):
        lp = p["decoder"][i]
        sa, ca = lp["self_attn"], lp["cross_attn"]
        h = L.rmsnorm(sa["norm"], x, cfg.norm_eps)[:, 0]
        q = L.linear(sa["wq"], h).reshape(b, -1, hd)
        k = L.linear(sa["wk"], h).reshape(b, -1, hd)
        v = L.linear(sa["wv"], h).reshape(b, -1, hd)
        k, v = T.decode_kv(k, v, split)
        kc, vc = L.cache_write(cache.k[i], cache.v[i], pos, k, v, False, cache.slots,
                               cache.start)
        o = T.decode_attend(q, kc, vc, slot_pos, pos, split, seq)
        x = x + L.linear(sa["wo"], o.reshape(b, -1), reduce=split.heads,
                         tag="attn_out")[:, None]
        q = L.linear(ca["wq"], L.rmsnorm(ca["norm"], x, cfg.norm_eps)[:, 0]).reshape(b, -1, hd)
        o = T.decode_attend(q, cache.ck[i], cache.cv[i], enc_pos, enc_len, split, cross)
        x = x + L.linear(ca["wo"], o.reshape(b, -1), reduce=split.heads,
                         tag="attn_out")[:, None]
        x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps), mesh=split.ffn)
    hidden = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return T._whole_logits(p, hidden[:, 0], split), cache._replace(pos=pos + 1)
