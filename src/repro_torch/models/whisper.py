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
layers, reaches the encoder through cross-attention.
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


def _mha(cfg: ModelConfig, ap, xq: torch.Tensor, xkv: torch.Tensor, *, causal: bool):
    """Attention of ``xq`` to ``xkv`` through ``mea_attention``: (out, (k, v))."""
    b, sq = xq.shape[:2]
    skv = xkv.shape[1]
    q = L.linear(ap["wq"], xq).reshape(b, sq, cfg.num_heads, cfg.head_dim)
    k = L.linear(ap["wk"], xkv).reshape(b, skv, cfg.num_kv_heads, cfg.head_dim)
    v = L.linear(ap["wv"], xkv).reshape(b, skv, cfg.num_kv_heads, cfg.head_dim)
    o = L.mea_attention(q, k, v, causal=causal, query_chunk=cfg.query_chunk,
                        kv_chunk=cfg.kv_chunk)
    return L.linear(ap["wo"], o.reshape(b, sq, -1)), (k, v)


def _encoder_layer(cfg: ModelConfig, lp, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(lp["attn"]["norm"], x, cfg.norm_eps)
    x = x + _mha(cfg, lp["attn"], h, h, causal=False)[0]
    return x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))


def _decoder_layer(cfg: ModelConfig, lp, x: torch.Tensor, enc_out: torch.Tensor):
    """One decoder layer: ``(x, self-attention (k, v), cross-attention (k, v))``."""
    sa, ca = lp["self_attn"], lp["cross_attn"]
    h = L.rmsnorm(sa["norm"], x, cfg.norm_eps)
    o, self_kv = _mha(cfg, sa, h, h, causal=True)
    x = x + o
    o, cross_kv = _mha(cfg, ca, L.rmsnorm(ca["norm"], x, cfg.norm_eps), enc_out, causal=False)
    x = x + o
    x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))
    return x, self_kv, cross_kv


def _remat_encoder_layer(cfg: ModelConfig, names: Tuple[str, ...]):
    def run(x, positions, mrope_pos, *tensors):
        return (_encoder_layer(cfg, T.FlatParams(dict(zip(names, tensors))), x),)
    return run


def _remat_decoder_layer(cfg: ModelConfig, names: Tuple[str, ...]):
    """A decoder layer's tensors, the encoder's output last (``ENC_OUT``)."""
    def run(x, positions, mrope_pos, *tensors):
        p = T.FlatParams(dict(zip(names, tensors)))
        return (_decoder_layer(cfg, p, x, p[ENC_OUT])[0],)
    return run


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames ``(B, S, d)`` precomputed frame embeddings (the frontend
    stub) -> the encoder's final-norm'd output ``(B, S, d)``. In grad mode
    each layer keeps only its input for the backward (the reference's
    ``jax.checkpoint``, always on)."""
    p = T.as_tree(params)
    s, d = frames.shape[1:]
    dt = T.model_dtype(cfg)
    x = frames.to(dt) + L.sinusoidal_positions(s, d, frames.device).to(dt)
    remat = torch.is_grad_enabled()
    layer_fn = functools.partial(_remat_encoder_layer, cfg)
    for i in range(cfg.encoder_layers):
        lp = p["encoder"][i]
        if remat:
            names, ts = T._layer_leaves(lp)
            x = T._Remat.apply(layer_fn, (tuple(names),), x, None, None, *ts)[0]
        else:
            x = _encoder_layer(cfg, lp, x)
    return L.rmsnorm(p["encoder_norm"], x, cfg.norm_eps)


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 remat: bool = True, collect_kv: bool = False
                 ) -> Tuple[torch.Tensor, Optional[List[Tuple]]]:
    """The decoder over whole sequences (train / prefill): final-norm'd
    hidden states ``(B, S, d)`` and, with ``collect_kv``, each layer's
    ``((k, v) self, (k, v) cross)``, each ``(B, S, KV, hd)``. ``remat`` (in
    grad mode, without ``collect_kv``) keeps only each layer's input and
    the encoder's output for the backward."""
    p = T.as_tree(params)
    s = tokens.shape[1]
    x = T.embed_tokens(cfg, p, tokens)
    x = x + L.sinusoidal_positions(s, cfg.d_model, tokens.device).to(x.dtype)
    kvs = [] if collect_kv else None
    if remat and not collect_kv and torch.is_grad_enabled():
        layer_fn = functools.partial(_remat_decoder_layer, cfg)
        for i in range(cfg.num_layers):
            names, ts = T._layer_leaves(p["decoder"][i])
            x = T._Remat.apply(layer_fn, (tuple(names) + (ENC_OUT,),), x, None, None, *ts,
                               enc_out)[0]
    else:
        for i in range(cfg.num_layers):
            x, self_kv, cross_kv = _decoder_layer(cfg, p["decoder"][i], x, enc_out)
            if collect_kv:
                kvs.append((self_kv, cross_kv))
    return L.rmsnorm(p["final_norm"], x, cfg.norm_eps), kvs


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = True) -> torch.Tensor:
    """Next-token loss of the decoder on the batch's ``frames``, through
    ``transformer.chunked_xent`` on ``transformer.lm_targets``."""
    tokens, targets, mask = T.lm_targets(batch)
    enc_out = encode(cfg, params, batch["frames"])
    hidden, _ = decode_train(cfg, params, tokens, enc_out, remat=remat)
    return T.chunked_xent(cfg, params, hidden, targets, mask)


class WhisperCache(NamedTuple):
    """The decoder's self-attention cache and the cross-attention cache of
    the frames (written at prefill, read by every step). ``pos``: tokens
    already written, a host int as ``layers.KVCache`` keeps it."""

    k: torch.Tensor              # (L, B, KV, S, hd)
    v: torch.Tensor
    ck: torch.Tensor             # (L, B, KV, encoder_seq, hd)
    cv: torch.Tensor
    pos: int


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> WhisperCache:
    dev = resolve_device(device)
    dt = T.model_dtype(cfg)
    s_shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    c_shape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)
    return WhisperCache(*(torch.zeros(shape, dtype=dt, device=dev)
                          for shape in (s_shape, s_shape, c_shape, c_shape)), 0)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: L.ModelTree, tokens: torch.Tensor, frames: torch.Tensor,
            cache: WhisperCache) -> Tuple[torch.Tensor, WhisperCache]:
    """Encode the frames, run the prompt, write each layer's self-attention
    K and V from slot 0 and its cross-attention K and V of the frames into
    the cache (in place); return last-token logits (f32) and the cache at
    position ``S``."""
    T.refuse_sharded_serving(cfg, "prefill")
    if frames.shape[1] != cache.ck.shape[3]:
        raise ValueError(f"whisper.prefill: {frames.shape[1]} frames for a cross-attention "
                         f"cache of {cache.ck.shape[3]}")
    s = tokens.shape[1]
    enc_out = encode(cfg, params, frames)
    hidden, kvs = decode_train(cfg, params, tokens, enc_out, remat=False, collect_kv=True)
    for i, ((k, v), (ck, cv)) in enumerate(kvs):
        cache.k[i, :, :, :s] = k.transpose(1, 2)
        cache.v[i, :, :, :s] = v.transpose(1, 2)
        cache.ck[i] = ck.transpose(1, 2)
        cache.cv[i] = cv.transpose(1, 2)
    logits = (hidden[:, -1] @ params.lm_head).float()
    return logits, cache._replace(pos=s)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: L.ModelTree, cache: WhisperCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, WhisperCache]:
    """One decode step: tokens (B,) at position ``cache.pos``, plus the
    sinusoid's row ``pos``. Each layer writes the token's K and V into its
    self-attention cache before attending to it through K4, then attends
    through K4 to the frames' cache, every slot valid. The cache is updated
    in place; returns f32 logits and the cache at ``pos + 1``."""
    T.refuse_sharded_serving(cfg, "decode_step")
    b = tokens.shape[0]
    pos = cache.pos
    dev = tokens.device
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = T.embed_tokens(cfg, params, tokens[:, None])
    x = x + L.sinusoidal_positions(cache.k.shape[3], cfg.d_model, dev)[pos:pos + 1].to(x.dtype)
    slot_pos = L.cache_slot_positions(pos + 1, cache.k.shape[3], False, dev)
    enc_len = cache.ck.shape[3]
    enc_pos = torch.arange(enc_len, dtype=torch.int32, device=dev)
    for i, lp in enumerate(params.decoder):
        sa, ca = lp["self_attn"], lp["cross_attn"]
        h = L.rmsnorm(sa["norm"], x, cfg.norm_eps)
        q = L.linear(sa["wq"], h).reshape(b, nh, hd)
        k = L.linear(sa["wk"], h).reshape(b, nkv, hd)
        v = L.linear(sa["wv"], h).reshape(b, nkv, hd)
        kc, vc = L.cache_write(cache.k[i], cache.v[i], pos, k, v, False)
        o = L.decode_attention(q, kc, vc, slot_pos, pos)
        x = x + L.linear(sa["wo"], o.reshape(b, -1))[:, None]
        q = L.linear(ca["wq"], L.rmsnorm(ca["norm"], x, cfg.norm_eps)).reshape(b, nh, hd)
        o = L.decode_attention(q, cache.ck[i], cache.cv[i], enc_pos, enc_len)
        x = x + L.linear(ca["wo"], o.reshape(b, -1))[:, None]
        x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))
    hidden = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = (hidden[:, 0] @ params.lm_head).float()
    return logits, cache._replace(pos=pos + 1)
