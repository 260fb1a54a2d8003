"""Decoder-only transformer, dense family: port of ``repro/models/transformer.py``.

Serves Qwen2.5-14B and the other dense configurations: GQA with optional
qk_norm, QKV bias and sliding window, gated MLP, RoPE. The parameters are a
``Transformer`` module whose layers sit in an ``nn.ModuleList``; every level
is a ``layers.ParamTree`` under the reference's keys, so the functions below
read ``lp["attn"]["wq"]["w"]`` as the reference does. The reference's
``lax.scan`` and ``fori_loop`` over stacked layers become a Python loop, and
its sharding constraints go (one card).

Serving: ``prefill`` and ``decode_step`` run under ``torch.no_grad`` and
write the KV cache in place. Training: ``loss_fn`` (the causal LM loss
through ``chunked_xent``) differentiates ``forward`` with K3's gradient
kernel on the card. ``forward`` reads the parameters in either form: the
``Transformer`` module serving takes, or the flat ``{state_dict name:
tensor}`` dict that ``train_params`` gives the round step with its logical
axes. The reference's ``jax.checkpoint`` per layer changes no number and
is left out: the depths the port trains keep every layer's activations.
MoE, M-RoPE and patch embeddings are not ported yet (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamTree

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """Parameter container. ``axes`` maps each ``state_dict`` name to its
    logical axes (the reference's, without the stacked "layers" axis)."""

    def __init__(self, embedding: nn.Parameter, layers: List[ParamTree],
                 final_norm: ParamTree, lm_head: nn.Parameter, axes: Dict[str, Tuple]):
        super().__init__()
        self.embedding = embedding
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.axes = axes

    def __getitem__(self, key: str):
        return getattr(self, key)


class FlatParams:
    """A flat parameter dict read with the module's keys:
    ``FlatParams(flat)["layers"][0]["attn"]["wq"]["w"]`` is
    ``flat["layers.0.attn.wq.w"]``."""

    def __init__(self, flat: Mapping[str, torch.Tensor], prefix: str = ""):
        self.flat, self.prefix = flat, prefix

    def __getitem__(self, key):
        name = f"{self.prefix}{key}"
        if name in self.flat:
            return self.flat[name]
        return FlatParams(self.flat, name + ".")

    def __contains__(self, key) -> bool:
        return f"{self.prefix}{key}" in self.flat


Params = Union[Transformer, Mapping[str, torch.Tensor]]


def as_tree(params: Params):
    """The module as it is, a flat dict behind ``FlatParams``."""
    return params if isinstance(params, Transformer) else FlatParams(params)


def train_params(model: Transformer) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """``(params, axes)`` for the round step: the module's tensors under their
    ``state_dict`` names (the same storage, not a copy) and their logical
    axes. ``lm_head``'s vocabulary axis is axis 1: it stays dense on the
    sparse transport and is heat-corrected on the dense one."""
    return dict(model.state_dict()), dict(model.axes)


def stack_layers(flat: Mapping[str, torch.Tensor], axes: Optional[Mapping[str, Tuple]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Tuple]]]:
    """The flat training dict in the reference's stacked layout: each layer
    leaf ``layers.{i}.attn.wq.w`` goes, in layer order, into one ``(L, ...)``
    tensor under ``layers.attn.wq.w``, its axes led by ``"layers"``:
    ``save_checkpoint`` of the two writes the reference's LLM checkpoint."""
    out: Dict[str, object] = {}
    for name, t in flat.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            out.setdefault(f"layers.{rest}", {})[int(i)] = t
        else:
            out[name] = t
    for name, by_layer in out.items():
        if isinstance(by_layer, dict):
            if sorted(by_layer) != list(range(len(by_layer))):
                raise ValueError(f"{name}: layers {sorted(by_layer)} are not 0..L-1")
            out[name] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    if axes is None:
        return out, None
    return out, {name: (("layers",) + tuple(axes[f"layers.0.{name[len('layers.'):]}"])
                        if name.startswith("layers.") else tuple(axes[name]))
                 for name in out}


def unstack_layers(stacked: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``stack_layers``'s inverse: ``layers.attn.wq.w`` ``(L, ...)`` back to
    ``layers.{i}.attn.wq.w`` (a view of each slice; numpy arrays too), in
    ``train_params``'s key order."""
    out: Dict[str, torch.Tensor] = {}
    names = [n for n in stacked if n.startswith("layers.")]
    for name, t in stacked.items():
        if not name.startswith("layers."):
            out[name] = t
        elif name == names[0]:
            for i in range(t.shape[0]):
                for n in names:
                    out[f"layers.{i}.{n[len('layers.'):]}"] = stacked[n][i]
    return out


class _Factory:
    """Makes each parameter as ``repro/sharding/logical.py::ParamFactory``
    draws it (``normal``: 0.02 * N(0, 1); ``fan_in``: N(0, 1) /
    sqrt(shape[-2]); ``ones``; ``zeros``; drawn in f32, then cast), or takes
    it from ``state`` by name; records its logical axes."""

    def __init__(self, dtype, device, generator, state, axes=None, prefix=""):
        self.dtype, self.device = dtype, device
        self.generator, self.state = generator, state
        self.axes: Dict[str, Tuple] = {} if axes is None else axes
        self.prefix = prefix

    def scope(self, name: str) -> "_Factory":
        return _Factory(self.dtype, self.device, self.generator, self.state, self.axes,
                        f"{self.prefix}{name}.")

    def __call__(self, name, shape, axes, init="fan_in", dtype=None) -> nn.Parameter:
        full = self.prefix + name
        self.axes[full] = tuple(axes)
        dtype = dtype or self.dtype
        if self.state is not None:
            if full not in self.state:
                raise ValueError(f"{full}: not in the given state")
            value = torch.as_tensor(self.state[full])
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f"{full}: shape {tuple(value.shape)}, want {tuple(shape)}")
            value = value.to(self.device, dtype, copy=True)
        elif init in ("ones", "zeros"):
            value = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=dtype, device=self.device)
        else:
            std = 0.02 if init == "normal" else 1.0 / math.sqrt(max(shape[-2], 1))
            value = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                                device=self.device).mul_(std).to(dtype)
        return nn.Parameter(value, requires_grad=False)


def _make_linear(pf: _Factory, name: str, d_in: int, d_out: int, axes: Tuple,
                 bias: bool = False) -> ParamTree:
    pf = pf.scope(name)
    p = {"w": pf("w", (d_in, d_out), axes)}
    if bias:
        p["b"] = pf("b", (d_out,), (axes[-1],), init="zeros")
    return ParamTree(p)


def _make_rmsnorm(pf: _Factory, name: str, d: int) -> ParamTree:
    return ParamTree({"scale": pf.scope(name)("scale", (d,), ("embed",), init="ones",
                                               dtype=torch.float32)})


def make_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, state: Optional[Mapping[str, object]] = None
                ) -> Transformer:
    """The model's parameters on ``device`` (the card unless ``"cpu"``).

    Drawn from ``generator`` (a ``torch.Generator`` on that device; seed 0
    when omitted) with the reference's distributions, or taken from
    ``state``, keyed by ``state_dict`` names such as ``layers.0.attn.wq.w``.
    """
    if cfg.family != "dense" or cfg.is_moe or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (ROADMAP Queue 1 item 9)")
    dev = resolve_device(device)
    if generator is None and state is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    root = _Factory(model_dtype(cfg), dev, generator, state)
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    layers = []
    for i in range(cfg.num_layers):
        pf = root.scope(f"layers.{i}")
        ap = pf.scope("attn")
        attn = {
            "norm": _make_rmsnorm(ap, "norm", d),
            "wq": _make_linear(ap, "wq", d, q_dim, ("embed", "heads"), cfg.qkv_bias),
            "wk": _make_linear(ap, "wk", d, kv_dim, ("embed", "kv"), cfg.qkv_bias),
            "wv": _make_linear(ap, "wv", d, kv_dim, ("embed", "kv"), cfg.qkv_bias),
            "wo": _make_linear(ap, "wo", q_dim, d, ("heads", "embed")),
        }
        if cfg.qk_norm:
            attn["q_norm"] = ap("q_norm", (hd,), (None,), init="ones", dtype=torch.float32)
            attn["k_norm"] = ap("k_norm", (hd,), (None,), init="ones", dtype=torch.float32)
        layers.append(ParamTree({"attn": ParamTree(attn),
                                 "ffn_norm": _make_rmsnorm(pf, "ffn_norm", d),
                                 "ffn": L.make_mlp(pf.scope("ffn"), d, cfg.d_ff)}))
    embedding = root("embedding", (cfg.vocab_size, d), ("vocab", "embed"), init="normal")
    final_norm = _make_rmsnorm(root, "final_norm", d)
    lm_head = root("lm_head", (d, cfg.vocab_size), ("embed", "vocab"))
    return Transformer(embedding, layers, final_norm, lm_head, root.axes)


# ---------------------------------------------------------------------------
# Attention block (shared by prefill / decode)
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ModelConfig, ap, x: torch.Tensor, positions: torch.Tensor):
    b, s = x.shape[:2]
    q = L.linear(ap["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = L.linear(ap["wk"], x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = L.linear(ap["wv"], x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.head_rmsnorm(ap["q_norm"], q, cfg.norm_eps)
        k = L.head_rmsnorm(ap["k_norm"], k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg: ModelConfig, ap, x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence (prefill) attention through ``mea_attention`` (K3 on
    the card). Returns (out, (k, v))."""
    if cfg.attn_impl != "mea":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: the port's attention is 'mea' only")
    q, k, v = _project_qkv(cfg, ap, x, positions)
    o = L.mea_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        query_chunk=cfg.query_chunk, kv_chunk=cfg.kv_chunk)
    b, s = x.shape[:2]
    out = L.linear(ap["wo"], o.reshape(b, s, cfg.num_heads * cfg.head_dim))
    return out, (k, v)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embedding"]
    # sqrt(d_model) in f32, then rounded to the table's dtype, as the
    # reference scales it (in bf16, sqrt(5120) = 71.55 becomes 71.5)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    return emb[tokens] * float(scale.to(emb.dtype))


# ---------------------------------------------------------------------------
# Forward (train / prefill) and the LM loss
# ---------------------------------------------------------------------------


class ForwardOut(NamedTuple):
    hidden: torch.Tensor                 # (B, S, d) final-norm'd hidden states
    kv: Optional[List[Tuple]]            # per layer (k, v), each (B, S, KV, hd)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            collect_kv: bool = False) -> ForwardOut:
    """Full-sequence forward (train / prefill) over the module or the flat
    training dict."""
    p = as_tree(params)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(cfg, p, tokens)
    kvs = [] if collect_kv else None
    for i in range(cfg.num_layers):
        lp = p["layers"][i]
        h, kv = attention_block(cfg, lp["attn"],
                                L.rmsnorm(lp["attn"]["norm"], x, cfg.norm_eps), positions)
        x = x + h
        x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))
        if collect_kv:
            kvs.append(kv)
    hidden = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return ForwardOut(hidden, kvs)


def chunked_xent(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy in sequence chunks against ``lm_head``: f32
    logits of one ``(B, c, V)`` chunk at a time, ``logsumexp - gold`` masked,
    summed over chunks and divided by ``max(mask count, 1)``."""
    head = as_tree(params)["lm_head"]
    s = hidden.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"chunked_xent: sequence length {s} is not a multiple of {c}")
    losses, counts = [], []
    for i in range(s // c):
        piece = slice(i * c, (i + 1) * c)
        logits = (hidden[:, piece] @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[:, piece, None].long())[..., 0]
        m = mask[:, piece]
        losses.append(((lse - gold) * m).sum())
        counts.append(m.sum())
    return torch.stack(losses).sum() / torch.clamp(torch.stack(counts).sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor]
            ) -> torch.Tensor:
    """Causal LM loss, the mean over the batch's unmasked tokens. ``labels``
    default to the tokens shifted left and padded with 0, ``mask`` to ones.
    The dense family has no router, so the reference's aux term is 0."""
    tokens = batch["tokens"]
    targets = batch.get("labels")
    if targets is None:
        targets = F.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    out = forward(cfg, params, tokens)
    return chunked_xent(cfg, params, out.hidden, targets, mask)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> L.KVCache:
    cap = min(cfg.sliding_window, max_seq) if cfg.sliding_window > 0 else max_seq
    return L.make_kv_cache(cfg.num_layers, batch, cfg.num_kv_heads, cap, cfg.head_dim,
                           dtype=model_dtype(cfg), device=resolve_device(device))


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            cache: L.KVCache) -> Tuple[torch.Tensor, L.KVCache]:
    """Run the prompt, fill the cache (in place), return last-token logits
    (f32) and the cache at position ``S``."""
    out = forward(cfg, params, tokens, collect_kv=True)
    s = tokens.shape[1]
    cap = cache.capacity
    for i, (k, v) in enumerate(out.kv):
        k, v = k.transpose(1, 2), v.transpose(1, 2)            # -> (B, KV, S, hd)
        if cfg.sliding_window > 0 and s > cap:
            # ring semantics: keep the last `cap` tokens at their mod-cap slots
            shift = s % cap
            k = torch.roll(k[:, :, -cap:], shift, dims=2)
            v = torch.roll(v[:, :, -cap:], shift, dims=2)
        cache.k[i, :, :, :k.shape[2]] = k
        cache.v[i, :, :, :v.shape[2]] = v
    logits = (out.hidden[:, -1] @ params.lm_head).float()
    return logits, L.KVCache(cache.k, cache.v, s)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, cache: L.KVCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, L.KVCache]:
    """One decode step: tokens (B,) at position ``cache.pos``. Writes the
    token's K/V into the cache (in place) before attending, as the
    reference does; returns f32 logits and the cache at ``pos + 1``."""
    b = tokens.shape[0]
    pos = cache.pos
    ring = cfg.sliding_window > 0
    dev = tokens.device
    positions = torch.full((b, 1), pos, device=dev)
    x = embed_tokens(cfg, params, tokens[:, None])
    slot_pos = L.cache_slot_positions(pos + 1, cache.capacity, ring, dev)  # incl. current
    for i, lp in enumerate(params.layers):
        ap = lp["attn"]
        q, k, v = _project_qkv(cfg, ap, L.rmsnorm(ap["norm"], x, cfg.norm_eps), positions)
        k_layer, v_layer = L.cache_write(cache.k[i], cache.v[i], pos, k[:, 0], v[:, 0], ring)
        o = L.decode_attention(q[:, 0], k_layer, v_layer, slot_pos, pos,
                               window=cfg.sliding_window)
        x = x + L.linear(ap["wo"], o.reshape(b, -1))[:, None]
        x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))
    hidden = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = (hidden[:, 0] @ params.lm_head).float()
    return logits, L.KVCache(cache.k, cache.v, pos + 1)
