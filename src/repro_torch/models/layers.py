"""Shared building blocks of the transformer: port of ``repro/models/layers.py``.

The public functions keep the reference's layouts: activations
``(B, S, H, hd)``, caches ``(L, B, KV, S, hd)``, weights ``(d_in, d_out)``.
Parameters are passed as ``ParamTree`` modules and read with the
reference's keys. On CUDA tensors ``mea_attention`` launches K3
(``kernels.flash_attention``; its gradient launches K3's backward kernel)
and ``decode_attention`` launches K4 (``kernels.flash_decode``); on CPU
tensors they run the kernels' plain versions, which repeat the reference's
arithmetic.

Not ported yet: ``moe``, ``apply_mrope`` and ``sinusoidal_positions``
(ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import NEG_INF, FlashAttention
from repro_torch.kernels.flash_decode import flash_decode


class ParamTree(nn.Module):
    """Parameters and sub-trees under the reference's keys, read as
    ``p["w"]`` and tested as ``"b" in p``."""

    def __init__(self, items: Mapping[str, object]):
        super().__init__()
        for key, value in items.items():
            setattr(self, key, value)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# Norms / projections
# ---------------------------------------------------------------------------


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """QK-norm: rmsnorm over the head_dim axis (qwen3)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale).to(x.dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); positions: (..., seq). Split-half
    rotation, angles in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def mea_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  query_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """Flash attention. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H a multiple
    of KV (GQA); ``q_offset`` is the absolute position of q[0]. K3 on the
    card, its gradient K3's backward kernel (``FlashAttention``: one path for
    serving and training, under ``torch.func.grad`` and ``vmap`` too); on the
    host the chunked online softmax of the reference (the chunk sizes shape
    only that plain version) and the plain gradient. K3 writes the
    log-sum-exp its backward takes only in grad mode: serving's ``no_grad``
    asks for none."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset, query_chunk, kv_chunk,
                                torch.is_grad_enabled())[0]


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0, **_):
    """Quadratic reference (small shapes only)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qh = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=s.device))
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None] > qpos[:, None] - window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float()).to(v.dtype)
    return o.reshape(b, sq, h, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_positions: torch.Tensor, q_position: int, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: (B, H, hd); caches: (B, KV, S, hd); k_positions: (S,) int32 absolute
    positions of each cache slot (-1 for empty); ``q_position`` a host int.
    K4 on the card, the reference's softmax on the host.
    """
    return flash_decode(q, k_cache, v_cache, k_positions, q_position, window=window)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer-stacked KV cache.

    k, v: (L, B, KV, S, hd). ``S`` is the full max length for dense attention
    or the window size for SWA (ring buffer). ``pos``: number of tokens
    already written, a host int (the reference keeps a device int32), so the
    decode loop never waits on the card to read it.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: int

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


def make_kv_cache(num_layers: int, batch: int, kv_heads: int, capacity: int,
                  head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (num_layers, batch, kv_heads, capacity, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def cache_slot_positions(pos: int, capacity: int, ring: bool, device=None) -> torch.Tensor:
    """Absolute position held by each cache slot (-1 if empty), int32."""
    idx = torch.arange(capacity, dtype=torch.int32, device=device)
    if not ring:
        return torch.where(idx < pos, idx, -1).to(torch.int32)
    # ring: slot i holds position p = last write to that slot
    p = pos - 1 - torch.remainder(pos - 1 - idx, capacity)
    return torch.where((p >= 0) & (p < pos), p, -1).to(torch.int32)


def cache_write(k_layer: torch.Tensor, v_layer: torch.Tensor, pos: int,
                k_new: torch.Tensor, v_new: torch.Tensor,
                ring: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V (B, KV, hd) at position ``pos`` (mod cap if ring).

    Writes the slot in place (a copy into the slot's view; ``pos`` is a host
    int, so nothing is sent to the card) and returns the same two tensors.
    The reference selects over the whole sequence axis and relies on buffer
    donation; eagerly, that select would allocate a copy of the layer's cache
    every step, which at Qwen2.5-14B scale is the whole cache once per step.
    """
    slot = pos % k_layer.shape[2] if ring else pos
    k_layer[:, :, slot].copy_(k_new)
    v_layer[:, :, slot].copy_(v_new)
    return k_layer, v_layer


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def make_mlp(pf, d: int, ff: int) -> "ParamTree":
    """``pf(name, shape, axes)`` makes one weight (``transformer.make_params``)."""
    return ParamTree({
        "wi": pf("wi", (d, ff), ("embed", "ffn")),
        "wg": pf("wg", (d, ff), ("embed", "ffn")),
        "wo": pf("wo", (ff, d), ("ffn", "embed")),
    })


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]
