"""Oracles of the ported kernels, under the names of the JAX package's
``kernels/ref.py``. Each is the plain PyTorch version kept beside its
kernel."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.kernels.flash_decode import flash_decode_torch
from repro_torch.kernels.heat_scatter import rowsparse_scatter_torch as rowsparse_scatter_ref
from repro_torch.kernels.union_segsum import union_segsum_torch as union_segsum_ref

__all__ = ["flash_attention_ref", "flash_decode_ref", "heat_scatter_ref",
           "rowsparse_scatter_ref", "union_segsum_ref"]


def heat_scatter_ref(ids, grads, heat, total: float, vocab: int):
    """Token-gradient aggregation: ``rowsparse_scatter_ref`` with ``scale=1``."""
    return rowsparse_scatter_ref(ids, grads, heat, total, vocab)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). GQA, optional sliding window."""
    return flash_attention_torch(q, k, v, causal=causal, window=window,
                                 query_chunk=min(q.shape[1], 512),
                                 kv_chunk=min(k.shape[1], 512))


def flash_decode_ref(q, k_cache, v_cache, k_positions, q_position, *, window=0):
    """q: (B, H, hd); caches: (B, KV, S, hd)."""
    return flash_decode_torch(q, k_cache, v_cache, k_positions, q_position, window=window)
