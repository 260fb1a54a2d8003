"""Oracles of the ported kernels, under the names of the JAX package's
``kernels/ref.py``. Each is the plain PyTorch version kept beside its
kernel; the attention oracles come with the LLM slice."""
from __future__ import annotations

from repro_torch.kernels.heat_scatter import rowsparse_scatter_torch as rowsparse_scatter_ref
from repro_torch.kernels.union_segsum import union_segsum_torch as union_segsum_ref

__all__ = ["heat_scatter_ref", "rowsparse_scatter_ref", "union_segsum_ref"]


def heat_scatter_ref(ids, grads, heat, total: float, vocab: int):
    """Token-gradient aggregation: ``rowsparse_scatter_ref`` with ``scale=1``."""
    return rowsparse_scatter_ref(ids, grads, heat, total, vocab)
