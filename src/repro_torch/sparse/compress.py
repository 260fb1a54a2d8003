"""Optional row compression for the sparse update plane.

Both schemes stay in the ``(ids, rows)`` format, so they compose with the
aggregation:

``topk_rows``           keep only the k rows with the largest payload L2 norm
                        (biased, like every top-k scheme).
``quantize_rows_int8``  per-row symmetric int8 with stochastic rounding, so
                        dequantisation is unbiased: E[dq(q(x))] = x. The wire
                        payload drops 4x, plus one f32 scale per row.

The rounding noise comes from :func:`int8_uniform`, looked up at call time.
JAX's threefry stream cannot be reproduced from PyTorch; the port seeds a
``torch.Generator`` from the same ``(seed, rounds, leaf)`` triple the JAX
package folds into its key, and tests swap the function for the JAX
package's own draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.sparse.rowsparse import PAD_ID, RowSparse, is_rowsparse


def topk_rows(rs: RowSparse, k: int) -> RowSparse:
    """Keep the k largest-L2 rows per client (capacity -> k), ids ascending.

    Works on unbatched ``(R,)`` ids or a ``(K, R)`` cohort stack. Equal norms
    keep the lower slot, as ``jax.lax.top_k`` does: LR deltas tie exactly
    (a client's gender and age features occur in every one of its samples),
    and ``torch.topk`` promises no order among ties, so a stable descending
    sort picks the rows instead.
    """
    r = rs.capacity
    k = min(int(k), r)
    lead = tuple(rs.ids.shape)
    flat = rs.rows.reshape(lead + (-1,)).to(torch.float32)
    norms = torch.where(rs.ids >= 0, (flat * flat).sum(-1),
                        torch.full_like(flat[..., 0], -1.0))
    order = torch.sort(norms, dim=-1, descending=True, stable=True).indices
    keep = torch.sort(order[..., :k], dim=-1).values   # ascending-id order
    ids = torch.gather(rs.ids, -1, keep)
    gidx = keep.reshape(keep.shape + (1,) * (rs.rows.dim() - len(lead)))
    rows = torch.gather(rs.rows, len(lead) - 1,
                        gidx.expand(keep.shape + tuple(rs.rows.shape[len(lead):])))
    # slots whose norm was the -1 padding sentinel stay padding
    valid = torch.gather(norms, -1, keep) >= 0
    ids = torch.where(valid, ids, PAD_ID)
    mask = valid.reshape(valid.shape + (1,) * (rows.dim() - len(lead)))
    return RowSparse(ids, rows * mask.to(rows.dtype), rs.num_rows)


class QuantRows:
    """int8-quantised RowSparse payload: ids, int8 rows, one f32 scale per row."""

    __slots__ = ("ids", "q", "scales", "num_rows")

    def __init__(self, ids: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                 num_rows: int):
        self.ids = ids
        self.q = q
        self.scales = scales
        self.num_rows = int(num_rows)

    def __repr__(self):
        return (f"QuantRows(ids={tuple(self.ids.shape)}, q={tuple(self.q.shape)}, "
                f"num_rows={self.num_rows})")


def int8_uniform(shape: Tuple[int, ...], seed: int, rounds: int, leaf_index: int,
                 device) -> torch.Tensor:
    """``U[0, 1)`` float32 noise of ``shape`` for one leaf of one round.

    A ``torch.Generator`` on ``device`` seeded from ``(seed, rounds,
    leaf_index)`` through numpy's ``SeedSequence`` (host arithmetic, no
    device sync): distinct rounds and leaves draw independent streams.
    """
    words = np.random.SeedSequence(
        [int(x) & 0xFFFFFFFFFFFFFFFF for x in (seed, rounds, leaf_index)]
    ).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 32) | int(words[1]))
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


def quantize_rows_int8(rs: RowSparse, key: Tuple[int, int, int]) -> QuantRows:
    """Per-row symmetric int8 quantisation with stochastic rounding.

    ``q = floor(x / s + u)`` with ``u ~ U[0, 1)`` satisfies ``E[q * s] = x``;
    ``s`` is ``max|row| / 127`` (1 for an all-zero row). ``key`` is the
    ``(seed, rounds, leaf_index)`` triple :func:`int8_uniform` draws from.
    """
    shape = rs.rows.shape
    lead = tuple(rs.ids.shape)
    flat = rs.rows.reshape(lead + (-1,)).to(torch.float32)
    maxabs = flat.abs().amax(dim=-1)
    scales = torch.where(maxabs > 0, maxabs / 127.0, 1.0)
    u = int8_uniform(tuple(flat.shape), *key, device=flat.device)
    q = torch.floor(flat / scales[..., None] + u)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return QuantRows(rs.ids, q.reshape(shape), scales, rs.num_rows)


def dequantize_rows(qr: QuantRows, dtype=torch.float32) -> RowSparse:
    """The rows ``q * s`` back as a RowSparse of ``dtype``."""
    lead = tuple(qr.ids.shape)
    flat = qr.q.reshape(lead + (-1,)).to(torch.float32)
    rows = (flat * qr.scales[..., None]).reshape(qr.q.shape).to(dtype)
    return RowSparse(qr.ids, rows, qr.num_rows)


def topk_tree(tree: Dict, k: int) -> Dict:
    """``topk_rows`` on every RowSparse leaf (``(R,)`` or ``(K, R)`` ids);
    dense leaves pass through."""
    return {name: topk_rows(leaf, k) if is_rowsparse(leaf) else leaf
            for name, leaf in tree.items()}


def leaf_order(names) -> list:
    """The names in the order the JAX package flattens the same tree: dict
    keys sorted at every level of the dotted path, tuple positions (the
    LSTM's ``cells.{i}``) in numeric order."""
    def key(name):
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")]

    return sorted(names, key=key)


def quantize_tree_int8(tree: Dict, key: Tuple[int, int]) -> Dict:
    """Quantise every RowSparse leaf with its own stream.

    ``key`` is ``(seed, rounds)``; leaf i of the tree (in :func:`leaf_order`,
    dense leaves counted) draws from ``(seed, rounds, i)``, as the JAX
    package's ``fold_in(key, i)``: one stream for every table would round
    two tables' equal rows alike instead of independently.
    """
    index = {name: i for i, name in enumerate(leaf_order(tree))}
    return {name: quantize_rows_int8(leaf, (*key, index[name])) if is_rowsparse(leaf)
            else leaf for name, leaf in tree.items()}


def compress_delta_tree(tree: Dict, topk: int = 0, int8: bool = False,
                        key: Optional[Tuple[int, int]] = None) -> Dict:
    """Client-to-server compression of the RowSparse leaves of an update dict.

    Optional top-k row selection, then optional int8 stochastic rounding
    dequantised at once: the aggregation gets what a wire round trip would
    deliver, while the comm accounting prices the compressed form. ``key``
    is the int8 stream's ``(seed, rounds)``. Identity when both are off.
    """
    if topk:
        tree = topk_tree(tree, topk)
    if int8:
        if key is None:
            raise ValueError("int8 compression draws stochastic-rounding noise: "
                             "pass its (seed, rounds) key")
        tree = {name: dequantize_rows(leaf) if isinstance(leaf, QuantRows) else leaf
                for name, leaf in quantize_tree_int8(tree, key).items()}
    return tree
