"""Optional row compression for the sparse update plane.

``topk_rows`` keeps only the k rows with the largest payload L2 norm. The
int8 stochastic-rounding quantiser is not ported yet (ROADMAP Queue 1,
item 7).
"""
from __future__ import annotations

from typing import Dict

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


def compress_delta_tree(tree: Dict, topk: int = 0, int8: bool = False) -> Dict:
    """Client->server compression of the RowSparse leaves of an update dict."""
    if int8:
        raise NotImplementedError(
            "int8 row compression is not ported yet (ROADMAP Queue 1, item 7)")
    if not topk:
        return tree
    return {k: topk_rows(v, topk) if is_rowsparse(v) else v
            for k, v in tree.items()}
