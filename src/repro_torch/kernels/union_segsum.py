"""K1: fused union + segment-sum + FedSubAvg scaling (the sparse server step).

Replaces the TPU kernel ``src/repro/kernels/union_segsum.py:union_segsum``.
The CUDA source is ``csrc/union_segsum.cu``: one cooperative launch that
zeroes its own scratch, marks the ids in a bit-packed union (one bit per
table row, V/4 bytes with the words' rank offsets), ranks the words, writes
the sorted union and segment-sums the rows, each times its id's factor,
onto their union slots with vector atomics. One call is one device
operation: the wrapper only allocates (``torch.empty``; out_ids and the
scratch share one buffer) and the kernel writes every output element. The
source note says what bounds it.

``union_segsum`` launches the kernel for CUDA tensors and runs
``union_segsum_torch``, the plain PyTorch version of the same function, for
CPU tensors only. It never falls back from one to the other.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _rows


def _flatten(ids: torch.Tensor, rows: torch.Tensor):
    trailing = tuple(rows.shape[ids.dim():])   # payload dims beyond the ids'
    flat_ids = ids.reshape(-1)
    return flat_ids, rows.reshape(flat_ids.shape[0], -1), trailing


def union_segsum_torch(ids: torch.Tensor, rows: torch.Tensor,
                       heat: Optional[torch.Tensor], total: float, cap: int,
                       num_rows: int, *, scale: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same contract, any device).

    ids ``(K, R)`` or ``(T,)`` int32 with -1 pads; rows ``(K, R, ...)`` /
    ``(T, ...)`` of f32 or bf16, summed in f32; heat ``(num_rows,)`` f32 or
    None. Returns the sorted-ascending union of the ids in ``[0, num_rows)``
    padded with -1 to ``cap`` (largest ids dropped over ``cap``), and per
    union id the sum of its rows times ``(total / max(heat, 1)) * scale``
    (0 where heat is 0; ``scale`` alone when heat is None).
    """
    flat_ids, flat_rows, trailing = _flatten(ids, rows)
    dev = flat_ids.device
    valid = (flat_ids >= 0) & (flat_ids < num_rows)
    safe = torch.where(valid, flat_ids, num_rows).long()
    mark = torch.zeros(num_rows + 1, dtype=torch.bool, device=dev)
    mark[safe] = True
    mark = mark[:num_rows]
    rank = torch.cumsum(mark, 0) - 1
    slot = torch.where(mark & (rank < cap), rank, cap)
    union = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    union.scatter_(0, slot, torch.arange(num_rows, dtype=torch.int32, device=dev))
    union = union[:cap]
    pos = rank[torch.clamp(safe, max=num_rows - 1)]
    pos = torch.where(valid & (pos < cap), pos, cap)
    summed = torch.zeros((cap + 1, flat_rows.shape[1]), dtype=torch.float32,
                         device=dev)
    summed = summed.index_add_(0, pos, flat_rows.to(torch.float32))[:cap]
    if heat is None:
        factor = torch.where(union >= 0, scale, 0.0)
    else:
        h = heat.to(torch.float32)[torch.clamp(union, min=0).long()]
        t = torch.tensor(total, dtype=torch.float32, device=dev)
        f = torch.where(h > 0, torch.div(t, torch.clamp(h, min=1.0)), 0.0)
        factor = torch.where(union >= 0, f * scale, 0.0)
    return union, (summed * factor[:, None]).reshape((cap,) + trailing)


def union_segsum(ids: torch.Tensor, rows: torch.Tensor,
                 heat: Optional[torch.Tensor], total: float, cap: int,
                 num_rows: int, *, scale: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused union + segment-sum + scaling; see ``union_segsum_torch`` for
    the contract. CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    dev = ids.device
    if dev.type == "cpu":
        return union_segsum_torch(ids, rows, heat, total, cap, num_rows,
                                  scale=scale)
    if dev.type != "cuda" or rows.device != dev:
        raise ValueError("union_segsum: ids and rows must lie on one CUDA device")
    if ids.dtype != torch.int32:
        raise TypeError(f"union_segsum: ids must be int32, got {ids.dtype}")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"union_segsum: rows must be f32 or bf16, got {rows.dtype}")
    if rows.shape[:ids.dim()] != ids.shape:
        raise ValueError(f"union_segsum: rows {tuple(rows.shape)} do not extend ids "
                         f"{tuple(ids.shape)}")
    if heat is not None and (heat.dtype != torch.float32 or heat.device != dev
                             or heat.shape != (num_rows,)):
        raise ValueError("union_segsum: heat must be f32 (num_rows,) on the ids' device")
    trailing = tuple(rows.shape[ids.dim():])
    if cap == 0:
        return (torch.empty((0,), dtype=torch.int32, device=dev),
                torch.empty((0,) + trailing, dtype=torch.float32, device=dev))
    t, d = ids.numel(), math.prod(trailing)
    ids, rows = ids.contiguous(), rows.contiguous()
    heat = heat.contiguous() if heat is not None else None
    bf16 = rows.dtype == torch.bfloat16
    vec = _rows.vector_width(d, rows.data_ptr(), rows.element_size())
    plan = _rows.union_plan(t, d, num_rows, cap, vec,
                            _rows.max_blocks("union_segsum", dev, bf16, vec))
    # out_rows, and one buffer for out_ids then the scratch (its uint2 words
    # on an 8-byte boundary)
    out_rows = torch.empty((cap,) + trailing, dtype=torch.float32, device=dev)
    at_scratch = cap + cap % 2
    buf = torch.empty(at_scratch + plan.scratch_ints, dtype=torch.int32, device=dev)
    out_ids = buf[:cap]
    ptr = buf.data_ptr()
    err = _build.launcher("union_segsum", "union_segsum_launch")(
        ids.data_ptr(), rows.data_ptr(), int(bf16),
        heat.data_ptr() if heat is not None else None, float(total), float(scale), t, d,
        num_rows, cap, plan.vec, plan.team, plan.blocks, ptr + 4 * at_scratch, ptr,
        out_rows.data_ptr(), dev.index, _rows.raw_stream(dev))
    _build.check("union_segsum", err)
    union_segsum.launches += 1
    return out_ids, out_rows


#: kernel launches so far (one per call that reached the card)
union_segsum.launches = 0
