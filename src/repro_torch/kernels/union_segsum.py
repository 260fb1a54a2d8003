"""K1: fused union + segment-sum + FedSubAvg scaling (the sparse server step).

Replaces the TPU kernel ``src/repro/kernels/union_segsum.py:union_segsum``.
The CUDA source is ``csrc/union_segsum.cu``: a V-sized bitmap, a block
prefix scan that ranks the marked ids, a compaction that writes the sorted
union, an atomic segment-sum of the rows onto their union slots and a heat
epilogue. It is bound by bytes on the H100 (ids, rows, the V-sized bitmap and
scan, the output); the source note says what the design does about it.

``union_segsum`` launches the kernel for CUDA tensors and runs
``union_segsum_torch``, the plain PyTorch version of the same function, for
CPU tensors only. It never falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_SCAN_TILE = 4096   # bitmap entries per scan block (kScanTile in the source)


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
    if ids.device.type == "cpu":
        return union_segsum_torch(ids, rows, heat, total, cap, num_rows,
                                  scale=scale)
    flat_ids, flat_rows, trailing = _flatten(ids, rows)
    if not flat_ids.is_cuda or flat_rows.device != flat_ids.device:
        raise ValueError("union_segsum: ids and rows must lie on one CUDA device")
    if flat_ids.dtype != torch.int32:
        raise TypeError(f"union_segsum: ids must be int32, got {flat_ids.dtype}")
    if flat_rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"union_segsum: rows must be f32 or bf16, got {flat_rows.dtype}")
    if heat is not None and (heat.dtype != torch.float32
                             or heat.device != flat_ids.device
                             or heat.shape != (num_rows,)):
        raise ValueError("union_segsum: heat must be f32 (num_rows,) on the ids' device")
    t, d = flat_rows.shape
    dev = flat_ids.device
    out_ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    out_rows = torch.zeros((cap, d), dtype=torch.float32, device=dev)
    if t == 0 or cap == 0 or d == 0:
        return out_ids, out_rows.reshape((cap,) + trailing)
    flat_ids = flat_ids.contiguous()
    flat_rows = flat_rows.contiguous()
    heat = heat.contiguous() if heat is not None else None
    bitmap = torch.zeros(num_rows, dtype=torch.int32, device=dev)
    rank = torch.empty(num_rows, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(-(-num_rows // _SCAN_TILE), dtype=torch.int32,
                            device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.launcher("union_segsum")(
            flat_ids.data_ptr(), flat_rows.data_ptr(),
            int(flat_rows.dtype == torch.bfloat16),
            heat.data_ptr() if heat is not None else None,
            float(total), float(scale), t, d, num_rows, cap,
            bitmap.data_ptr(), rank.data_ptr(), tile_sums.data_ptr(),
            out_ids.data_ptr(), out_rows.data_ptr(), stream)
    _build.check("union_segsum", err)
    union_segsum.launches += 1
    return out_ids, out_rows.reshape((cap,) + trailing)


#: kernel launches so far (one per call that reached the card)
union_segsum.launches = 0
