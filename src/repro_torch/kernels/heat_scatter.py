"""K2: fused scatter-add + FedSubAvg correction into a dense table.

Replaces the TPU kernel ``src/repro/kernels/heat_scatter.py:rowsparse_scatter``
(``heat_scatter`` is its ``scale=1`` case). The CUDA source is
``csrc/rowsparse_scatter.cu``: one cooperative launch that zeroes the
``(V, D)`` output in 16-byte stores and, after a grid-wide barrier, adds
each row times its id's factor into it with vector atomics. The output is
allocated with ``torch.empty`` and written once, with no fill before the
launch and no scale pass after it. It is bound by bytes on the H100 (ids
and rows read once, the dense output written once); the source note says
what the design does about it.

``rowsparse_scatter`` launches the kernel for CUDA tensors and runs
``rowsparse_scatter_torch``, the plain PyTorch version, for CPU tensors
only. It never falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _rows


def rowsparse_scatter_torch(ids: torch.Tensor, rows: torch.Tensor,
                            heat: torch.Tensor, total: float, vocab: int, *,
                            scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract, any device).

    ids ``(T,)`` int32 (-1 pads and ids outside ``[0, vocab)`` dropped);
    rows ``(T, D)`` f32 or bf16, summed in f32; heat ``(vocab,)`` f32.
    Returns ``(vocab, D)`` f32 where row v holds
    ``(sum_{t: ids[t]=v} rows[t] * total / max(heat[v], 1)) * scale``
    (0 where heat is 0).
    """
    dev = ids.device
    valid = (ids >= 0) & (ids < vocab)
    safe = torch.where(valid, ids, vocab).long()
    out = torch.zeros((vocab + 1, rows.shape[1]), dtype=torch.float32, device=dev)
    out = out.index_add_(0, safe, rows.to(torch.float32))[:vocab]
    h = heat.to(torch.float32)
    t = torch.tensor(total, dtype=torch.float32, device=dev)
    factor = torch.where(h > 0, torch.div(t, torch.clamp(h, min=1.0)), 0.0)
    return out * factor[:, None] * scale


def rowsparse_scatter(ids: torch.Tensor, rows: torch.Tensor, heat: torch.Tensor,
                      total: float, vocab: int, *, scale: float = 1.0
                      ) -> torch.Tensor:
    """Fused scatter-add + correction; see ``rowsparse_scatter_torch`` for
    the contract. CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    dev = ids.device
    if dev.type == "cpu":
        return rowsparse_scatter_torch(ids, rows, heat, total, vocab, scale=scale)
    if dev.type != "cuda" or rows.device != dev or heat.device != dev:
        raise ValueError("rowsparse_scatter: ids, rows and heat must lie on "
                         "one CUDA device")
    if ids.dim() != 1 or rows.dim() != 2 or rows.shape[0] != ids.shape[0]:
        raise ValueError(f"rowsparse_scatter: want ids (T,) and rows (T, D), got "
                         f"{tuple(ids.shape)} and {tuple(rows.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"rowsparse_scatter: ids must be int32, got {ids.dtype}")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rowsparse_scatter: rows must be f32 or bf16, got {rows.dtype}")
    if heat.dtype != torch.float32 or heat.shape != (vocab,):
        raise ValueError("rowsparse_scatter: heat must be f32 (vocab,)")
    t, d = rows.shape
    out = torch.empty((vocab, d), dtype=torch.float32, device=dev)
    if d == 0 or vocab == 0:
        return out
    ids, rows, heat = ids.contiguous(), rows.contiguous(), heat.contiguous()
    bf16 = rows.dtype == torch.bfloat16
    vec = _rows.vector_width(d, rows.data_ptr(), rows.element_size())
    plan = _rows.scatter_plan(t, d, vocab, vec,
                              _rows.max_blocks("rowsparse_scatter", dev, bf16, vec))
    err = _build.launcher("rowsparse_scatter", "rowsparse_scatter_launch")(
        ids.data_ptr(), rows.data_ptr(), int(bf16), heat.data_ptr(), float(total),
        float(scale), t, d, vocab, plan.vec, plan.team, plan.blocks, out.data_ptr(),
        dev.index, _rows.raw_stream(dev))
    _build.check("rowsparse_scatter", err)
    rowsparse_scatter.launches += 1
    return out


#: kernel launches so far (one per call that reached the card)
rowsparse_scatter.launches = 0
