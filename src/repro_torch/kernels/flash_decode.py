"""K4: single-token flash decode against a (possibly ring-buffer) KV cache.

Replaces the TPU kernel ``src/repro/kernels/flash_decode.py:flash_decode``.
The CUDA source is ``csrc/flash_decode.cu``: a split-K pass in which one
block per (batch, KV head, cache slice) streams the slice's tiles of 64
slots into shared memory with bulk copies, skipping tiles with no valid
slot, and scores them for all the query heads that share the KV head; then
a log-sum-exp merge of the slices. It is bound by the bytes of the cache on
the H100; the source note says what the design does about it. The split
pass's arithmetic goes by dtype: bf16 on the tensor cores (``mma.sync``,
p rounded to bf16 for the PV product, as ``decode_attention`` rounds its
p), f32 on the CUDA cores (p kept in f32, as the TPU kernel keeps it). A
(batch, head) with no valid slot gets the mean of V over all slots, as both
references give it.

``return_lse=True`` is the per-rank form of a cache split by sequence over
ranks (``sharding.parallel.merge_decode_partials`` merges the ranks'): the
merge's log-sum-exp instance returns ``(o, lse)``, o ``(B, H, hd)`` in f32,
left unrounded, and lse ``(B, H)`` f32, the softmax over the given slots
alone. A row with no valid slot gets lse ``-inf`` and the mean of V over the
slots.

``flash_decode`` launches the kernel for CUDA tensors and runs
``flash_decode_torch``, the plain PyTorch version, for CPU tensors only. It
never falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: slots per tile of the split pass (``kTile`` in the CUDA source)
TILE = 64
#: blocks the wrapper aims for when it cuts the cache into slices: two per
#: SM of the H100's 132, each with all its tiles in flight
TARGET_BLOCKS = 264


def flash_decode_torch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_positions: torch.Tensor, q_position: int, *,
                       window: int = 0, return_lse: bool = False):
    """Plain PyTorch version: ``repro/models/layers.py::decode_attention``.

    q ``(B, H, hd)``; caches ``(B, KV, S, hd)``; k_positions ``(S,)`` the
    absolute position in each slot (-1 if empty). A slot is valid iff
    ``0 <= kpos <= q_position`` and, with a window, ``kpos > q_position -
    window``. Scores ``q.k / sqrt(hd)`` in f32, softmax, p cast to the
    cache's dtype; returns ``(B, H, hd)`` in the cache's dtype.

    ``return_lse``: ``(o, lse)`` of the softmax over these slots, as the
    kernel's log-sum-exp instance computes it: ``p = exp(s - max)``, rounded
    to the cache's dtype for the PV product, o = PV / sum p in f32 and
    ``lse = max + log(sum p)``; with no valid slot, the mean of V and -inf.
    """
    b, h, hd = q.shape
    kvh = k_cache.shape[1]
    qh = q.reshape(b, kvh, h // kvh, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qh, k_cache.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=s.device))
    valid = (k_positions >= 0) & (k_positions <= q_position)
    if window > 0:
        valid &= k_positions > q_position - window
    if return_lse:
        return _lse_torch(s, valid, v_cache, (b, h, hd))
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgs,bksd->bkgd", p.float(), v_cache.float()).to(v_cache.dtype)
    return o.reshape(b, h, hd)


def _lse_torch(s: torch.Tensor, valid: torch.Tensor, v_cache: torch.Tensor, shape):
    """``flash_decode_torch``'s ``(o, lse)`` from the scaled scores ``s``
    ``(B, KV, G, S)`` and the slots' validity ``(S,)``."""
    s = torch.where(valid[None, None, None], s, float("-inf"))
    top = s.amax(dim=-1, keepdim=True)
    if s.shape[-1] == 0 or not bool(valid.any()):
        o = v_cache.float().mean(dim=2, keepdim=True).expand(*s.shape[:3], shape[2])
        if s.shape[-1] == 0:
            o = torch.zeros_like(o)
        return (o.reshape(shape).contiguous(),
                torch.full(shape[:2], float("-inf"), device=s.device))
    p = torch.exp(s - top)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    o = o / l[..., None]
    return o.reshape(shape), (top[..., 0] + torch.log(l)).reshape(shape[:2])


def split_plan(b: int, kvh: int, groups: int, s: int) -> tuple:
    """(number of slices, slots per slice) the wrapper cuts the cache into.

    Slices are whole tiles, as few per slice as gives about
    ``TARGET_BLOCKS`` blocks of (batch, KV head, group of up to 8 query
    heads, slice)."""
    base = b * kvh * -(-groups // 8)
    tiles = -(-s // TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // base)))
    chunk = -(-tiles // want) * TILE
    return -(-s // chunk), chunk


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_positions: torch.Tensor, q_position: int, *,
                 window: int = 0, return_lse: bool = False):
    """One query token per (batch, head) against the cache; see
    ``flash_decode_torch`` for the contract (``return_lse`` too). ``q_position``
    is a host int. CUDA tensors launch the kernel, CPU tensors run the plain
    version. ``launches`` counts the launches of the plain merge,
    ``lse_launches`` those of its log-sum-exp instance."""
    if q.device.type == "cpu":
        return flash_decode_torch(q, k_cache, v_cache, k_positions, q_position,
                                  window=window, return_lse=return_lse)
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in (k_cache, v_cache, k_positions)):
        raise ValueError("flash_decode: q, the caches and k_positions must lie on one "
                         "CUDA device")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: want q (B, H, hd) and caches (B, KV, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, hd = q.shape
    _, kvh, s, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or h % kvh \
            or k_positions.shape != (s,):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} and k_positions "
                         f"{tuple(k_positions.shape)} do not fit")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode: q and the caches must share f32 or bf16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if k_positions.dtype != torch.int32:
        raise TypeError(f"flash_decode: k_positions must be int32, got "
                        f"{k_positions.dtype}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, k_positions)):
        raise ValueError("flash_decode: q, the caches and k_positions must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: the caches must be 16-byte aligned (bulk copies)")
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse else q.dtype, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel() == 0 or s == 0:
        return (out.zero_(), lse.fill_(float("-inf"))) if return_lse else out.zero_()
    nsplit, chunk = split_plan(b, kvh, h // kvh, s)
    part = torch.empty((b, h, nsplit, hd + 2), dtype=torch.float32, device=dev)
    sqrt_hd = float(np.sqrt(np.float32(hd)))           # the reference's f32 sqrt(hd)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.launcher("flash_decode", "flash_decode_launch")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_positions.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, kvh, s, hd, int(q_position),
            int(window), nsplit, chunk, sqrt_hd, part.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), stream)
    _build.check("flash_decode", err)
    if return_lse:
        flash_decode.lse_launches += 1
        return out, lse
    flash_decode.launches += 1
    return out


#: kernel launches so far (one per call that reached the card): the plain
#: merge's, and the log-sum-exp instance's
flash_decode.launches = 0
flash_decode.lse_launches = 0
