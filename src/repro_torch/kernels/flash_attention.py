"""K3: causal GQA flash attention with an optional sliding window (forward).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:flash_attention``.
The CUDA source is ``csrc/flash_attention.cu``: for each (head, batch,
query tile) a block walks the key tiles between the window's lower edge and
the causal diagonal with an online softmax in registers. It is bound by
operations on the H100. The wrapper dispatches by dtype (``kernel_symbol``):
bf16 runs the tensor-core kernel (``wgmma`` products on TMA-loaded tiles in
mbarrier-guarded rings, a producer warpgroup and two consumers, one
persistent block per SM); f32 runs the CUDA-core kernel, since TF32 tensor
cores cannot meet the 2e-5 that f32 is held to. This is a dispatch by dtype, not a fallback: a failed build or
launch of either raises. The source note says what each design does.

``flash_attention`` launches a kernel for CUDA tensors and runs
``flash_attention_torch``, the plain PyTorch version, for CPU tensors only.
It never falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: the launcher of each dtype in ``csrc/flash_attention.cu``
KERNELS = {torch.bfloat16: "flash_attention_bf16_launch",
           torch.float32: "flash_attention_f32_launch"}


def _scale(hd: int) -> float:
    # the reference's 1 / sqrt(hd), both in f32
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, q_offset: int = 0,
                          query_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version: ``repro/models/layers.py::mea_attention``.

    q ``(B, Sq, H, hd)``; k, v ``(B, Sk, KV, hd)`` with H a multiple of KV.
    Query row i sits at position ``q_offset + i``. Chunked online softmax in
    f32 with the reference's padding, masking, and cast of p to v's dtype
    before the PV product; returns ``(B, Sq, H, hd)`` in q's dtype.
    """
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    groups = h // kvh
    scale = _scale(hd)
    cq, ck = min(query_chunk, sq), min(kv_chunk, sk)
    sq_pad, sk_pad = (-sq) % cq, (-sk) % ck
    nq, nk = (sq + sq_pad) // cq, (sk + sk_pad) // ck
    pad_seq = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))  # noqa: E731
    qh = pad_seq(q, sq_pad).transpose(1, 2).float()                       # (B, H, S, hd)
    kh = pad_seq(k, sk_pad).transpose(1, 2).repeat_interleave(groups, dim=1).float()
    vh = pad_seq(v, sk_pad).transpose(1, 2).repeat_interleave(groups, dim=1)
    dev = q.device
    kpos_all = torch.arange(sk + sk_pad, device=dev)
    outs = []
    for iq in range(nq):
        qc = qh[:, :, iq * cq:(iq + 1) * cq]
        qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        for ik in range(nk):
            kc = kh[:, :, ik * ck:(ik + 1) * ck]
            vc = vh[:, :, ik * ck:(ik + 1) * ck]
            kpos = kpos_all[ik * ck:(ik + 1) * ck]
            s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if sk_pad:
                mask &= kpos[None, :] < sk
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p.to(vc.dtype).float(), vc.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2).transpose(1, 2)[:, :sq]
    return out.to(q.dtype)


def kernel_symbol(dtype: torch.dtype) -> str:
    """The launcher that serves ``dtype``: tensor cores for bf16, CUDA cores
    for f32."""
    if dtype not in KERNELS:
        raise TypeError(f"flash_attention: q, k, v must share f32 or bf16, got {dtype}")
    return KERNELS[dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    query_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention; see ``flash_attention_torch`` for the contract.

    CUDA tensors launch the kernel (any lengths; the chunk sizes only shape
    the plain version), CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, query_chunk=query_chunk,
                                     kv_chunk=kv_chunk)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Sq, H, hd) and k, v (B, Sk, KV, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share f32 or bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    symbol = kernel_symbol(q.dtype)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must be 16-byte aligned (TMA)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.launcher("flash_attention", symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kvh,
            hd, _scale(hd), int(causal), int(window), int(q_offset), stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


#: kernel launches so far (one per call that reached the card)
flash_attention.launches = 0
