"""K3: causal GQA flash attention with an optional sliding window, and its
gradient.

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

K3's gradient has no TPU kernel: the JAX package differentiates
``mea_attention`` by autodiff. Here ``flash_attention_bwd`` launches
``csrc/flash_attention_bwd.cu`` (dq, dk and dv from the row statistics it
recomputes; f32 sums on the CUDA cores for both dtypes) for CUDA tensors and
runs ``flash_attention_bwd_torch``, the gradient written out step by step,
for CPU tensors. ``FlashAttention`` is the ``torch.autograd.Function`` that
pairs the two, usable under ``torch.func.grad`` and ``vmap``: its ``vmap``
rules fold the vmapped dimension into B, since attention is independent per
batch row and a ctypes launch cannot be traced.
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
#: the gradient's launcher of each dtype in ``csrc/flash_attention_bwd.cu``
BWD_KERNELS = {torch.bfloat16: "flash_attention_bwd_bf16_launch",
               torch.float32: "flash_attention_bwd_f32_launch"}


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


def kernel_symbol(dtype: torch.dtype, kernels=KERNELS) -> str:
    """The launcher that serves ``dtype``: tensor cores for bf16, CUDA cores
    for f32 (``BWD_KERNELS``: the gradient's, CUDA cores for both)."""
    if dtype not in kernels:
        raise TypeError(f"flash_attention: q, k, v must share f32 or bf16, got {dtype}")
    return kernels[dtype]


def _check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *rest: torch.Tensor, kernels=KERNELS) -> str:
    """Raise on what the kernels do not take; the launcher's symbol. ``rest``
    are further tensors shaped like q (the gradient's o and dout)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Sq, H, hd) and k, v (B, Sk, KV, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k, v {tuple(k.shape)}")
    if any(t.shape != q.shape for t in rest):
        raise ValueError(f"{name}: o and dout must have q's shape {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    tensors = (q, k, v) + rest
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v must share f32 or bf16, got "
                        f"{[t.dtype for t in tensors]}")
    symbol = kernel_symbol(q.dtype, kernels)
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: q, k and v must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    return symbol


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
    symbol = _check_inputs("flash_attention", q, k, v)
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
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


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0, q_offset: int = 0):
    """Plain PyTorch version of K3's gradient: ``(dq, dk, dv)`` of
    ``flash_attention_torch`` at ``out`` for the output gradient ``dout``.

    The kernel's arithmetic, in f32, with P the softmax over the valid keys
    (0 on a row with none):

        D = rowsum(dout * out); dP = dout V^T; dS = P (dP - D)
        dq = scale dS K; dk = scale dS^T Q; dv = P^T dout

    dk and dv sum the query heads of each KV head's group. The gradients
    come back in the inputs' dtypes.
    """
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    groups = h // kvh
    scale = _scale(hd)
    heads = lambda x: x.transpose(1, 2).float()                          # noqa: E731
    qh, oh, doh = heads(q), heads(out), heads(dout)                       # (B, H, Sq, hd)
    kh = heads(k).repeat_interleave(groups, dim=1)                        # (B, H, Sk, hd)
    vh = heads(v).repeat_interleave(groups, dim=1)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= kpos > qpos - window
    # the row statistics over the valid keys, as the kernel recomputes them
    s = torch.where(valid, torch.matmul(qh, kh.transpose(-1, -2)) * scale, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    p = e * torch.where(l > 0, 1.0 / torch.clamp(l, min=1e-30), 0.0)
    d = (doh * oh).sum(dim=-1, keepdim=True)                              # (B, H, Sq, 1)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - d)
    dq = torch.matmul(ds, kh) * scale
    group_sum = lambda x: x.reshape(b, kvh, groups, sk, hd).sum(dim=2)    # noqa: E731
    dk = group_sum(torch.matmul(ds.transpose(-1, -2), qh)) * scale
    dv = group_sum(torch.matmul(p.transpose(-1, -2), doh))
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """K3's gradient; see ``flash_attention_bwd_torch`` for the contract.

    CUDA tensors launch ``csrc/flash_attention_bwd.cu`` (two kernels, one
    count), CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_torch(q, k, v, out, dout, causal=causal,
                                         window=window, q_offset=q_offset)
    symbol = _check_inputs("flash_attention_bwd", q, k, v, out, dout, kernels=BWD_KERNELS)
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # m, 1 / l and D per (batch, head, row), written by the first kernel
    stats = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.launcher("flash_attention_bwd", symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, sq, sk, h,
            kvh, hd, _scale(hd), int(causal), int(window), int(q_offset), stream)
    _build.check("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: gradient calls that reached the card (each launches its two kernels)
flash_attention_bwd.launches = 0


def _fold(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """A vmapped ``(.., B, ...)`` operand as ``(n * B, ...)``, contiguous; an
    unbatched one (``dim`` None) repeated n times."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


class FlashAttentionBackward(torch.autograd.Function):
    """K3's gradient as an op of its own, so that ``FlashAttention``'s
    backward also runs under ``vmap`` (``vmap(grad(f))`` hands it batched
    tensors). Its own gradient (a second derivative) is not provided."""

    @staticmethod
    def forward(q, k, v, out, dout, causal, window, q_offset):
        return flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                   out.contiguous(), dout.contiguous(), causal=causal,
                                   window=window, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention: no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, dout, causal, window, q_offset):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in zip((q, k, v, out, dout), in_dims[:5])]
        grads = FlashAttentionBackward.apply(*args, causal, window, q_offset)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with K3's gradient: the forward launches K3 (the
    plain version on the host), the backward ``flash_attention_bwd``. Works
    under ``torch.autograd``, ``torch.func.grad`` and ``torch.func.vmap``."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset, query_chunk, kv_chunk):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, q_offset=q_offset,
                               query_chunk=query_chunk, kv_chunk=kv_chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs[:6]
        ctx.save_for_backward(q, k, v, output)
        ctx.opts = (causal, window, q_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(q, k, v, out, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset, query_chunk, kv_chunk):
        n = info.batch_size
        q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        out = FlashAttention.apply(q, k, v, causal, window, q_offset, query_chunk,
                                   kv_chunk)
        return _unfold(out, n), 0
