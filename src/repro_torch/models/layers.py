"""Shared building blocks of the transformer and of Zamba2's shared attention
block: port of ``repro/models/layers.py``.

The public functions keep the reference's layouts: activations
``(B, S, H, hd)``, caches ``(L, B, KV, S, hd)``, weights ``(d_in, d_out)``.
Parameters are passed as ``ParamTree`` modules and read with the
reference's keys. On CUDA tensors ``mea_attention`` launches K3
(``kernels.flash_attention``; its gradient launches K3's backward kernel)
and ``decode_attention`` launches K4 (``kernels.flash_decode``); on CPU
tensors they run the kernels' plain versions, which repeat the reference's
arithmetic.

``moe`` is the reference's dropping MoE: its routing, capacity and drop
order, with the expert products as batched matmuls (cuBLAS), outside any
kernel as in the reference. ``sinusoidal_positions`` is Whisper's fixed
position table.

Split over the ``model`` ranks (the caller passes the model axis's mesh,
``transformer.model_split``), a weight of axes ``("embed", "heads"|"kv"|
"ffn")`` is column-parallel: the rank holds some output columns and
computes them from the whole input. One of axes ``("heads"|"ffn",
"embed")`` is row-parallel: the rank's rows give a partial sum, which
``linear(..., reduce=mesh)`` sums over the ranks before the bias. ``mlp``
and ``moe`` take ``mesh`` for their split (``moe`` by each expert's columns,
or by whole experts with ``expert_parallel``).
"""
from __future__ import annotations

import functools
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import NEG_INF, FlashAttention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.sharding.parallel import (copy_to_model, gather_from_model, mean_over,
                                           reduce_from_model, sum_over_model)


class ParamTree(nn.Module):
    """Parameters and sub-trees under the reference's keys, read as
    ``p["w"]`` and tested as ``"b" in p``."""

    def __init__(self, items: Mapping[str, object]):
        super().__init__()
        for key, value in items.items():
            setattr(self, key, value)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class ModelTree(ParamTree):
    """A whole model's parameters (Zamba2's, xLSTM's) that also carries
    ``axes``: each ``state_dict`` name's logical axes, the reference's
    without the stacked "layers" axis, as ``transformer.Transformer`` does."""

    def __init__(self, items: Mapping[str, object], axes: Mapping[str, Tuple]):
        super().__init__(items)
        self.axes = dict(axes)


# ---------------------------------------------------------------------------
# Norms / projections
# ---------------------------------------------------------------------------


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def rmsnorm_split(p, x: torch.Tensor, eps: float, mesh, tag: str, leaves_tag: str
                  ) -> torch.Tensor:
    """``rmsnorm`` over a last dim split contiguously over the model ranks:
    ``x`` is this rank's slice. The sum of squares is summed over the ranks
    (``sum_over_model``, counted under ``tag``) and divided by the whole
    dim. The scale is whole on every rank (its axes are ``("embed",)``);
    the rank uses its slice, so its gradient is summed over the ranks
    (``copy_to_model`` under ``leaves_tag``)."""
    xf = x.float()
    w = x.shape[-1]
    ss = sum_over_model(torch.sum(xf * xf, dim=-1, keepdim=True), mesh, tag)
    y = xf * torch.rsqrt(ss / (w * mesh.size) + eps)
    scale = copy_to_model(p["scale"], mesh, leaves_tag).narrow(0, mesh.rank * w, w)
    return (y * scale).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """QK-norm: rmsnorm over the head_dim axis (qwen3)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale).to(x.dtype)


def linear(p, x: torch.Tensor, reduce=None, tag: str = "") -> torch.Tensor:
    """``x @ w + b``. ``reduce`` (the model axis's mesh): ``w`` holds this
    rank's rows of a row-parallel weight, and the partial products are
    summed over the ranks (counted under ``tag``) before the bias."""
    y = x @ p["w"]
    if reduce is not None:
        y = reduce_from_model(y, reduce, tag)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); positions: (..., seq). Split-half
    rotation, angles in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_streams(head_dim: int, sections: Tuple[int, ...]) -> List[int]:
    """The stream (0 t, 1 h, 2 w) of each of the ``head_dim / 2`` frequency
    slots: ``sections[i]`` slots of stream i in order, cut or padded with the
    last stream to ``head_dim / 2`` as ``jnp.repeat(...,
    total_repeat_length=)`` does."""
    ids = [i for i, n in enumerate(sections) for _ in range(n)][:head_dim // 2]
    return ids + [ids[-1] if ids else 0] * (head_dim // 2 - len(ids))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's multi-dimensional RoPE. x: (..., seq, n_heads, head_dim);
    ``positions3``: (3, ..., seq), the temporal, height and width position
    of each token. Frequency slot j rotates by its own stream's position
    times ``freqs[j]``, angles in f32. The reference selects the stream by a
    one-hot product summed over the three (adding two exact zeros); an index
    gives the same bits."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                             # (hd/2,)
    angles_all = positions3[..., None].float() * freqs                  # (3, ..., seq, hd/2)
    sel = torch.tensor(mrope_streams(hd, sections), device=x.device)
    angles = torch.gather(angles_all, 0, sel.expand(angles_all.shape[1:])[None])[0]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _sinusoid_table(seq: int, d: int) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32)[None, :]
    # 10000^(dim/d) correctly rounded to f32, as the reference's f32 power
    # gives it; torch's f32 pow is an ulp off on 11 of d 1,280's 640
    # exponents, which moves position 1,500's angle by up to 3e-5
    div = torch.pow(torch.tensor(10000.0, dtype=torch.float64), (dim / d).double()).float()
    angle = pos / div
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


@functools.lru_cache(maxsize=16)
def _sinusoid_on(seq: int, d: int, device: torch.device) -> torch.Tensor:
    return _sinusoid_table(seq, d).to(device)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings, ``(seq, d)`` f32:
    ``[sin(angle), cos(angle)]`` with ``angle = pos / 10000^(dim / d)`` for
    even ``dim``, in the reference's order (power, divide, sin and cos,
    concatenate). The angles equal the reference's bit for bit; sin and cos
    are within an ulp of its. Built on the host and moved to ``device``
    once per ``(seq, d, device)``, so the card reads the host's bits and a
    decode step sends nothing: the same tensor is returned to every caller,
    who must not write to it."""
    return _sinusoid_on(int(seq), int(d), torch.device(device or "cpu"))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def mea_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  query_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """Flash attention. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H a multiple
    of KV (GQA); ``q_offset`` is the absolute position of q[0]. K3 on the
    card, its gradient K3's backward kernel (``FlashAttention``: one path for
    serving and training, under ``torch.func.grad`` and ``vmap`` too); on the
    host the chunked online softmax of the reference (the chunk sizes shape
    only that plain version) and the plain gradient. K3 writes the
    log-sum-exp its backward takes only in grad mode: serving's ``no_grad``
    asks for none."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset, query_chunk, kv_chunk,
                                torch.is_grad_enabled())[0]


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0, **_):
    """Quadratic reference (small shapes only)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qh = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=s.device))
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None] > qpos[:, None] - window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float()).to(v.dtype)
    return o.reshape(b, sq, h, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_positions: torch.Tensor, q_position: int, *,
                     window: int = 0, return_lse: bool = False):
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: (B, H, hd); caches: (B, KV, S, hd); k_positions: (S,) int32 absolute
    positions of each cache slot (-1 for empty); ``q_position`` a host int.
    K4 on the card, the reference's softmax on the host. ``return_lse``: the
    per-rank form of a cache split by sequence, ``(o f32, lse)`` over these
    slots (``flash_decode``), for ``sharding.parallel.merge_decode_partials``.
    """
    return flash_decode(q, k_cache, v_cache, k_positions, q_position, window=window,
                        return_lse=return_lse)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer-stacked KV cache.

    k, v: (L, B, KV, S, hd). ``S`` is the full max length for dense attention
    or the window size for SWA (ring buffer). ``pos``: number of tokens
    already written, a host int (the reference keeps a device int32), so the
    decode loop never waits on the card to read it.

    On a mesh whose rules split the cache by sequence (``kv_seq`` over
    ``model``), a rank's k and v hold slots ``[start, start + S_local)`` of
    a cache of ``slots`` (``launch.shardings.local_cache``): ``capacity`` is
    then the whole cache's, which the ring's slot and the slots' positions
    are taken modulo. ``slots`` 0 means the tensors hold the whole cache.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: int
    slots: int = 0
    start: int = 0

    @property
    def capacity(self) -> int:
        return self.slots or self.k.shape[3]


def make_kv_cache(num_layers: int, batch: int, kv_heads: int, capacity: int,
                  head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (num_layers, batch, kv_heads, capacity, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def cache_slot_positions(pos: int, capacity: int, ring: bool, device=None) -> torch.Tensor:
    """Absolute position held by each cache slot (-1 if empty), int32."""
    idx = torch.arange(capacity, dtype=torch.int32, device=device)
    if not ring:
        return torch.where(idx < pos, idx, -1).to(torch.int32)
    # ring: slot i holds position p = last write to that slot
    p = pos - 1 - torch.remainder(pos - 1 - idx, capacity)
    return torch.where((p >= 0) & (p < pos), p, -1).to(torch.int32)


def cache_write(k_layer: torch.Tensor, v_layer: torch.Tensor, pos: int,
                k_new: torch.Tensor, v_new: torch.Tensor, ring: bool,
                capacity: int = 0, start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V (B, KV, hd) at position ``pos`` (mod cap if ring).

    Writes the slot in place (a copy into the slot's view; ``pos`` is a host
    int, so nothing is sent to the card) and returns the same two tensors.
    The reference selects over the whole sequence axis and relies on buffer
    donation; eagerly, that select would allocate a copy of the layer's cache
    every step, which at Qwen2.5-14B scale is the whole cache once per step.

    ``capacity`` and ``start`` (a rank's slice of a cache split by sequence:
    ``KVCache.slots`` and ``KVCache.start``): the slot is taken in the whole
    cache of ``capacity`` slots, and only the rank whose slice holds it
    writes it.
    """
    slot = pos % (capacity or k_layer.shape[2]) if ring else pos
    if capacity:
        slot -= start
        if not 0 <= slot < k_layer.shape[2]:
            return k_layer, v_layer
    k_layer[:, :, slot].copy_(k_new)
    v_layer[:, :, slot].copy_(v_new)
    return k_layer, v_layer


# ---------------------------------------------------------------------------
# Gated MLP + MoE
# ---------------------------------------------------------------------------


def make_mlp(pf, d: int, ff: int) -> "ParamTree":
    """``pf(name, shape, axes)`` makes one weight (``transformer.make_params``)."""
    return ParamTree({
        "wi": pf("wi", (d, ff), ("embed", "ffn")),
        "wg": pf("wg", (d, ff), ("embed", "ffn")),
        "wo": pf("wo", (ff, d), ("ffn", "embed")),
    })


def mlp(p, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The gated MLP; with ``mesh`` (the model axis) ``wi``/``wg`` hold this
    rank's columns and ``wo`` its rows, and the output is reduced."""
    if mesh is not None:
        x = copy_to_model(x, mesh, "mlp_in")
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    if mesh is None:
        return h @ p["wo"]
    return reduce_from_model(h @ p["wo"], mesh, "mlp_out")


def make_moe(pf, d: int, ff: int, num_experts: int) -> "ParamTree":
    """The router ``(d, E)`` and the experts' gated MLPs stacked on axis 0."""
    return ParamTree({
        "router": pf("router", (d, num_experts), ("embed", "experts")),
        "wi": pf("wi", (num_experts, d, ff), ("experts", "embed", "ffn")),
        "wg": pf("wg", (num_experts, d, ff), ("experts", "embed", "ffn")),
        "wo": pf("wo", (num_experts, ff, d), ("experts", "ffn", "embed")),
    })


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor         # load-balance loss (Switch-style), f32 scalar
    expert_tokens: torch.Tensor    # (E,) int32 tokens routed per expert (pre-capacity)


class MoERoute(NamedTuple):
    """Where ``moe`` sends each token: the router's f32 probabilities
    ``(T, E)``, the normalised gates and expert ids of the top k ``(T, k)``,
    each flattened (token, k) assignment's position in its expert and
    whether it fits the capacity ``(T*k,)``, and the counts per expert."""

    probs: torch.Tensor
    gate_vals: torch.Tensor
    expert_ids: torch.Tensor
    pos_in_expert: torch.Tensor
    keep: torch.Tensor
    expert_tokens: torch.Tensor
    capacity: int


def moe_route(router: torch.Tensor, xt: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, deterministic_capacity: int = 0,
              logits: Optional[torch.Tensor] = None, batch=None) -> MoERoute:
    """The routing of ``moe`` for tokens ``xt`` (T, d): top-k experts by
    router probability and the capacity's drops. ``C = int(max(1, cf * k *
    T / E))``, a floor as the reference computes it, or
    ``deterministic_capacity``; the drops follow the order of the flattened
    (token, k) assignments. ``logits`` (T, E), when given, stand for
    ``xt @ router`` (the expert-parallel router's, gathered).

    ``batch`` (the ``data`` axis's mesh; each rank holds one block of the
    batch's tokens, in rank order) routes the whole batch: T is the whole
    count, each assignment's position counts the earlier ranks' assignments
    to its expert (their counts are gathered), and ``expert_tokens`` are the
    whole batch's; the positions stay the rank's own tokens'."""
    t, e = xt.shape[0], num_experts
    if logits is None:
        logits = xt @ router
    # the router product in the model's dtype, then f32, as the reference
    # computes it: in bf16 a router computed in f32 routes differently
    probs = torch.softmax(logits.float(), dim=-1)                         # (T, E)
    # lax.top_k: the larger value first, the lower expert index first among
    # equals; a stable descending sort promises that order, torch.topk not
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[:, :top_k], expert_ids[:, :top_k]  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # position of each token-major assignment within its expert: a running
    # count over the one-hot, so that the drops follow the assignment order
    onehot = (expert_ids.reshape(-1, 1) == torch.arange(e, device=xt.device)
              ).to(torch.int32)                                           # (T*k, E)
    pos_in_expert = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    counts = onehot.sum(dim=0, dtype=torch.int32)
    if batch is not None:
        every = gather_from_model(counts[None], batch, "moe_counts", dim=0)   # (D, E)
        pos_in_expert = pos_in_expert + every[:batch.rank].sum(0)[expert_ids.reshape(-1)]
        counts = every.sum(dim=0, dtype=torch.int32)
        t = t * batch.size
    cap = deterministic_capacity or int(max(1, capacity_factor * top_k * t / e))
    return MoERoute(probs, gate_vals, expert_ids, pos_in_expert, pos_in_expert < cap,
                    counts, cap)


def moe(p, x: torch.Tensor, *, num_experts: int, top_k: int, capacity_factor: float,
        deterministic_capacity: int = 0, token_chunk: int = 0, mesh=None,
        expert_parallel: bool = False, batch=None) -> Tuple[torch.Tensor, MoEStats]:
    """Dropping MoE with scatter-based dispatch: ``repro/models/layers.py::moe``.

    x: (B, S, d). Tokens go where ``moe_route`` sends them; the overflow of
    each expert's capacity is dropped. ``deterministic_capacity`` sets the
    capacity (decode: ``B * k``, drop-free). ``token_chunk``: route chunks
    of that many tokens one after another (capacity per chunk); the aux loss
    is the chunks' mean and ``expert_tokens`` their sum.

    Out of place throughout (``index_add``, never ``index_add_``), so that
    autograd and ``torch.func.vmap`` take it as the training plans do.

    ``mesh`` (the model axis) splits it over the model ranks. Every rank
    routes from the same full router logits, so routing, drops and the aux
    loss are the same bits on each. The tensor-parallel baseline holds each
    expert's ``d_ff`` columns (``wi``/``wg``) and rows (``wo``) in part, and
    the router whole. ``expert_parallel`` holds whole experts, E/m of them
    (rank r the r-th block), and the router's columns for them: the logits
    are gathered before routing. Either way the rank's experts give a
    partial output per token, which is summed over the ranks after the
    combine; the gates' gradient is summed too, each rank holding the part
    its experts give.

    ``batch`` (the ``data`` axis's mesh, ``x`` the rank's block of the
    batch) keeps the whole batch's routing: capacity and drop order as
    ``moe_route`` gives them over the whole batch, and the aux loss of the
    whole batch's means (``mean_over``). The rank fills the dispatch
    buffer's slots of its own tokens only. With ``token_chunk``, chunks of
    the whole batch must not straddle two ranks' blocks, and each routes on
    its own rank.
    """
    b, s, d = x.shape
    if batch is not None and token_chunk and b * s * batch.size > token_chunk and (
            b * s * batch.size) % token_chunk == 0:
        if (b * s) % token_chunk:
            raise NotImplementedError(
                f"moe: chunks of {token_chunk} tokens straddle the data ranks' blocks of "
                f"{b * s}")
        batch = None
    if token_chunk and b * s > token_chunk and (b * s) % token_chunk == 0:
        chunks = x.reshape(-1, token_chunk, d)
        outs = [moe(p, xc[None], num_experts=num_experts, top_k=top_k,
                    capacity_factor=capacity_factor,
                    deterministic_capacity=deterministic_capacity, mesh=mesh,
                    expert_parallel=expert_parallel) for xc in chunks]
        out = torch.cat([y[0] for y, _ in outs]).reshape(b, s, d)
        return out, MoEStats(torch.stack([st.aux_loss for _, st in outs]).mean(),
                             torch.stack([st.expert_tokens for _, st in outs]).sum(
                                 0, dtype=torch.int32))
    t = b * s
    xt = x.reshape(t, d)
    e = num_experts
    logits = None
    if mesh is not None and expert_parallel:
        logits = gather_from_model(copy_to_model(xt, mesh, "router_in") @ p["router"],
                                   mesh, "router_logits", dim=-1)
    r = moe_route(p["router"], xt, num_experts=e, top_k=top_k,
                  capacity_factor=capacity_factor,
                  deterministic_capacity=deterministic_capacity, logits=logits, batch=batch)

    # load-balance aux loss (Switch/Mixtral): E * sum_e f_e * p_e
    me = r.probs.mean(dim=0)                                              # (E,)
    fe = (r.expert_ids[:, :1] == torch.arange(e, device=x.device)).float().mean(dim=0)
    if batch is not None:
        fe, me = mean_over(torch.stack([fe, me]), batch, "moe_aux").unbind(0)
    aux = e * torch.sum(fe * me)

    # dispatch into an (E, C, d) buffer; a dropped assignment adds 0 * x
    # into slot (e, 0) as the reference's does, which changes no bit there
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(top_k)
    keep, ids, el = r.keep, r.expert_ids.reshape(-1), e
    if mesh is not None:
        xt = copy_to_model(xt, mesh, "moe_in")
        if expert_parallel:
            # this rank's experts; another's assignment is dropped here
            el = e // mesh.size
            ids = ids - mesh.rank * el
            keep = keep & (ids >= 0) & (ids < el)
            ids = torch.where(keep, ids, 0)
    slot = ids * r.capacity + torch.where(keep, r.pos_in_expert, 0)
    src = keep.to(x.dtype)[:, None] * xt[flat_tok]
    buf = torch.zeros((el * r.capacity, d), dtype=x.dtype, device=x.device).index_add(
        0, slot, src).reshape(el, r.capacity, d)

    # the expert products, batched over experts (cuBLAS)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    y = torch.bmm(h, p["wo"]).reshape(el * r.capacity, d)                # (E*C, d)

    # combine: gather back and weight. At top-2 each token sums exactly two
    # terms into a zero row, and a + b == b + a in floating point: the
    # combine is exact in any order of the adds
    gates = (r.gate_vals.reshape(-1) * r.keep).to(y.dtype)
    if mesh is not None:
        gates = copy_to_model(gates, mesh, "moe_gates") * keep.to(y.dtype)
    weighted = y[slot] * gates[:, None]
    out = torch.zeros((t, d), dtype=y.dtype, device=x.device).index_add(0, flat_tok, weighted)
    if mesh is not None:
        out = reduce_from_model(out, mesh, "moe_out")
    return out.reshape(b, s, d), MoEStats(aux, r.expert_tokens)
