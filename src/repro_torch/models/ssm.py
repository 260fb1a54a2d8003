"""Mamba2 blocks through the chunked SSD (state-space duality): port of
``repro/models/ssm.py``.

The selective SSM recurrence per head h with scalar decay

    S_t = a_t * S_{t-1} + dt_t * x_t (outer) B_t        S in R^{p x n}
    y_t = S_t C_t + D * x_t

runs in chunks: inside a chunk a decay-masked quadratic term (products,
cuBLAS on the card), across chunks the running state, carried by a Python
loop where the reference scans. Decode is the O(1) single-step update.
The reference's arithmetic is plain JAX, not Pallas, so the port is plain
PyTorch: no kernel of its own.

Dtypes follow the reference's promotions: ``ssd_chunked`` computes in f32
(the cumulative log decay and its differences in f64, ``cumsum64``, each
rounded once to f32) and rounds ``y`` to the input's dtype; the decode step's ``y`` stays f32,
so in a bf16 model the skip term, the gate, the norm and ``out_proj``'s
product run in f32 there (JAX promotes; ``torch.matmul`` needs the weight
upcast by hand) before the block's output rounds back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import _make_rmsnorm
from repro_torch.sharding.parallel import copy_to_model, gather_for_model, reduce_from_model

NEG = -1e30     # the reference's mask value; stays finite in f32


def cumsum64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The cumulative sum of a log decay, in f64. The scans exponentiate its
    differences (``exp(cum_i - cum_j)``), and |cum| reaches the hundreds to
    thousands inside a chunk while the differences that carry weight are
    a few units: in f32 an ulp of cum is ~1e-4 of such a weight, and two
    evaluations (the card's, the host's, the reference's) part there. So
    the sum and its differences are taken in f64 and rounded once to f32;
    the arithmetic is the reference's, the cancellation is not."""
    return torch.cumsum(x.double(), dim=dim)


def make_mamba2_params(pf, cfg: ModelConfig) -> ParamTree:
    """One layer's parameters; ``pf`` is ``transformer._Factory`` scoped to
    the layer (``mamba.{i}``)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d                      # inner dim
    h, n = cfg.ssm_heads, cfg.ssm_state
    conv_dim = di + 2 * n                        # x, B, C go through the depthwise conv
    f32 = torch.float32
    return ParamTree({
        "norm": _make_rmsnorm(pf, "norm", d),
        "in_proj": pf("in_proj", (d, 2 * di + 2 * n + h), ("embed", "ffn")),
        "conv_w": pf("conv_w", (cfg.ssm_conv_width, conv_dim), ("conv", "ffn")),
        "conv_b": pf("conv_b", (conv_dim,), ("ffn",), init="zeros"),
        "a_log": pf("a_log", (h,), (None,), init="ssm_a", dtype=f32),
        "dt_bias": pf("dt_bias", (h,), (None,), init="zeros", dtype=f32),
        "d_skip": pf("d_skip", (h,), (None,), init="ones", dtype=f32),
        "out_norm": _make_rmsnorm(pf, "out_norm", di),
        "out_proj": pf("out_proj", (di, d), ("ffn", "embed")),
    })


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"_split_proj: {dt.shape[-1]} dt columns for {h} heads")
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence. xbc: (B, S, C); w: (W, C).
    ``state``: (B, W-1, C), the trailing context of earlier tokens (decode).
    Returns (out, new_state). The taps are summed in the reference's order,
    in the activation's dtype: in bf16 that order is part of the result."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros(xbc.shape[:1] + (width - 1,) + xbc.shape[2:], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                         # (B, S+W-1, C)
    s = xbc.shape[1]
    out = full[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + full[:, i:i + s] * w[i]
    out = F.silu(out + b.to(out.dtype))
    return out, full[:, -(width - 1):]


class SSDState(NamedTuple):
    state: torch.Tensor     # (B, H, p, n) f32
    conv: torch.Tensor      # (B, W-1, conv_dim)


def ssd_chunked(x: torch.Tensor, a_log_dt: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan. x: (B, S, H, p); a_log_dt: (B, S, H), the log decay
    of each step (negative); b_mat, c_mat: (B, S, N) f32. Returns (y in x's
    dtype, final state (B, H, p, N) f32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        # a zero-padded tail: a = 0 (decay 1, the state kept) and B = 0 (no
        # input), so the final state is exact; the padded outputs are cut
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log_dt = F.pad(a_log_dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    state = initial_state
    if state is None:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))[None, :, :, None]
    ys = []
    for start in range(0, s, c):
        piece = slice(start, start + c)
        xc = x[:, piece].float()
        ac, bc, cc = a_log_dt[:, piece], b_mat[:, piece], c_mat[:, piece]
        cum64 = cumsum64(ac, 1)                                         # (B,c,H)
        cum, total64 = cum64.float(), cum64[:, -1]
        total = total64.float()                                         # (B,H)
        # within the chunk: decay(i, j) = exp(cum_i - cum_j), j <= i. Masked
        # BEFORE the exp: the upper triangle's exp would be inf and poison
        # the backward with 0 * inf
        dec = (cum64[:, :, None, :] - cum64[:, None, :, :]).float()     # (B,c,c,H)
        dmat = torch.exp(torch.where(tri, dec, NEG))
        scores = torch.einsum("bin,bjn->bij", cc, bc)                   # (B,c,c)
        w = scores[..., None] * dmat                                    # (B,c,c,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
        # across chunks: y_i += C_i . (exp(cum_i) * state)
        y_inter = torch.einsum("bin,bhpn->bihp", cc, state) * torch.exp(cum)[..., None]
        # state' = exp(total) * state + sum_j exp(total - cum_j) B_j x_j
        carry_dec = torch.exp((total64[:, None] - cum64).float())        # (B,c,H)
        contrib = torch.einsum("bjn,bjhp,bjh->bhpn", bc, xc, carry_dec)
        state = torch.exp(total)[:, :, None, None] * state + contrib
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    if pad:
        y = y[:, :s_orig]
    return y.to(x.dtype), state


def mamba2_block(cfg: ModelConfig, mp, x: torch.Tensor, *, chunk: int = 256,
                 state: Optional[SSDState] = None, single_step: bool = False,
                 mesh=None) -> Tuple[torch.Tensor, SSDState]:
    """The Mamba2 mixer. x: (B, S, d). Returns (out in x's dtype, the new
    state). ``single_step``: the O(1) decode update of one token.

    ``mesh`` (the model axis, ``transformer.Split.ssm``): the rank holds a
    contiguous block of ``in_proj``'s columns ``[z | x | B | C | dt]``, of
    the conv's channels ``[x | B | C]`` and of ``out_proj``'s rows, which
    are its SSM heads; the blocks of the first two are not its heads'. So
    the rank's columns of ``x @ in_proj`` are gathered whole over ``model``
    (``ssm_proj``), the depthwise conv runs on the rank's channels (with its
    part of the conv state) and its output is gathered whole (``ssm_conv``),
    and the rank then takes its heads of x, z and dt, and B and C whole. The
    scan runs on its heads (its part of the SSM state), ``out_norm`` over
    the split inner dim (``layers.rmsnorm_split``), and ``out_proj``'s
    partial products are summed (``ssm_out``). The whole f32 leaves
    (``a_log``, ``dt_bias``, ``d_skip``) are read at the rank's heads, their
    gradients summed over the ranks (``ssm_leaves``)."""
    di = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.ssm_heads
    p_dim = di // h
    bsz, s, _ = x.shape
    out_dtype = x.dtype
    a_log, dt_bias, d_skip = mp["a_log"], mp["dt_bias"], mp["d_skip"]
    conv_state = state.conv if state is not None else None
    if mesh is None:
        hl, h0 = h, 0
        zxbcdt = x @ mp["in_proj"]
    else:
        hl = h // mesh.size
        h0 = mesh.rank * hl
        x = copy_to_model(x, mesh, "ssm_in")
        zxbcdt = gather_for_model(x @ mp["in_proj"], mesh, "ssm_proj")
        a_log, dt_bias, d_skip = (copy_to_model(t, mesh, "ssm_leaves").narrow(0, h0, hl)
                                  for t in (a_log, dt_bias, d_skip))
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    if mesh is None:
        xbc, new_conv = _causal_conv(xbc, mp["conv_w"], mp["conv_b"], conv_state)
    else:
        cw = mp["conv_w"].shape[1]
        out, new_conv = _causal_conv(xbc.narrow(-1, mesh.rank * cw, cw), mp["conv_w"],
                                     mp["conv_b"], conv_state)
        xbc = gather_for_model(out, mesh, "ssm_conv")
    cols = slice(h0 * p_dim, (h0 + hl) * p_dim)
    xs = xbc[..., cols].reshape(bsz, s, hl, p_dim)
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]
    z, dt = z[..., cols], dt[..., h0:h0 + hl]

    # jax.nn.softplus has no threshold; F.softplus returns x above 20, where
    # the two differ by log1p(exp(-20)) < 2.1e-9
    dt = F.softplus(dt.float() + dt_bias)                                # (B,S,H) f32
    a = -torch.exp(a_log)                                                # (H,) negative
    a_log_dt = a * dt                                                    # log decay
    x_in = xs * dt[..., None].to(xs.dtype)

    if single_step:
        # S' = exp(a dt) S + dt x (outer) B, all in f32
        prev = state.state if state is not None else torch.zeros(
            (bsz, hl, p_dim, n), dtype=torch.float32, device=x.device)
        decay = torch.exp(a_log_dt[:, 0])                                # (B,H)
        contrib = torch.einsum("bn,bhp->bhpn", b_mat[:, 0].float(), x_in[:, 0].float())
        new_s = decay[..., None, None] * prev + contrib
        y = torch.einsum("bhpn,bn->bhp", new_s, c_mat[:, 0].float())
        y = y.reshape(bsz, 1, hl, p_dim)                                 # f32
    else:
        y, new_s = ssd_chunked(x_in, a_log_dt, b_mat.float(), c_mat.float(), chunk,
                               state.state if state is not None else None)

    # decode's y is f32 and promotes what follows to f32, as JAX does
    y = y + xs * d_skip[None, None, :, None].to(xs.dtype)
    y = y.reshape(bsz, 1 if single_step else s, hl * p_dim)
    if mesh is None:
        y = L.rmsnorm(mp["out_norm"], y * F.silu(z), cfg.norm_eps)
        out = y @ mp["out_proj"].to(y.dtype)
    else:
        y = L.rmsnorm_split(mp["out_norm"], y * F.silu(z), cfg.norm_eps, mesh, "ssm_norm",
                            "ssm_leaves")
        out = reduce_from_model(y @ mp["out_proj"].to(y.dtype), mesh, "ssm_out")
    return out.to(out_dtype), SSDState(new_s.float(), new_conv)
