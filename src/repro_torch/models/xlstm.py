"""xLSTM blocks: port of ``repro/models/xlstm.py`` (arXiv:2405.04517).

The mLSTM (matrix memory) recurrence

    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

is a gated linear attention, computed chunk-parallel as Mamba2's SSD is
(a decay-masked quadratic term inside a chunk, the state carried across
chunks by a Python loop), with the gate products in log space and a
running stabiliser. The sLSTM's stabiliser max is not associative, so it is
a Python loop over time with block-diagonal recurrent weights per head.
Both are plain JAX in the reference, so plain PyTorch here: no kernel of
their own. Every dtype cast is the reference's, one for one, but for the
forget gates' cumulative log and its differences, taken in f64 as the
SSD's are (``ssm.cumsum64``); the sLSTM block's gelu is the tanh
approximation, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamTree
from repro_torch.models.ssm import cumsum64
from repro_torch.models.transformer import _make_rmsnorm

NEG = -1e30     # the reference's initial stabiliser and mask; finite in f32


def _inv_sqrt(hd: int, device) -> torch.Tensor:
    """``1.0 / jnp.sqrt(hd)``: the square root in f32, then the quotient."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def make_mlstm_params(pf, cfg: ModelConfig) -> ParamTree:
    """One mLSTM layer; ``pf`` is ``transformer._Factory`` scoped to it."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.ssm_heads
    f32 = torch.float32
    return ParamTree({
        "norm": _make_rmsnorm(pf, "norm", d),
        "up_z": pf("up_z", (d, di), ("embed", "ffn")),
        "up_x": pf("up_x", (d, di), ("embed", "ffn")),
        "wq": pf("wq", (di, di), (None, "heads")),
        "wk": pf("wk", (di, di), (None, "heads")),
        "wv": pf("wv", (di, di), (None, "heads")),
        "w_i": pf("w_i", (di, h), ("ffn", None)),          # input gate (per head)
        "w_f": pf("w_f", (di, h), ("ffn", None)),          # forget gate
        "b_i": pf("b_i", (h,), (None,), init="zeros", dtype=f32),
        "b_f": pf("b_f", (h,), (None,), init="ones", dtype=f32),
        "out_norm": _make_rmsnorm(pf, "out_norm", di),
        "down": pf("down", (di, d), ("ffn", "embed")),
    })


class MLSTMState(NamedTuple):
    c: torch.Tensor       # (B, H, hd, hd) matrix memory
    n: torch.Tensor       # (B, H, hd)     normaliser
    m: torch.Tensor       # (B, H)         stabiliser (log-space running max)


def mlstm_cell_chunked(q, k, v, log_i, log_f, chunk: int,
                       state: Optional[MLSTMState] = None
                       ) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunk-parallel mLSTM. q, k, v: (B, S, H, hd); log_i, log_f: (B, S, H).
    The weight of key j for query i is exp(log_i_j + sum_{j<t<=i} log_f_t -
    m_i), m_i the running max of the candidate log weights. S must be a
    multiple of the chunk when it is longer (the reference asserts it)."""
    bsz, s, h, hd = q.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"mlstm_cell_chunked: sequence length {s} is not a multiple of the "
                         f"chunk {c} (S % chunk == 0 once S > chunk)")
    scale = _inv_sqrt(hd, q.device)
    dev = q.device
    if state is None:
        state = MLSTMState(torch.zeros((bsz, h, hd, hd), dtype=torch.float32, device=dev),
                           torch.zeros((bsz, h, hd), dtype=torch.float32, device=dev),
                           torch.full((bsz, h), NEG, dtype=torch.float32, device=dev))
    cmat, nvec, m_prev = state
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))[None, :, :, None]
    hs = []
    for start in range(0, s, c):
        piece = slice(start, start + c)
        qc, kc, vc = (t[:, piece].float() for t in (q, k, v))
        lic, lfc = log_i[:, piece], log_f[:, piece]
        # the forget gates' cumulative log and its differences in f64
        # (``ssm.cumsum64``), each rounded once to f32
        fcum64 = cumsum64(lfc, 1)                             # (B,c,H)
        fcum, ftot64 = fcum64.float(), fcum64[:, -1]
        ftot = ftot64.float()
        tail = (ftot64[:, None] - fcum64).float()             # ftot - fcum_j
        # log weight of in-chunk key j for query i: li_j + fcum_i - fcum_j
        lw = lic[:, None, :, :] + (fcum64[:, :, None, :] - fcum64[:, None, :, :]).float()
        lw = torch.where(tri, lw, NEG)                        # (B,i,j,H)
        # the carried state's log weight for query i: m_prev + fcum_i
        lw_state = m_prev[:, None] + fcum                     # (B,c,H)
        m_i = torch.maximum(torch.amax(lw, dim=2), lw_state)
        m_i = torch.clamp(m_i, min=NEG)
        w = torch.exp(lw - m_i[:, :, None, :])                # (B,i,j,H)
        scores = torch.einsum("bihd,bjhd->bijh", qc, kc) * scale
        sw = scores * w
        num_intra = torch.einsum("bijh,bjhd->bihd", sw, vc)
        den_intra = torch.einsum("bijh,bijh->bih", w, scores)
        w_state = torch.exp(lw_state - m_i)                   # (B,c,H)
        q_state = torch.einsum("bihd,bhde->bihe", qc, cmat) * scale
        num_inter = q_state * w_state[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qc, nvec) * scale * w_state
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])
        # the state in the new stabiliser frame: m_new = max(m_prev + ftot, max li)
        m_new = torch.maximum(m_prev + ftot, torch.amax(lic + tail, dim=1))
        carry_w = torch.exp(m_prev + ftot - m_new)            # (B,H)
        key_w = torch.exp(lic + tail - m_new[:, None])        # (B,c,H)
        cmat = carry_w[..., None, None] * cmat + torch.einsum(
            "bjhd,bjh,bjhe->bhde", kc, key_w, vc)
        nvec = carry_w[..., None] * nvec + torch.einsum("bjhd,bjh->bhd", kc, key_w)
        m_prev = m_new
    hout = torch.cat(hs, dim=1)
    return hout.to(q.dtype), MLSTMState(cmat, nvec, m_prev)


def mlstm_cell_step(q, k, v, log_i, log_f, state: MLSTMState
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """The O(1) decode step. q, k, v: (B, H, hd); log_i, log_f: (B, H)."""
    scale = _inv_sqrt(q.shape[-1], q.device)
    m_new = torch.maximum(log_f + state.m, log_i)
    f_s = torch.exp(log_f + state.m - m_new)
    i_s = torch.exp(log_i - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    c_new = f_s[..., None, None] * state.c + i_s[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = f_s[..., None] * state.n + i_s[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c_new) * scale
    den = torch.einsum("bhd,bhd->bh", qf, n_new) * scale
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    return h.to(q.dtype), MLSTMState(c_new, n_new, m_new)


def mlstm_block(cfg: ModelConfig, mp, x: torch.Tensor, *, chunk: int = 256,
                state: Optional[MLSTMState] = None, single_step: bool = False
                ) -> Tuple[torch.Tensor, MLSTMState]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.ssm_heads
    hd = di // h
    bsz, s, _ = x.shape

    z = F.silu(x @ mp["up_z"])
    u = x @ mp["up_x"]
    q = (u @ mp["wq"]).reshape(bsz, s, h, hd)
    k = (u @ mp["wk"]).reshape(bsz, s, h, hd)
    v = (u @ mp["wv"]).reshape(bsz, s, h, hd)
    log_i = (u @ mp["w_i"]).float() + mp["b_i"]
    log_f = F.logsigmoid((u @ mp["w_f"]).float() + mp["b_f"])

    if single_step:
        if state is None:
            raise ValueError("mlstm_block: a single step needs the state")
        hout, new_state = mlstm_cell_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                          log_f[:, 0], state)
        hout = hout[:, None]
    else:
        hout, new_state = mlstm_cell_chunked(q, k, v, log_i, log_f, chunk, state)

    y = L.rmsnorm(mp["out_norm"], hout.reshape(bsz, -1, di) * z, cfg.norm_eps)
    return (y @ mp["down"]).to(x.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def make_slstm_params(pf, cfg: ModelConfig) -> ParamTree:
    """One sLSTM layer; ``pf`` is ``transformer._Factory`` scoped to it. The
    recurrent weight's fan-in is ``hd`` (``shape[-2]``)."""
    d = cfg.d_model
    h = cfg.ssm_heads
    hd = d // h
    return ParamTree({
        "norm": _make_rmsnorm(pf, "norm", d),
        "w_in": pf("w_in", (d, 4 * d), ("embed", "ffn")),       # z, i, f, o pre-acts
        "r": pf("r", (h, hd, 4 * hd), (None, None, None)),      # block-diag recurrent
        "b": pf("b", (4 * d,), ("ffn",), init="zeros", dtype=torch.float32),
        "out_norm": _make_rmsnorm(pf, "out_norm", d),
        "up": pf("up", (d, 2 * d), ("embed", "ffn")),
        "down": pf("down", (d, d), ("ffn", "embed")),
    })


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, d) cell
    n: torch.Tensor    # (B, d) normaliser
    h: torch.Tensor    # (B, d) hidden
    m: torch.Tensor    # (B, d) stabiliser


def slstm_scan(cfg: ModelConfig, sp, x: torch.Tensor, state: Optional[SLSTMState] = None
               ) -> Tuple[torch.Tensor, SLSTMState]:
    """x: (B, S, d) -> (B, S, d), a Python loop over S (the update is not
    associative)."""
    d = cfg.d_model
    heads = cfg.ssm_heads
    hd = d // heads
    bsz, s, _ = x.shape
    pre_all = (x @ sp["w_in"]).float() + sp["b"]                     # (B,S,4d)
    if state is None:
        z = torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
        state = SLSTMState(z, z, z, torch.full((bsz, d), NEG, dtype=torch.float32,
                                               device=x.device))
    r = sp["r"].float()
    hs = []
    for t in range(s):
        rh = torch.einsum("bhx,hxy->bhy", state.h.reshape(bsz, heads, hd), r).reshape(
            bsz, 4 * d)
        pre = pre_all[:, t] + rh
        zt, it, ft, ot = torch.split(pre, d, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + state.m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + state.m - m_new)
        c_new = f_s * state.c + i_s * zt
        n_new = f_s * state.n + i_s
        h_new = ot * c_new / torch.clamp(n_new, min=1.0)
        state = SLSTMState(c_new, n_new, h_new, m_new)
        hs.append(h_new)
    return torch.stack(hs, dim=1).to(x.dtype), state


def slstm_block(cfg: ModelConfig, sp, x: torch.Tensor, *,
                state: Optional[SLSTMState] = None, single_step: bool = False
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """Pre-norm sLSTM, out-norm, then the post-up/down projection (the
    paper's post-up-proj block, expand 2). A single step is a scan of one."""
    xin = L.rmsnorm(sp["norm"], x, cfg.norm_eps)
    hs, new_state = slstm_scan(cfg, sp, xin, state)
    hs = L.rmsnorm(sp["out_norm"], hs, cfg.norm_eps)
    a, b = torch.chunk(hs @ sp["up"], 2, dim=-1)
    y = (F.gelu(a, approximate="tanh") * b) @ sp["down"]
    return y.to(x.dtype), new_state
