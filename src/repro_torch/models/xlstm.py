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
from repro_torch.sharding.parallel import (copy_to_model, gather_for_model, gather_from_model,
                                           reduce_from_model)

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
                state: Optional[MLSTMState] = None, single_step: bool = False, mesh=None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """The mLSTM block: the up projections, the cell, out-norm and down.

    ``mesh`` (the model axis, ``transformer.Split.mlstm``): the rank holds
    ``up_z``'s, ``up_x``'s, ``wq``'s, ``wk``'s and ``wv``'s columns, and
    ``w_i``'s, ``w_f``'s and ``down``'s rows, of its whole heads. The rank's
    columns of ``x @ up_x`` are gathered whole over ``model`` (``mlstm_up``)
    for its q, k and v; ``w_i`` and ``w_f`` are gathered whole
    (``mlstm_gate``), so every rank has every head's gates; the cell runs on
    the rank's heads, ``out_norm`` over the split inner dim
    (``layers.rmsnorm_split``) and ``down``'s partial products are summed
    (``mlstm_out``). ``b_i``, ``b_f`` and ``out_norm``'s scale are whole and
    read in part, their gradients summed (``mlstm_leaves``).

    A given ``state`` is then in the cache's layout, each head's slice of
    the key dim (``launch.shardings.cache_specs``), and the new state is
    returned in it: a single step runs on that slice (``_mlstm_step_split``);
    a chunked run gathers the state into the rank's heads before and back
    after (``mlstm_state``). Without a state (training) the new state is
    the rank's heads'."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.ssm_heads
    hd = di // h
    bsz, s, _ = x.shape

    if mesh is None:
        z = F.silu(x @ mp["up_z"])
        u = x @ mp["up_x"]
        hl = h
        w_i, w_f = mp["w_i"], mp["w_f"]
        b_i, b_f = mp["b_i"], mp["b_f"]
    else:
        hl = h // mesh.size
        xm = copy_to_model(x, mesh, "mlstm_in")
        z = F.silu(xm @ mp["up_z"])
        u = gather_for_model(xm @ mp["up_x"], mesh, "mlstm_up")
        w_i, w_f = gather_for_model(torch.stack([mp["w_i"], mp["w_f"]]), mesh, "mlstm_gate",
                                    dim=1).unbind(0)
        b_i, b_f = (copy_to_model(mp[n], mesh, "mlstm_leaves") for n in ("b_i", "b_f"))
    q = (u @ mp["wq"]).reshape(bsz, s, hl, hd)
    k = (u @ mp["wk"]).reshape(bsz, s, hl, hd)
    v = (u @ mp["wv"]).reshape(bsz, s, hl, hd)
    log_i = (u @ w_i).float() + b_i
    log_f = F.logsigmoid((u @ w_f).float() + b_f)

    if single_step:
        if state is None:
            raise ValueError("mlstm_block: a single step needs the state")
        if mesh is None:
            hout, new_state = mlstm_cell_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                              log_f[:, 0], state)
        else:
            hout, new_state = _mlstm_step_split(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                                log_f[:, 0], state, mesh)
        hout = hout[:, None]
    elif mesh is None:
        hout, new_state = mlstm_cell_chunked(q, k, v, log_i, log_f, chunk, state)
    else:
        h0 = mesh.rank * hl
        heads = slice(h0, h0 + hl)
        hout, new_state = mlstm_cell_chunked(
            q, k, v, log_i[..., heads], log_f[..., heads], chunk,
            None if state is None else _state_to_heads(state, mesh, heads))
        if state is not None:
            new_state = _state_to_cache(new_state, mesh)

    y = hout.reshape(bsz, -1, hl * hd) * z
    if mesh is None:
        y = L.rmsnorm(mp["out_norm"], y, cfg.norm_eps)
        return (y @ mp["down"]).to(x.dtype), new_state
    y = L.rmsnorm_split(mp["out_norm"], y, cfg.norm_eps, mesh, "mlstm_norm", "mlstm_leaves")
    return reduce_from_model(y @ mp["down"], mesh, "mlstm_out").to(x.dtype), new_state


def _state_to_heads(state: MLSTMState, mesh, heads: slice) -> MLSTMState:
    """The cache's layout (every head, the rank's slice of the key dim) to
    the rank's heads, whole: ``c`` and ``n`` gathered over the key dim."""
    c = gather_from_model(state.c, mesh, "mlstm_state", dim=2)
    n = gather_from_model(state.n, mesh, "mlstm_state", dim=2)
    return MLSTMState(c[:, heads], n[:, heads], state.m[:, heads])


def _state_to_cache(state: MLSTMState, mesh) -> MLSTMState:
    """The rank's heads to the cache's layout: every head gathered, the
    rank's slice of the key dim kept (``m`` whole)."""
    hd = state.c.shape[-1]
    keys = slice(mesh.rank * hd // mesh.size, (mesh.rank + 1) * hd // mesh.size)
    c = gather_from_model(state.c, mesh, "mlstm_state", dim=1)
    n = gather_from_model(state.n, mesh, "mlstm_state", dim=1)
    m = gather_from_model(state.m, mesh, "mlstm_state", dim=1)
    return MLSTMState(c[:, :, keys], n[..., keys], m)


def _mlstm_step_split(q, k, v, log_i, log_f, state: MLSTMState, mesh
                      ) -> Tuple[torch.Tensor, MLSTMState]:
    """``mlstm_cell_step`` on the cache's layout: q, k, v ``(B, H/m, hd)``
    the rank's heads, gathered over ``model`` (``mlstm_qkv``); ``log_i``,
    ``log_f`` ``(B, H)`` every head's; the state every head's slice of the
    key dim (``m`` whole). ``C q`` and ``n . q`` over the slice are partial
    sums, summed over the ranks in one all-reduce (``mlstm_merge``).
    Returns the rank's heads of h and the new state in the same layout."""
    hl, hd = q.shape[1], q.shape[-1]
    q, k, v = gather_from_model(torch.stack([q, k, v]), mesh, "mlstm_qkv", dim=2).unbind(0)
    keys = slice(mesh.rank * hd // mesh.size, (mesh.rank + 1) * hd // mesh.size)
    scale = _inv_sqrt(hd, q.device)
    m_new = torch.maximum(log_f + state.m, log_i)
    f_s = torch.exp(log_f + state.m - m_new)
    i_s = torch.exp(log_i - m_new)
    kf, vf, qf = k.float()[..., keys], v.float(), q.float()[..., keys]
    c_new = f_s[..., None, None] * state.c + i_s[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = f_s[..., None] * state.n + i_s[..., None] * kf
    both = mesh.psum(torch.cat([torch.einsum("bhd,bhde->bhe", qf, c_new),
                                torch.einsum("bhd,bhd->bh", qf, n_new)[..., None]], dim=-1),
                     "mlstm_merge")
    num, den = both[..., :hd] * scale, both[..., hd] * scale
    hout = (num / torch.clamp(torch.abs(den), min=1.0)[..., None]).to(q.dtype)
    return hout[:, mesh.rank * hl:(mesh.rank + 1) * hl], MLSTMState(c_new, n_new, m_new)


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


def slstm_scan(cfg: ModelConfig, sp, x: torch.Tensor, state: Optional[SLSTMState] = None,
               mesh=None) -> Tuple[torch.Tensor, SLSTMState]:
    """x: (B, S, d) -> (B, S, d), a Python loop over S (the update is not
    associative).

    ``mesh`` (the model axis, ``transformer.Split.slstm``): the rank holds a
    contiguous block of ``w_in``'s and ``b``'s columns ``[z | i | f | o]``,
    and the recurrent term mixes every head into every gate (``rh``'s head
    blocks fall across the four gates), so no rank's block is a set of
    heads. The rank's pre-activations are gathered whole (``slstm_pre``) and
    every rank runs the whole recurrence, the same bits on each. A given
    ``state`` is then the cache's, each state's slice of d: it is gathered
    whole first (``slstm_state``) and the new state returned as the rank's
    slice."""
    d = cfg.d_model
    heads = cfg.ssm_heads
    hd = d // heads
    bsz, s, _ = x.shape
    if mesh is None:
        pre_all = (x @ sp["w_in"]).float() + sp["b"]                 # (B,S,4d)
    else:
        x = copy_to_model(x, mesh, "slstm_in")
        pre_all = gather_from_model((x @ sp["w_in"]).float() + sp["b"], mesh, "slstm_pre")
    sliced = mesh is not None and state is not None
    if sliced:
        state = SLSTMState(*gather_from_model(torch.stack(list(state)), mesh, "slstm_state",
                                              dim=2).unbind(0))
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
    if sliced:
        w = d // mesh.size
        state = SLSTMState(*(t[:, mesh.rank * w:(mesh.rank + 1) * w] for t in state))
    return torch.stack(hs, dim=1).to(x.dtype), state


def slstm_block(cfg: ModelConfig, sp, x: torch.Tensor, *,
                state: Optional[SLSTMState] = None, single_step: bool = False, mesh=None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """Pre-norm sLSTM, out-norm, then the post-up/down projection (the
    paper's post-up-proj block, expand 2). A single step is a scan of one.
    ``mesh``: the scan as ``slstm_scan`` splits it; the rank holds a block
    of ``up``'s columns ``[a | b]`` and its rows of ``down``, so the rank's
    columns of the up projection are gathered whole (``slstm_up``), the
    rank takes a's and b's columns of its rows, and ``down``'s partial
    products are summed (``slstm_out``)."""
    xin = L.rmsnorm(sp["norm"], x, cfg.norm_eps)
    hs, new_state = slstm_scan(cfg, sp, xin, state, mesh)
    hs = L.rmsnorm(sp["out_norm"], hs, cfg.norm_eps)
    if mesh is None:
        a, b = torch.chunk(hs @ sp["up"], 2, dim=-1)
        y = (F.gelu(a, approximate="tanh") * b) @ sp["down"]
        return y.to(x.dtype), new_state
    d = cfg.d_model
    w = d // mesh.size
    ab = gather_for_model(copy_to_model(hs, mesh, "slstm_hs") @ sp["up"], mesh, "slstm_up")
    cols = slice(mesh.rank * w, (mesh.rank + 1) * w)
    a, b = ab[..., :d][..., cols], ab[..., d:][..., cols]
    y = reduce_from_model((F.gelu(a, approximate="tanh") * b) @ sp["down"], mesh, "slstm_out")
    return y.to(x.dtype), new_state
