"""The paper's evaluation models: LR (MovieLens rating), LSTM (Sent140
sentiment), DIN (Amazon/Alibaba CTR), all ported.

Parameters are a flat dict of float32 tensors; the logical axes live beside
them in a dict of the same keys. A feature-keyed leaf carries the "vocab"
axis, which is what ``federated.plan.heat_spec_from_axes`` reads. The
LSTM's tuple of cells is flattened to ``cells.{i}.wx`` / ``.wh`` / ``.b``.

``make_*_params(..., device=None, generator=None)`` returns ``(params,
axes)``; random leaves are drawn from ``generator`` (a ``torch.Generator``
on the device; seed 0 when None) with the reference's distributions:
``normal`` is 0.02 * N(0, 1), ``fan_in`` N(0, 1) / sqrt(shape[-2]), biases
are zero.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple]

#: logical axes of the LR parameters
LR_AXES: Axes = {"w": ("vocab", "embed"), "b": (None,)}


def _bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    # |x| as a select so its gradient at 0 is +1, as JAX's abs has it
    # (torch.abs gives 0 there). LR starts from zero weights, so every first
    # local step sits at logit 0, where the JAX reference's BCE gradient is
    # -label, not sigmoid(0) - label; the port keeps the reference's value.
    abs_logit = torch.where(logit >= 0, logit, -logit)
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * label
            + torch.log1p(torch.exp(-abs_logit)))


def _mean_loss(logit: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masked mean BCE over the batch's samples."""
    per = _bce(logit, batch["label"].to(torch.float32))
    m = batch.get("sample_mask")
    if m is None:
        m = torch.ones_like(per)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


class _Init:
    """Draws leaves in order from one generator and records their axes."""

    def __init__(self, device, generator: Optional[torch.Generator]):
        self.device = resolve_device(device)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))
        self.params: Params = {}
        self.axes: Axes = {}

    def __call__(self, name: str, shape: Tuple[int, ...], axes: Tuple,
                 init: str = "fan_in") -> None:
        if init == "zeros":
            value = torch.zeros(shape, dtype=torch.float32, device=self.device)
        else:
            std = 0.02 if init == "normal" else 1.0 / math.sqrt(max(shape[-2], 1))
            value = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                                device=self.device).mul_(std)
        self.params[name] = value
        self.axes[name] = tuple(axes)


# ---------------------------------------------------------------------------
# LR over sparse one-hot features (MovieLens rating classification)
# ---------------------------------------------------------------------------


def make_lr_params(num_features: int, device=None) -> Tuple[Params, Axes]:
    """Zero-initialised LR parameters ``{"w": (V, 1), "b": (1,)}`` and axes."""
    dev = resolve_device(device)
    params = {"w": torch.zeros((num_features, 1), dtype=torch.float32, device=dev),
              "b": torch.zeros((1,), dtype=torch.float32, device=dev)}
    return params, dict(LR_AXES)


def lr_logits(params: Params, feature_ids: torch.Tensor) -> torch.Tensor:
    """feature_ids: ``(B, F)`` int32 active feature ids (-1 = padding)."""
    w = params["w"][..., 0]
    valid = (feature_ids >= 0).to(torch.float32)
    vals = w[torch.clamp(feature_ids, min=0).long()] * valid
    return vals.sum(-1) + params["b"][0]


def lr_loss(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _mean_loss(lr_logits(params, batch["features"]), batch)


# ---------------------------------------------------------------------------
# Two-layer LSTM classifier (Sent140)
# ---------------------------------------------------------------------------


def lstm_axes(layers: int = 2) -> Axes:
    """Logical axes of an LSTM with ``layers`` cells."""
    axes: Axes = {"embedding": ("vocab", "embed")}
    for i in range(layers):
        axes.update({f"cells.{i}.wx": ("embed", "ffn"), f"cells.{i}.wh": (None, "ffn"),
                     f"cells.{i}.b": ("ffn",)})
    axes.update({"head_w": (None, None), "head_b": (None,)})
    return axes


#: logical axes of the two-layer LSTM
LSTM_AXES: Axes = lstm_axes(2)


def make_lstm_params(vocab: int, emb_dim: int = 25, hidden: int = 100,
                     layers: int = 2, device=None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Params, Axes]:
    """LSTM parameters at the reference's widths (emb 25, hidden 100, two
    cells), drawn in the reference's order, and their axes."""
    pf = _Init(device, generator)
    for i in range(layers):
        d_in = emb_dim if i == 0 else hidden
        pf(f"cells.{i}.wx", (d_in, 4 * hidden), ("embed", "ffn"))
        pf(f"cells.{i}.wh", (hidden, 4 * hidden), (None, "ffn"))
        pf(f"cells.{i}.b", (4 * hidden,), ("ffn",), init="zeros")
    pf("embedding", (vocab, emb_dim), ("vocab", "embed"), init="normal")
    pf("head_w", (hidden, 1), (None, None))
    pf("head_b", (1,), (None,), init="zeros")
    return pf.params, pf.axes


def _lstm_layer(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                xs: torch.Tensor, mask: torch.Tensor):
    """xs ``(B, S, d_in)``, mask ``(B, S)``. A standard LSTM (gates i, f, g,
    o; forget bias +1) whose masked steps carry the state; returns the last
    carried ``h`` and the un-masked ``h`` of every step, the next layer's
    input, as the reference's scan does. The loop over S runs in Python;
    the input projection of all steps is one matmul, and the per-step
    slices come from one ``unbind`` each (one op, and one ``stack`` in the
    backward pass, where indexing step by step adds a scatter per step)."""
    bsz = xs.shape[0]
    keep = mask[..., None]
    h = xs.new_zeros((bsz, wh.shape[0]))
    c = xs.new_zeros((bsz, wh.shape[0]))
    hs = []
    for x_t, k_t, d_t in zip((xs @ wx + b).unbind(1), keep.unbind(1),
                             (1 - keep).unbind(1)):
        i, f, g, o = (x_t + h @ wh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = h_new * k_t + h * d_t
        c = c_new * k_t + c * d_t
        hs.append(h_new)
    return h, torch.stack(hs, dim=1)


def lstm_logits(params: Params, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tokens ``(B, S)`` ids (-1 = padding), mask ``(B, S)`` f32."""
    valid = (tokens >= 0).to(torch.float32)
    x = params["embedding"][torch.clamp(tokens, min=0).long()] * valid[..., None]
    layers = sum(name.endswith(".wx") for name in params)
    for i in range(layers):
        h, x = _lstm_layer(params[f"cells.{i}.wx"], params[f"cells.{i}.wh"],
                           params[f"cells.{i}.b"], x, mask)
    return (h @ params["head_w"])[:, 0] + params["head_b"][0]


def lstm_loss(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    mask = (batch["tokens"] >= 0).to(torch.float32)
    return _mean_loss(lstm_logits(params, batch["tokens"], mask), batch)


# ---------------------------------------------------------------------------
# DIN (Deep Interest Network) for CTR prediction
# ---------------------------------------------------------------------------

#: logical axes of the DIN parameters
DIN_AXES: Axes = {
    "item_emb": ("vocab", "embed"),
    "att_w1": (None, None), "att_b1": (None,), "att_w2": (None, None),
    "mlp_w1": (None, None), "mlp_b1": (None,), "mlp_w2": (None, None),
    "mlp_b2": (None,),
}


def make_din_params(num_items: int, emb_dim: int = 18, hidden: int = 36, device=None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Params, Axes]:
    """DIN parameters at the reference's widths (emb 18, hidden 36), drawn
    in the reference's order, and their axes."""
    pf = _Init(device, generator)
    pf("item_emb", (num_items, emb_dim), ("vocab", "embed"), init="normal")
    # the attention unit over (hist, target, hist * target, hist - target)
    pf("att_w1", (4 * emb_dim, hidden), (None, None))
    pf("att_b1", (hidden,), (None,), init="zeros")
    pf("att_w2", (hidden, 1), (None, None))
    # the output MLP over (pooled hist, target, pooled * target)
    pf("mlp_w1", (3 * emb_dim, hidden), (None, None))
    pf("mlp_b1", (hidden,), (None,), init="zeros")
    pf("mlp_w2", (hidden, 1), (None, None))
    pf("mlp_b2", (1,), (None,), init="zeros")
    return pf.params, pf.axes


def din_logits(params: Params, hist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """hist ``(B, H)`` item ids (-1 = padding); target ``(B,)`` item ids
    (never padding: it is gathered unmasked, as in the reference)."""
    emb = params["item_emb"]
    hmask = (hist >= 0).to(torch.float32)
    he = emb[torch.clamp(hist, min=0).long()] * hmask[..., None]       # (B, H, e)
    te = emb[target.long()]                                             # (B, e)
    tb = te[:, None].expand_as(he)
    att_in = torch.cat([he, tb, he * tb, he - tb], dim=-1)
    a = torch.relu(att_in @ params["att_w1"] + params["att_b1"]) @ params["att_w2"]
    a = a[..., 0] + (hmask - 1.0) * 1e9                                # mask pads
    w = torch.softmax(a, dim=-1) * (hmask.sum(-1, keepdim=True) > 0)
    pooled = torch.einsum("bh,bhe->be", w, he)
    feat = torch.cat([pooled, te, pooled * te], dim=-1)
    h = torch.relu(feat @ params["mlp_w1"] + params["mlp_b1"])
    return (h @ params["mlp_w2"])[:, 0] + params["mlp_b2"][0]


def din_loss(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _mean_loss(din_logits(params, batch["hist"], batch["target"]), batch)


PAPER_MODELS = {
    "movielens_lr": (make_lr_params, lr_loss),
    "sent140_lstm": (make_lstm_params, lstm_loss),
    "din_ctr": (make_din_params, din_loss),
}
