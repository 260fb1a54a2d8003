"""The paper's evaluation models. Ported so far: LR over sparse one-hot
features (MovieLens rating classification). DIN and LSTM come later.

Parameters are a flat dict of float32 tensors; the logical axes live beside
them in a dict of the same keys. A feature-keyed leaf carries the "vocab"
axis, which is what ``federated.plan.heat_spec_from_axes`` reads.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
    logit = lr_logits(params, batch["features"])
    per = _bce(logit, batch["label"].to(torch.float32))
    m = batch.get("sample_mask")
    if m is None:
        m = torch.ones_like(per)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)
