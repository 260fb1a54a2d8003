"""Parameter conversion from the JAX package's layout.

The JAX package keeps parameters as nested trees of boxed arrays. Given the
unboxed values as numpy arrays, ``params_from_jax`` returns the port's flat
parameter dict (nested keys joined with ".") on ``device`` and the logical
axes of the model the tree belongs to. The JAX package is not imported: the
caller hands over plain numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.recsys import LR_AXES

#: logical axes per model, keyed by the model's parameter names
_MODEL_AXES = {frozenset(LR_AXES): LR_AXES}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(np_tree: Mapping, device=None) -> Tuple[Dict[str, torch.Tensor],
                                                            Dict[str, Tuple]]:
    """``(params, axes)`` for a JAX parameter tree given as numpy arrays."""
    flat = _flatten(np_tree)
    axes = _MODEL_AXES.get(frozenset(flat))
    if axes is None:
        raise ValueError(f"no ported model has parameters {sorted(flat)}")
    dev = resolve_device(device)
    # a copy: the trainer updates its tables in place
    params = {k: torch.tensor(v, device=dev) for k, v in flat.items()}
    return params, dict(axes)
