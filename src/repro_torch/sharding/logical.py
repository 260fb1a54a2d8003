"""Logical axes of parameters: what the port needs of
``repro/sharding/logical.py``.

The reference boxes every array with its logical axis names in a pytree
node (``Param``), so that the axes ride through ``jit``, ``grad`` and the
optimizers. The port's parameters are a flat ``{state_dict name: tensor}``
dict, and each model keeps the names' axes beside it (``.axes`` on the
module, ``transformer.train_params`` returns both); gradients and updates
are dicts under the same names. So there is no box: these are plain helpers
on the dict and its ``axes``, standing where ``unbox``, ``axes_tree`` and
``boxed_like`` stand in the reference.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

AxisNames = Tuple[Optional[str], ...]


def unbox(params) -> Dict[str, torch.Tensor]:
    """The flat ``{name: tensor}`` dict of a module (its ``state_dict``) or
    of a dict, as it is."""
    return dict(params.state_dict()) if hasattr(params, "state_dict") else dict(params)


def axes_tree(params) -> Dict[str, AxisNames]:
    """The ``{name: logical axes}`` dict a model keeps beside its tensors."""
    axes = getattr(params, "axes", None)
    if axes is None:
        raise ValueError("axes_tree: the parameters carry no logical axes; pass a model "
                         "module, or keep the axes train_params returns")
    return {name: tuple(ax) for name, ax in axes.items()}


def boxed_like(values: Mapping[str, torch.Tensor],
               axes: Mapping[str, AxisNames]) -> Tuple[Dict[str, torch.Tensor],
                                                         Dict[str, AxisNames]]:
    """``(values, axes)`` checked to belong together: the same names, and
    one axis name per dim of each tensor."""
    if set(values) != set(axes):
        raise ValueError(f"boxed_like: names differ: {sorted(set(values) ^ set(axes))}")
    for name, v in values.items():
        if v.dim() != len(axes[name]):
            raise ValueError(f"boxed_like: {name} has {v.dim()} dims and axes "
                             f"{tuple(axes[name])}")
    return dict(values), {name: tuple(axes[name]) for name in values}
