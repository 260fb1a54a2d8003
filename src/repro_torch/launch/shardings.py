"""Sharding assembly for the launchers: port of ``repro/launch/shardings.py``.

The reference turns ``(mesh, rules, abstract values)`` into sharded
``ShapeDtypeStruct`` trees for ``jit``. The port's ranks each hold their own
part, so the same specs cut real tensors here: ``shard_params`` takes this
rank's slice of every leaf of a full flat dict (the weights cross from the
JAX package as numpy, then ``convert.params_from_jax(flat=True)``, then
``shard_params``), ``unshard_params`` gathers them back, ``shard_batch``
cuts a batch. Dims the mesh axes do not divide stay whole (``_fit_spec``:
Whisper's 51,866-row vocabulary at 4 ranks, a batch of 1).

The caches (``shard_cache_sds``) belong to sharded serving, which is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from repro_torch.sharding.context import Spec, spec_for_axes
from repro_torch.sharding.logical import boxed_like
from repro_torch.sharding.rules import param_rules


def _names(names) -> tuple:
    if names is None:
        return ()
    return (names,) if isinstance(names, str) else tuple(names)


def _axis_size(mesh, names) -> int:
    size = 1
    for n in _names(names):
        size *= mesh.shape[n]
    return size


def _fit_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop partitioning on dims the shape cannot divide (replicate instead)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, names in zip(shape, parts):
        if names is not None and dim % _axis_size(mesh, names) != 0:
            names = None
        fixed.append(names)
    return tuple(fixed)


def _index(mesh, names) -> int:
    """This rank's block along the mesh axes ``names`` (row-major)."""
    coords = dict(zip(mesh.axis_names, mesh.coords))
    idx = 0
    for n in _names(names):
        idx = idx * mesh.shape[n] + coords[n]
    return idx


def local_part(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (fitted to its shape): a
    view where every dim is whole."""
    for dim, names in enumerate(_fit_spec(mesh, spec, x.shape)):
        if names is not None:
            width = x.shape[dim] // _axis_size(mesh, names)
            x = x.narrow(dim, _index(mesh, names) * width, width)
    return x


def param_specs(axes: Mapping[str, Sequence], shapes: Mapping[str, Sequence[int]], mesh,
                rules) -> Dict[str, Spec]:
    """Each leaf's fitted spec: ``rules.param_rules`` (whole heads per rank)
    of its logical axes, at its full shape."""
    prules = param_rules(rules)
    return {name: _fit_spec(mesh, spec_for_axes(axes[name], prules), tuple(shape))
            for name, shape in shapes.items()}


def local_shapes(cfg, mesh, rules) -> Dict[str, tuple]:
    """Each leaf of ``cfg``'s flat training dict as a rank holds it: its
    local shape and its element size (from the model on ``meta``)."""
    from repro_torch.models.api import build_model

    model = build_model(cfg).abstract_params()
    full = dict(model.state_dict())
    specs = param_specs(model.axes, {n: t.shape for n, t in full.items()}, mesh, rules)
    out = {}
    for name, t in full.items():
        shape = [n // _axis_size(mesh, names) for n, names in zip(t.shape, specs[name])]
        out[name] = (tuple(shape), t.element_size())
    return out


def shard_params(flat: Mapping[str, torch.Tensor], axes: Mapping[str, Sequence], mesh,
                 rules) -> Dict[str, torch.Tensor]:
    """This rank's slice of each leaf of the full ``flat`` dict, contiguous
    and of its own storage (a split leaf is copied; a whole one is the
    tensor passed in)."""
    flat, axes = boxed_like(flat, axes)
    specs = param_specs(axes, {n: t.shape for n, t in flat.items()}, mesh, rules)
    return {name: local_part(t, mesh, specs[name]).contiguous() for name, t in flat.items()}


def unshard_params(local: Mapping[str, torch.Tensor], full_shapes: Mapping[str, Sequence],
                   axes: Mapping[str, Sequence], mesh, rules,
                   tag: str = "unshard") -> Dict[str, torch.Tensor]:
    """``shard_params``' inverse: every leaf whole on every rank, gathered
    along each split dim over its mesh axis (counted under ``tag``).
    ``full_shapes`` are the leaves' global shapes."""
    specs = param_specs(axes, {n: full_shapes[n] for n in local}, mesh, rules)
    out = {}
    for name, t in local.items():
        for dim, names in enumerate(specs[name]):
            if names is None:
                continue
            if len(_names(names)) != 1:
                raise NotImplementedError(f"{name}: gathering over {names}")
            parts = mesh.axis(_names(names)[0]).all_gather(t, tag)
            t = torch.cat(list(parts.unbind(0)), dim=dim)
        out[name] = t
    return out


def batch_spec_for(key: str, ndim: int, batch_axes) -> Spec:
    """The reference's batch layout: ``heat_vocab`` over ``model``, other
    heat vectors whole, ``mrope_pos`` ``(3, B, S)`` on its axis 1, every
    other leaf batch-major."""
    if key.startswith("heat_vocab"):
        return ("model",)
    if key.startswith("heat_"):
        return (None,)
    if key == "mrope_pos":
        return (None, batch_axes) + (None,) * (ndim - 2)
    return (batch_axes,) + (None,) * (ndim - 1)


def shard_batch(batch: Mapping[str, torch.Tensor], mesh, rules) -> Dict[str, torch.Tensor]:
    """This rank's part of every batch leaf (``batch_spec_for`` over the
    rules' batch axes, fitted: a dim the axes do not divide stays whole)."""
    ba = spec_for_axes(("batch",), rules)[0]
    return {k: local_part(v, mesh, batch_spec_for(k, v.dim(), ba)) for k, v in batch.items()}
