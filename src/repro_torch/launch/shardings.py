"""Sharding assembly for the launchers: port of ``repro/launch/shardings.py``.

The reference turns ``(mesh, rules, abstract values)`` into sharded
``ShapeDtypeStruct`` trees for ``jit``. The port's ranks each hold their own
part, so the same specs cut real tensors here: ``shard_params`` takes this
rank's slice of every leaf of a full flat dict (the weights cross from the
JAX package as numpy, then ``convert.params_from_jax(flat=True)``, then
``shard_params``), ``unshard_params`` gathers them back, ``shard_batch``
cuts a batch. Dims the mesh axes do not divide stay whole (``_fit_spec``:
Whisper's 51,866-row vocabulary at 4 ranks, a batch of 1).

The caches: ``cache_specs`` is ``shard_cache_sds``'s layout of every cache
family (the KV caches' batch over ``data`` and sequence over ``kv_seq``'s
axis, Zamba2's and xLSTM's states over ``model``), fitted as the reference
fits it; ``local_cache`` cuts a rank's part of a whole cache and
``shard_cache`` makes it directly, zeros of the local shapes. A KV cache
split by sequence remembers its whole capacity and its slice's first slot
(``layers.KVCache.slots``/``start``; Zamba2's and Whisper's caches
likewise). Sharded serving runs every family's cache.
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


def own_part(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """``local_part`` in storage of its own where it is a part: a slice of
    leading rows is already contiguous, and as a view it would keep the
    whole tensor alive (and share its writes). A whole ``x`` is returned as
    it is."""
    part = local_part(x, mesh, spec)
    return x if part is x else part.clone(memory_format=torch.contiguous_format)


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
    return {name: own_part(t, mesh, specs[name]) for name, t in flat.items()}


def unshard_params(local: Mapping[str, torch.Tensor], full_shapes: Mapping[str, Sequence],
                   axes: Mapping[str, Sequence], mesh, rules,
                   tag: str = "unshard") -> Dict[str, torch.Tensor]:
    """``shard_params``' inverse: every leaf whole on every rank, gathered
    along each split dim over its mesh axis, or over the joint axis of a
    dim split over several (its ranks row-major, as ``_index`` orders the
    blocks), counted under ``tag``. ``full_shapes`` are the leaves' global
    shapes; any layout of the rules gathers (TP, FSDP, multi-pod)."""
    specs = param_specs(axes, {n: full_shapes[n] for n in local}, mesh, rules)
    out = {}
    for name, t in local.items():
        for dim, names in enumerate(specs[name]):
            if names is None:
                continue
            parts = mesh.axis(_names(names)).all_gather(t, tag)
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


def cache_specs(mesh, rules, cache):
    """``cache`` (any family's, whole, or on ``meta``) with each tensor
    replaced by its fitted spec and ``pos`` by ``()``: the specs of
    ``repro/launch/shardings.py::shard_cache_sds``. The batch goes over the
    rules' batch axes; the KV caches' sequence over ``kv_seq``'s first axis;
    Zamba2's SSM heads and conv channels and xLSTM's state dims over
    ``model``."""
    from repro_torch.models.layers import KVCache
    from repro_torch.models.whisper import WhisperCache
    from repro_torch.models.xlstm_model import XLSTMCache
    from repro_torch.models.zamba import ZambaCache

    ba = spec_for_axes(("batch",), rules)[0]
    kv_seq = rules.get("kv_seq")
    kv_seq = kv_seq[0] if kv_seq else None

    def fit(x, *spec):
        return _fit_spec(mesh, spec, tuple(x.shape))

    def kv(x):          # (L or sites, B, KV, S, hd)
        return fit(x, None, ba, None, kv_seq, None)

    if isinstance(cache, KVCache):
        return KVCache(kv(cache.k), kv(cache.v), ())
    if isinstance(cache, WhisperCache):
        return WhisperCache(kv(cache.k), kv(cache.v), kv(cache.ck), kv(cache.cv), ())
    if isinstance(cache, ZambaCache):
        return ZambaCache(fit(cache.ssm_state, None, ba, "model", None, None),
                          fit(cache.conv_state, None, ba, None, "model"),
                          kv(cache.k), kv(cache.v), ())
    if isinstance(cache, XLSTMCache):
        m_states = tuple(type(st)(fit(st.c, None, ba, None, "model", None),
                                  fit(st.n, None, ba, None, "model"), fit(st.m, None, ba, None))
                         for st in cache.m_states)
        s_states = tuple(type(st)(*(fit(x, None, ba, "model") for x in st))
                         for st in cache.s_states)
        return XLSTMCache(m_states, s_states, ())
    raise TypeError(type(cache))


def _map_cache(fn, cache, specs):
    """``fn(tensor, spec)`` on every tensor of a cache (nested states too);
    the host ints (``pos``) as they are."""
    if isinstance(cache, torch.Tensor):
        return fn(cache, specs)
    if isinstance(cache, tuple) and hasattr(cache, "_fields"):
        return type(cache)(*(_map_cache(fn, c, sp) for c, sp in zip(cache, specs)))
    if isinstance(cache, tuple):
        return tuple(_map_cache(fn, c, sp) for c, sp in zip(cache, specs))
    return cache


def _with_slice(local, whole, mesh, specs):
    """A KV cache's part (``layers.KVCache``, or Zamba2's or Whisper's
    cache, whose ``k`` and ``v`` are the KV cache) that knows its whole
    capacity and its first slot; xLSTM's states need neither."""
    if "slots" not in getattr(local, "_fields", ()):
        return local
    names = specs.k[3]
    cap = whole.k.shape[3]
    start = 0 if names is None else _index(mesh, names) * (cap // _axis_size(mesh, names))
    return local._replace(slots=cap, start=start)


def local_cache(cache, mesh, rules):
    """This rank's part of the whole ``cache`` under ``cache_specs`` (a
    contiguous copy of each split tensor)."""
    specs = cache_specs(mesh, rules, cache)
    local = _map_cache(lambda t, spec: own_part(t, mesh, spec), cache, specs)
    return _with_slice(local, cache, mesh, specs)


def shard_cache(init_cache, batch: int, max_seq: int, mesh, rules, device=None):
    """This rank's part of the cache ``init_cache(batch, max_seq, device)``
    makes (``ModelApi.init_cache``), made directly as zeros of the local
    shapes: the whole cache is laid out on ``meta`` only."""
    whole = init_cache(batch, max_seq, device="meta")
    specs = cache_specs(mesh, rules, whole)

    def zeros(t, spec):
        shape = [n // _axis_size(mesh, names) for n, names in zip(t.shape, spec)]
        return torch.zeros(shape, dtype=t.dtype, device=device)

    return _with_slice(_map_cache(zeros, whole, specs), whole, mesh, specs)
