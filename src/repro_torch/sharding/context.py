"""Mesh/rules context for model code: port of ``repro/sharding/context.py``.

Model code never mentions mesh axes directly. The launcher installs a
``(mesh, rules)`` pair here (``set_rules``, thread-local as in the
reference); off the mesh nothing is installed, and the same model code runs
on one device. The mesh is a :class:`~repro_torch.launch.mesh.DeviceMesh`
of ``torch.distributed`` ranks, one process each.

A spec is the port's ``PartitionSpec``: a tuple with, per dim, ``None``
(whole on every rank), a mesh axis name, or a tuple of them. The JAX
package's ``constrain`` asks GSPMD for a layout and gets a copy when the
value has another; here every rank computes its own part (explicit SPMD),
so there is nothing to ask for, and ``constrain`` checks the layout instead:
a local shape that the spec does not give raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.sharding.rules import param_rules

Spec = Tuple[object, ...]

_state = threading.local()


def set_rules(mesh, rules: Dict[str, Optional[Tuple[str, ...]]]):
    _state.mesh = mesh
    _state.rules = rules


def clear_rules():
    _state.mesh = None
    _state.rules = None


def get_rules():
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def whole_leaves(*names: str):
    """Within the block, the parameters ``names`` are whole on every rank
    whatever the rules say: the sparse transport hands the loss a table's
    gathered sub-table, all of its rows on every model rank
    (``sparse.encode.submodel_value_and_grad``), so the model must not
    split its lookup again. Nests; thread-local as the rules are."""
    before = getattr(_state, "whole", frozenset())
    _state.whole = before | frozenset(names)
    try:
        yield
    finally:
        _state.whole = before


def is_whole(name: str) -> bool:
    """Whether ``whole_leaves`` holds ``name`` whole here."""
    return name in getattr(_state, "whole", frozenset())


def spec_for_axes(axes, rules) -> Spec:
    """Logical axis names -> mesh axes per dim, as the reference's
    ``PartitionSpec``: a rule of one axis gives its name, of several the
    tuple."""
    parts = []
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is None:
            parts.append(None)
        elif len(m) == 1:
            parts.append(m[0])
        else:
            parts.append(tuple(m))
    return tuple(parts)


def sharding_for_axes(axes) -> Optional[Spec]:
    """The installed rules' spec for ``axes``, or None off the mesh."""
    mesh, rules = get_rules()
    if mesh is None:
        return None
    return spec_for_axes(axes, rules)


def param_shardings(axes: Mapping[str, Sequence]) -> Dict[str, Spec]:
    """Each parameter's spec under the installed rules, from the port's
    ``{state_dict name: logical axes}`` dict (the parameters are split by
    ``rules.param_rules``: whole heads per rank)."""
    mesh, rules = get_rules()
    if mesh is None:
        raise RuntimeError("no mesh installed; call set_rules() first")
    prules = param_rules(rules)
    return {name: spec_for_axes(ax, prules) for name, ax in axes.items()}


def constrain(x, logical_axes, global_shape: Sequence[Optional[int]]):
    """Check that ``x`` is this rank's part of a ``global_shape`` tensor laid
    out by ``logical_axes`` (the identity off the mesh). Each dim the rules
    map onto mesh axes that divide it must be that many times smaller; a
    dim they do not divide is whole (``launch.shardings._fit_spec``). A
    ``None`` in ``global_shape`` is not checked. Returns ``x``."""
    from repro_torch.launch.shardings import _axis_size, _fit_spec

    spec = sharding_for_axes(logical_axes)
    if spec is None:
        return x
    mesh = get_rules()[0]
    spec = _fit_spec(mesh, spec, tuple(0 if g is None else int(g) for g in global_shape))
    for dim, (g, names) in enumerate(zip(global_shape, spec)):
        if g is None:
            continue
        want = int(g) // _axis_size(mesh, names)
        if x.shape[dim] != want:
            raise ValueError(
                f"constrain: dim {dim} of {tuple(x.shape)} is {x.shape[dim]}, and "
                f"{tuple(logical_axes)} over {dict(mesh.shape)} lays a global "
                f"{tuple(global_shape)} out as {want}")
    return x


def split_mesh(logical: str, size: int):
    """The model axis's ``CohortMesh`` when the installed parameter rules
    split a dim of ``size`` along ``logical`` over more than one model rank,
    else None (off the mesh, a replicated axis, a size the axis does not
    divide)."""
    mesh, rules = get_rules()
    if mesh is None:
        return None
    names = param_rules(rules).get(logical)
    if not names:
        return None
    if tuple(names) != ("model",):
        raise NotImplementedError(
            f"logical axis {logical!r} maps to {names}: the port splits model "
            "dims over the 'model' axis only")
    m = int(mesh.shape.get("model", 1))
    if m == 1 or size % m:
        return None
    return mesh.axis("model")


def data_mesh(size: int):
    """The data axis's ``CohortMesh`` when the installed rules split the
    ``embed`` axis (each weight's ``d_model``) over ``data`` and the axis
    divides ``size`` (the FSDP layout: ``rules.fsdp_rules``), else None
    (off the mesh, TP, one data rank, or a size ``_fit_spec`` leaves
    whole)."""
    mesh, rules = get_rules()
    if mesh is None:
        return None
    names = param_rules(rules).get("embed")
    if not names:
        return None
    if tuple(names) != ("data",):
        raise NotImplementedError(
            f"logical axis 'embed' maps to {names}: the port splits d_model over the "
            "'data' axis only")
    n = int(mesh.shape.get("data", 1))
    if n == 1 or size % n:
        return None
    return mesh.axis("data")
