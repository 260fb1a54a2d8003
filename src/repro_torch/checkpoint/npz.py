"""Flat-key npz checkpoints of the port's trees, in the JAX package's layout.

A tree is any nesting of dicts, NamedTuples (``ServerState``,
``AsyncState``), tuples, ``RowSparse`` leaves, tensors and Python numbers.
Each leaf is stored under its ``"/"``-joined path, built as the JAX package
builds it: a dict key (a parameter's dotted name with ``"/"`` for ``"."``,
so the LSTM's ``cells.0.wx`` is ``cells/0/wx``), a NamedTuple field as
``.field``, a tuple position as its index, and a RowSparse's ids and rows as
``0`` and ``1``; ``None`` stores nothing. So either package reads the
other's recsys parameter and ``ServerState`` checkpoints. bf16 is stored as
f32 (numpy has no bf16) and cast back to the template's dtype on load. A
``.meta.json`` sidecar holds ``step``, the logical ``axes`` by key and
``extra``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sparse.rowsparse import RowSparse, is_rowsparse


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(key, child)`` pairs of an inner node, None for a leaf."""
    if is_rowsparse(node):
        return [("0", node.ids), ("1", node.rows)]
    if isinstance(node, dict):
        return [(str(k).replace(".", "/"), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix[:-1], tree)]
    out = []
    for key, child in kids:
        out += _flatten(child, f"{prefix}{key}/")
    return out


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)      # numpy cannot hold bf16: lossless f32
        return x.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, step: int = 0, extra: Optional[dict] = None,
                    axes: Optional[Dict[str, Tuple]] = None) -> None:
    """Write ``path.npz`` and ``path.meta.json``. ``axes``: the parameters'
    logical axes by parameter name (``make_*_params``' second value),
    recorded for the parameter leaves (a flat dict, or a ``.params`` field)
    and None for every other leaf."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    by_key = {name.replace(".", "/"): list(ax) for name, ax in (axes or {}).items()}
    meta_axes = {key: by_key.get(key.split(".params/")[-1]) for key, _ in flat}
    np.savez(path + ".npz", **{key: _to_numpy(leaf) for key, leaf in flat})
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, "axes": meta_axes, "extra": extra or {}}, f)


def _restore(template, data, prefix: str):
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        key = prefix[:-1]
        arr = data[key]
        if torch.is_tensor(template):
            if tuple(arr.shape) != tuple(template.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                                 f"the template {tuple(template.shape)}")
            return torch.from_numpy(np.array(arr)).to(device=template.device,
                                                      dtype=template.dtype)
        return type(template)(arr.item()) if np.ndim(arr) == 0 else arr
    values = [_restore(child, data, f"{prefix}{key}/") for key, child in kids]
    if is_rowsparse(template):
        return RowSparse(values[0], values[1], template.num_rows)
    if isinstance(template, dict):
        return dict(zip(template.keys(), values))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*values)
    return type(template)(values)


def load_checkpoint(path: str, template) -> Any:
    """The tree of ``template``'s structure with the checkpoint's values, each
    leaf on the template leaf's device and in its dtype."""
    with np.load(path + ".npz") as data:
        return _restore(template, data, "")
