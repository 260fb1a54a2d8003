"""Dense-intermediate audit of the sparse plane: what one call really built.

The port's counterpart of ``repro/analysis/jaxpr_audit.py``. The reference
walks a traced jaxpr; the port runs eagerly, so it records one call under a
``TorchDispatchMode`` and looks at every ATen op's outputs instead.

``find_dense_intermediates`` / ``assert_no_dense_intermediates``
    Report every floating-point output whose first dimension is the full
    vocabulary ``V`` and that has at least ``min_ndim`` dimensions, where
    the output's storage was allocated inside the call. On a RowSparse plan
    nothing between the client gather and the server's row update should be
    ``(V, ...)``-shaped: a hit means some step densified, and the O(R/V)
    transport win is gone.

What counts, and why:

- **Storage, not shape.** A view of a tensor that existed before the call
  (``detach``, ``view``, a slice of the table) shares its storage and is
  not a materialisation; a view of a buffer the call allocated is one (a
  ``(V + 1, D)`` scratch sliced to ``(V, D)`` shows up at the slice).
- **The table write.** The in-place scatter family (``index_add_``,
  ``index_put_``, ``scatter_add_``, ``scatter_``), the reference's
  ``_DEFAULT_ALLOWED``, writes the ``(V, D)`` table and is allowed by
  default. Its out-of-place forms copy the table first and are not.
- **Integer and bool workspaces** (the bitmap union's marks) are the union
  machinery's accepted O(V) cost and are ignored, as in the reference.

``donation_aliased`` and ``jit_cache_guard`` have no counterpart: the port
neither jits nor donates (no ``torch.compile`` under ``src/repro_torch/``);
``apply_rowsparse`` updates the table in place instead of aliasing it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "DenseIntermediate",
    "DenseMaterializationError",
    "find_dense_intermediates",
    "assert_no_dense_intermediates",
]

#: ops that may emit a vocab-sized array on a sparse plan: the server's row
#: update writes the (V, D) table in place
_DEFAULT_ALLOWED = ("aten.index_add_", "aten.index_put_", "aten.scatter_add_",
                    "aten.scatter_")


@dataclass(frozen=True)
class DenseIntermediate:
    """One vocab-sized float output the call allocated."""

    primitive: str      # the ATen op, e.g. "aten.zeros"
    shape: tuple
    dtype: str
    path: str           # the op's position in the call, e.g. "op 17"

    def __str__(self) -> str:
        return f"{self.primitive} -> {self.shape} {self.dtype} at {self.path}"


class DenseMaterializationError(AssertionError):
    """A RowSparse plan materialised a full-vocab intermediate."""

    def __init__(self, dim0: int, hits: Sequence[DenseIntermediate]):
        self.dim0 = dim0
        self.hits = tuple(hits)
        lines = "\n".join(f"  - {h}" for h in hits)
        super().__init__(
            f"found {len(hits)} dense (V={dim0}, ...) intermediate(s) on a "
            f"sparse-transport plan:\n{lines}")


def _op_name(func) -> str:
    """``aten.index_add_`` for the overload ``aten.index_add_.default``."""
    return f"{func.namespace}.{func.__name__.split('.')[0]}"


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Recorder(TorchDispatchMode):
    """Tracks which storages the call allocated and records the dense hits."""

    def __init__(self, dim0: int, min_ndim: int, allowed: frozenset):
        super().__init__()
        self.dim0, self.min_ndim, self.allowed = dim0, min_ndim, allowed
        self.fresh: set = set()
        self.hits: List[DenseIntermediate] = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        ins = {_storage(t) for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor) and t.numel()}
        name = _op_name(func)
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.numel() == 0:
                continue
            ptr = _storage(t)
            if ptr not in ins:
                self.fresh.add(ptr)              # this op allocated it
            if (name not in self.allowed and ptr in self.fresh and t.is_floating_point()
                    and t.dim() >= self.min_ndim and t.shape[0] == self.dim0):
                self.hits.append(DenseIntermediate(name, tuple(t.shape),
                                                   str(t.dtype).replace("torch.", ""),
                                                   f"op {self.ops}"))
        return out


def find_dense_intermediates(fn: Callable, *args, dim0: int, min_ndim: int = 2,
                             allowed_primitives: Sequence[str] = _DEFAULT_ALLOWED,
                             **kwargs) -> List[DenseIntermediate]:
    """Run ``fn(*args, **kwargs)`` once and list the float outputs shaped
    ``(dim0, ...)`` that it allocated (see the module docstring).

    ``dim0`` is the full vocabulary size V. The arguments' own tensors, and
    views of them, are exempt (the table legitimately enters as ``(V, D)``
    and is updated in place); the in-place scatter family is allowed by
    default.
    """
    rec = _Recorder(int(dim0), int(min_ndim), frozenset(allowed_primitives))
    with rec:
        fn(*args, **kwargs)
    return rec.hits


def assert_no_dense_intermediates(fn: Callable, *args, dim0: int, min_ndim: int = 2,
                                  allowed_primitives: Sequence[str] = _DEFAULT_ALLOWED,
                                  **kwargs) -> None:
    """Raise :class:`DenseMaterializationError` on any ``(dim0, ...)`` hit."""
    hits = find_dense_intermediates(fn, *args, dim0=dim0, min_ndim=min_ndim,
                                    allowed_primitives=allowed_primitives, **kwargs)
    if hits:
        raise DenseMaterializationError(dim0, hits)
