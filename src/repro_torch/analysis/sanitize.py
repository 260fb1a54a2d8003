"""RowSparse contract checks behind ``RoundPlan(debug_checks=True)``.

The sparse plane's invariants (ids sorted and unique, ``-1`` pads trailing,
ids in range, zeroed pad rows, capacity drops largest first) hold by
construction in ``repro_torch.sparse``, and are silently wrong the moment a
caller hands in ids built another way. Each ``check_*`` function tests one
of them eagerly and raises ``ValueError`` naming the check and what broke.

The JAX package emits these checks inside its jitted step with ``checkify``
and runs the step through ``checked_jit``. The port's step runs eagerly, so
the checks are plain tensor predicates read back on the host (one sync
each) and neither ``checkify`` nor ``checked_jit`` has a port. With
``debug_checks`` off the step calls none of them: no extra op, no sync.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.rowsparse import RowSparse, membership

__all__ = ["check_union_ids", "check_rowsparse", "check_drop_order", "check_capacity"]


def _require(ok: torch.Tensor, msg: str) -> None:
    if not bool(ok.all()):
        raise ValueError(msg)


def check_union_ids(ids: torch.Tensor, vocab: int, *, name: str = "ids") -> None:
    """The ``unique_ids_padded`` contract along the last axis of ``ids``:
    pads are exactly ``-1`` and trailing, real ids strictly ascending and
    in ``[0, vocab)``. Leading (cohort) axes broadcast."""
    pad = ids < 0
    _require(torch.where(pad, ids == -1, True),
             f"{name}: negative id that is not the -1 pad sentinel")
    # pads trailing <=> padness never decreases along the slot axis
    _require(pad[..., 1:].to(torch.int8) >= pad[..., :-1].to(torch.int8),
             f"{name}: -1 pad slot precedes a real id (pads must be trailing)")
    both_real = ~pad[..., 1:] & ~pad[..., :-1]
    _require(torch.where(both_real, ids[..., 1:] > ids[..., :-1], True),
             f"{name}: ids not strictly ascending (must be sorted and unique)")
    _require(torch.where(~pad, ids < vocab, True), f"{name}: id out of range (>= vocab)")


def check_rowsparse(rs: RowSparse, *, name: str = "delta") -> None:
    """The whole RowSparse leaf contract: the id contract and zeroed pad rows."""
    check_union_ids(rs.ids, rs.num_rows, name=f"{name}.ids")
    pad = (rs.ids < 0).reshape(tuple(rs.ids.shape) + (1,) * (rs.rows.dim() - rs.ids.dim()))
    _require(torch.where(pad, rs.rows == 0, True),
             f"{name}.rows: non-zero payload in a -1 pad slot")


def check_drop_order(ids: torch.Tensor, tokens: torch.Tensor, *,
                     name: str = "ids") -> None:
    """Capacity drops were largest first.

    ``ids`` is a ``unique_ids_padded`` union of ``tokens``: unbatched, or
    one row per client with ``tokens`` ``(K, M)``. A non-negative token
    missing from its union is legal only when that union is full and the
    token is larger than every kept id.
    """
    member = membership(tokens, ids)
    real = ids >= 0
    full = real.all(dim=-1, keepdim=True)
    kept_max = torch.where(real, ids, -1).amax(dim=-1, keepdim=True)
    t = tokens.to(torch.int32)
    if ids.dim() > 1:
        t = t.reshape(tuple(ids.shape[:-1]) + (-1,))
    else:
        t, member = t.reshape(1, -1), member.reshape(1, -1)
    _require(member | (full & (t > kept_max)) | (t < 0),
             f"{name}: dropped id smaller than a kept id (drops must be "
             "largest-first) or missing without the union being full")


def check_capacity(capacity: int, vocab: int, *, name: str = "capacity") -> None:
    """Capacity is a multiple of 8 or the whole vocabulary: the sub-id
    buckets stay aligned, and the comm accounting prices what ships."""
    capacity = int(capacity)
    if capacity != int(vocab) and capacity % 8 != 0:
        raise ValueError(
            f"{name}={capacity} is neither a multiple of 8 nor the full vocab "
            f"({vocab}): capacity buckets must be aligned")
