"""Replant of a closed fault: a rank's part was a view of the whole leaf.

A rank kept its part of a leaf split by leading rows as ``leaf[lo:hi]``
(``.contiguous()`` is a no-op on such a slice), so the part shared the
whole leaf's storage: the in-place sparse apply on the part wrote the
caller's table, which the caller then read as if untouched. The repair
copies the part.

This file is an AST-only lint fixture: it is never imported or executed,
so the imports need not resolve.
"""


def apply_rows(table, rs, scale=1.0):
    valid = rs.ids >= 0
    return table.index_add_(0, rs.ids.clamp(min=0), rs.rows * valid[:, None] * scale)


def rank_round_bad(leaf, rs, lo, hi):
    own = leaf[lo:hi].contiguous()
    own = apply_rows(own, rs)
    return own, leaf.norm()         # VIOLATION: the apply wrote leaf through own


def rank_round_good(leaf, rs, lo, hi):
    own = leaf[lo:hi].clone()
    own = apply_rows(own, rs)
    return own, leaf.norm()
