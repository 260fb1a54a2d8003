"""Seeded fixture: a full heat-fused aggregate inside a shard body.

Every rank holds a PARTIAL cohort, so the fused ``aggregate_rowsparse``
(which applies the N/n_m heat correction) run per rank corrects per-rank
counts, and the cross-rank psum then sums already-corrected partials: a
silent double correction. The partial/combine split
(``aggregate_rowsparse_partial`` + ``combine_rowsparse_partials``) is the
sound decomposition.

This file is an AST-only lint fixture: it is never imported or executed,
so the imports need not resolve.
"""
from repro_torch.launch.mesh import shard_body
from repro_torch.sparse.aggregate import (aggregate_rowsparse,
                                          aggregate_rowsparse_partial,
                                          combine_rowsparse_partials)
from repro_torch.sparse.rowsparse import RowSparse


@shard_body
def bad_shard_body(stacked, heat, total, mesh):
    agg = aggregate_rowsparse(stacked, heat, total)  # VIOLATION: full aggregate per rank
    return mesh.psum(agg.to_dense(), "combine")


@shard_body
def good_shard_body(stacked, heat, total, mesh):
    partial = aggregate_rowsparse_partial(stacked)
    return combine_rowsparse_partials(partial, mesh, heat, total, 1.0)


def union_combine(partial, mesh, heat, total, scale):
    """The union combine's shape: all-gather the partials, then aggregate
    the gathered stack once. Calling a collective does not make a shard
    body, so this stays silent."""
    v = partial.num_rows
    ids = mesh.all_gather(partial.ids, "combine")
    rows = mesh.all_gather(partial.rows, "combine")
    return aggregate_rowsparse(RowSparse(ids, rows, v), heat, total, scale)
