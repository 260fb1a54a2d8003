"""Seeded violation: reading a table after an in-place writer wrote it.

``apply_update`` adds the round's rows to ``table`` in place (the sparse
apply saves a table copy per round that way). A caller that keeps using
its own ``table`` after handing it over reads the updated rows where it
expects the old ones. The safe idiom rebinds the name in the writing
statement (``table = apply_update(table, ...)``). The linter must flag the
re-read below.

This file is an AST-only lint fixture: it is never imported or executed,
so the imports need not resolve.
"""
import torch


def apply_update(table, ids, rows, scale=1.0):
    return table.index_add_(0, ids, rows * scale)


def apply_tree(params, updates):
    """A writer too: it hands its parameter's leaves to a writer."""
    out = {}
    for name, p in params.items():
        out[name] = apply_update(p, updates[name][0], updates[name][1])
    return out


def run_bad(table, ids, rows):
    new_table = apply_update(table, ids, rows)
    return new_table - table        # VIOLATION: table was written above


def run_safe(table, ids, rows):
    # rebinding in the writing statement: later reads see the updated table
    table = apply_update(table, ids, rows)
    return table * 2.0


def run_safe_tree(params, updates):
    params = apply_tree(params, updates)
    return {k: v.sum() for k, v in params.items()}


def run_safe_copy(table, ids, rows):
    # a copy is written, not the caller's table
    new_table = apply_update(table.clone(), ids, rows)
    return new_table - table


def run_safe_branches(table, ids, rows, fresh):
    # one branch writes, the other reads: they never both run
    if fresh:
        out = apply_update(table, ids, rows)
    else:
        out = torch.zeros_like(table)
    return out
