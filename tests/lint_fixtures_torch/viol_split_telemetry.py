"""Replant of a closed fault: telemetry on a model split was the slice's.

On a ``(data, model)`` mesh a leaf split over ``model`` holds the rank's
slice of it. Its squares summed on the rank are the slice's, so the update
norm a round reports was one rank's slice's, not the leaf's (1.074213
against 1.108233 on the tiny Qwen2.5, ``(2, 2)``). The repair sums the
split leaves' squares over ``model``.

This file is an AST-only lint fixture: it is never imported or executed,
so the imports need not resolve.
"""
import torch

from repro_torch.launch.mesh import shard_body


@shard_body
def telemetry_bad(update, parts, mesh):
    whole = {n: g for n, g in update.items() if n not in parts.model_leaves}
    split = {n: g for n, g in update.items() if n in parts.model_leaves}
    sq = mesh.psum(sum(torch.sum(g * g) for g in whole.values()), "telemetry:norms")
    sq_split = sum(torch.sum(g * g) for g in split.values())  # VIOLATION: the slice's
    return {"pre": sq + sq_split}


@shard_body
def telemetry_good(update, parts, mesh):
    whole = {n: g for n, g in update.items() if n not in parts.model_leaves}
    split = {n: g for n, g in update.items() if n in parts.model_leaves}
    sq = mesh.psum(sum(torch.sum(g * g) for g in whole.values()), "telemetry:norms")
    sq_split = sum(torch.sum(g * g) for g in split.values())
    sq_split = parts.model.psum(sq_split, "telemetry:norms")
    return {"pre": sq + sq_split}
