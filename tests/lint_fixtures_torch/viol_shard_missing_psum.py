"""Seeded fixture: a per-rank reduction with no collective in reach.

Inside a shard body ``losses.mean()`` collapses THIS rank's slice only;
unless the result feeds a collective over the mesh axis (or the per-rank
intent is suppressed with a reason), every rank reports a different "mean"
and the metrics silently diverge from one device's.

This file is an AST-only lint fixture: it is never imported or executed,
so the imports need not resolve.
"""
import torch

from repro_torch.launch.mesh import shard_body
from repro_torch.sharding.parallel import sum_over_model
from repro_torch.telemetry.round import tree_sq_sum


@shard_body
def bad_loss_body(losses, mesh):
    return losses.mean()  # VIOLATION: per-rank mean, never combined


@shard_body
def good_loss_body(losses, mesh):
    # the two-statement combine idiom
    shard_sum = losses.sum()
    total = mesh.psum(shard_sum, "loss")
    return total / (losses.shape[0] * mesh.size)


@shard_body
def good_nested_body(update, wmask, mesh):
    # a reduction nested in the collective is combined on the spot
    return mesh.psum((update * wmask).sum(dim=0), "dense_tree")


@shard_body
def good_model_norm(group, parts):
    # a split leaf's squares fed to the model axis's psum
    sq = tree_sq_sum(group)
    sq = parts.model.psum(sq, "telemetry:norms")
    return sq


@shard_body
def good_split_norm(x, mesh):
    return sum_over_model(torch.sum(x * x, dim=-1), mesh, "norm")


def host_mean(losses):
    """Not a shard body: its reductions are the caller's business."""
    return losses.mean()
