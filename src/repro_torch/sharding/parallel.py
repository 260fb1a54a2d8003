"""The collectives of a model split over the ``model`` ranks.

The JAX package states a layout (``constrain``) and GSPMD inserts the
collectives that keep it. The port runs SPMD, one process per rank, and
says each collective where the layout needs it, as Megatron-LM's tensor
parallelism does:

``copy_to_model``      identity forward, all-reduce of the gradient: the
                       input of a split computation (a column-parallel
                       linear), whose gradient each rank holds in part
``reduce_from_model``  all-reduce forward, identity backward: the output
                       of a row-parallel linear, a partial sum on each rank
``gather_from_model``  all-gather on a dim forward, this rank's slice of
                       the gradient backward (the MoE router's logits)
``max_from_model``     max all-reduce, no gradient (the vocabulary-parallel
                       cross-entropy's shift)
``mean_over``          the mean over an axis's ranks whose gradient passes
                       unchanged: a statistic of the whole batch (the MoE's
                       load-balance means) on ranks that each hold part of
                       it, under a round step that averages their gradients
``gather_for_model``   all-gather on a dim forward, reduce-scatter of the
                       gradient backward (this rank's slice of the sum over
                       the ranks): columns that every rank gathers whole
                       and then uses in part (Mamba2's fused projection and
                       conv output, each rank taking its SSM heads; the
                       mLSTM's up projection)
``gather_for_data``    the same over the ``data`` ranks, for FSDP: a
                       weight's slice of ``d_model`` gathered whole where a
                       layer uses it, its gradient summed over the data
                       ranks and scattered back to each rank's slice
``lookup_for_data``    FSDP's embedding lookup: the rows a batch uses of a
                       table whose columns are split over ``data``, made
                       whole-width by gathering those rows, not the table
``sum_over_model``     ``copy_to_model`` of ``reduce_from_model``, an
                       all-reduce forward and backward: a sum that every
                       rank then uses in part (the sum of squares of an
                       RMSNorm over a dim split over ``model``)

and, for serving with the KV cache split by sequence over ``model``,
``merge_decode_partials``: the ranks' K4 partials ``(o, lse)`` over their
slices of the cache merged by log-sum-exp (no gradient), the distributed
form the reference kernel's docstring names
(``src/repro/kernels/flash_decode.py:8-9``); ``merge_decode_slices`` is the
same merge over a list of slices in one process.

Each is a ``torch.autograd.Function`` with ``setup_context``, so that
``torch.func.grad_and_value`` (the round step) and ``torch.func.vjp`` (remat's
recompute) reach through it; its forward gets plain tensors, which the
collective may read. They do not support ``vmap``. ``mesh`` is an axis's
:class:`~repro_torch.launch.mesh.CohortMesh` (the model axis, but for the
MoE's routing over the batch's ranks and FSDP's gathers over the ``data``
ranks); each collective is counted on it
under ``tag``. A backward all-reduce receives the gradient the
rank holds: every rank must run the same backward, which the round step's
replicated loss gives.
"""
from __future__ import annotations

import torch


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, tag):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.tag = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh, ctx.tag), None, None


class _AllReduce(torch.autograd.Function):
    """A sum over the model ranks whose gradient passes unchanged (the
    upstream gradient is the same on every rank)."""

    @staticmethod
    def forward(x, mesh, tag):
        return mesh.psum(x, tag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, tag, dim):
        parts = mesh.all_gather(x, tag)                       # (m,) + x.shape
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mesh, _, dim = inputs
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.width, ctx.width), None, None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather on ``dim`` forward, reduce-scatter on ``dim`` backward."""

    @staticmethod
    def forward(x, mesh, tag, grad_tag, dim):
        return _GatherFromModel.forward(x, mesh, tag, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, _, ctx.grad_tag, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.mesh, ctx.grad_tag, ctx.dim), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """This rank's slice on ``dim`` of the sum over the ranks (the backward
    of ``_GatherScatter``, applied as a Function so that its collective
    reads plain tensors under ``torch.func``); its own gradient gathers."""

    @staticmethod
    def forward(g, mesh, tag, dim):
        return mesh.reduce_scatter(g, tag, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.tag, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g):
        return _GatherScatter.apply(g, ctx.mesh, ctx.tag, ctx.tag, ctx.dim), None, None, None


class _MaxFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, tag):
        return mesh.pmax(x, tag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, tag):
        return mesh.pmean(x, tag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
    """``x`` (a copy) whose gradient is summed over the model ranks."""
    return _CopyToModel.apply(x, mesh, tag)


def reduce_from_model(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
    """The sum of every model rank's ``x``; the gradient passes unchanged."""
    return _AllReduce.apply(x, mesh, tag)


def gather_from_model(x: torch.Tensor, mesh, tag: str, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated on ``dim`` in rank order; the
    gradient of this rank's part is its slice."""
    return _GatherFromModel.apply(x, mesh, tag, dim % x.dim())


def gather_for_model(x: torch.Tensor, mesh, tag: str, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated on ``dim`` in rank order, for
    ranks that each use a different part of it: the gradient is summed over
    the ranks and scattered, this rank receiving its slice (a reduce-scatter
    counted under ``tag + "_grad"``)."""
    return _GatherScatter.apply(x, mesh, tag, f"{tag}_grad", dim % x.dim())


def gather_for_data(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """FSDP's gather: every data rank's slice of a weight concatenated on
    ``dim`` (its ``d_model``) in rank order, counted under ``fsdp_gather``.
    The gradient each rank holds for the whole weight (of its own part of
    the batch) is summed over the data ranks and scattered back, this rank
    receiving the sum's slice (a reduce-scatter counted under
    ``fsdp_grad``): the round step then scales it by the number of batch
    shards and does not average it over ``data`` again."""
    return _GatherScatter.apply(x, mesh, "fsdp_gather", "fsdp_grad", dim % x.dim())


def lookup_for_data(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """``table[ids]`` whole-width, where FSDP splits ``table``'s columns
    (``d_model``) over the data ranks (``mesh``) and each rank looks up its
    own ``ids``: every rank's ids are all-gathered (int32, ``fsdp_ids``),
    each rank looks them all up in its columns, and the rows are
    all-gathered (``gather_for_data``) and the rank's own taken, columns in
    rank order. The gradient of the rows is reduce-scattered back
    (``fsdp_grad``), so each rank's columns receive every rank's rows'
    gradient, which the lookup's backward adds into its slice. A step
    moves ``data`` times the rows it uses, not the table."""
    # through a Function, whose forward reads plain tensors under torch.func
    every = gather_from_model(ids.to(torch.int32)[None], mesh, "fsdp_ids", 0).long()
    rows = gather_for_data(table[every][None], mesh, 0)[:, mesh.rank]  # (n, *ids, d / n)
    return rows.movedim(0, -2).flatten(-2)


def sum_over_model(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
    """The sum of every model rank's ``x``, for ranks that each use it in
    part: the gradient is summed over the ranks too (both counted under
    ``tag``)."""
    return copy_to_model(reduce_from_model(x, mesh, tag), mesh, tag)


def max_from_model(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
    """The elementwise max over the model ranks, with no gradient. A max
    is exact in any order, so gloo's and NCCL's agree bit for bit."""
    return _MaxFromModel.apply(x.detach(), mesh, tag)


def mean_over(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
    """The mean of ``x`` over ``mesh``'s ranks, its gradient passed to each
    unchanged. Each rank's loss takes the mean, and the round step averages
    the ranks' gradients; the gradient of the mean through rank r's ``x`` is
    then the upstream gradient, not its 1/size share."""
    return _MeanOver.apply(x, mesh, tag)


def _lse_weights(lse: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Each slice's weight ``exp(lse - top)`` against the max over the
    slices; where every slice is empty (``top`` -inf) each weighs 1, so
    that the merge is the mean of the slices' o, the mean of V over every
    slot (the slices are of equal length), as the reference gives a row
    with no valid slot. No host sync."""
    empty = top == float("-inf")
    return torch.where(empty, 1.0, torch.exp(lse - torch.where(empty, 0.0, top)))


def merge_decode_partials(o: torch.Tensor, lse: torch.Tensor, mesh,
                          dtype: torch.dtype) -> torch.Tensor:
    """Merge the model ranks' single-token attention over their slices of
    the cache: ``o`` ``(B, H, hd)`` f32 and ``lse`` ``(B, H)`` f32 from
    ``flash_decode(..., return_lse=True)`` on this rank's slice. ``M =
    pmax(lse)``, ``w = exp(lse - M)``, ``o = psum(w o) / psum(w)``, with
    ``w o`` and ``w`` sent in one all-reduce of ``(B, H, hd + 1)`` f32; cast
    to ``dtype`` (the cache's) once, after the merge. ``mesh`` is the model
    axis's ``CohortMesh``; the collectives are counted under ``decode_max``
    and ``decode_merge``."""
    top = mesh.pmax(lse, "decode_max")
    w = _lse_weights(lse, top)[..., None]
    both = mesh.psum(torch.cat([o * w, w], dim=-1), "decode_merge")
    return (both[..., :-1] / both[..., -1:]).to(dtype)


def merge_decode_slices(os, lses, dtype: torch.dtype) -> torch.Tensor:
    """``merge_decode_partials`` over a list of slices' ``(o, lse)`` in one
    process (the slices in list order)."""
    top = torch.stack(list(lses)).amax(dim=0)
    num = den = None
    for o, lse in zip(os, lses):
        w = _lse_weights(lse, top)[..., None]
        num = o * w if num is None else num + o * w
        den = w if den is None else den + w
    return (num / den).to(dtype)
