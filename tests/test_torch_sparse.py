"""Port parity, sparse plane and kernels: id helpers, the plain versions of
K1 (``union_segsum``) and K2 (``rowsparse_scatter``) against the JAX
package's interpret-mode kernels and oracles, the union backends, top-k, the
apply, and the submodel client delta. Inputs are made by numpy from a seed
and fed to both packages. The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here every wrapper gets CPU tensors."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.federated.client import cohort_submodel_deltas as j_cohort_deltas
from repro.federated.client import make_submodel_local_trainer as j_local_trainer
from repro.federated.server import derive_sub_ids as j_derive_sub_ids
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.union_segsum import union_segsum as j_union_segsum
from repro.models.recsys import lr_loss as j_lr_loss
from repro.sparse import RowSparse as JRowSparse
from repro.sparse import aggregate_rowsparse as j_aggregate
from repro.sparse import apply_rowsparse as j_apply
from repro.sparse import count_unique_ids as j_count_unique
from repro.sparse import remap_ids as j_remap
from repro.sparse import topk_rows as j_topk_rows
from repro.sparse import unique_ids_padded as j_unique

from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.federated.client import (cohort_submodel_deltas,
                                          make_submodel_local_trainer)
from repro_torch.federated.server import derive_sub_ids
from repro_torch.kernels import _rows
from repro_torch.kernels.heat_scatter import rowsparse_scatter, rowsparse_scatter_torch
from repro_torch.kernels.ref import heat_scatter_ref
from repro_torch.kernels.union_segsum import union_segsum, union_segsum_torch
from repro_torch.models.recsys import lr_loss
from repro_torch.sparse.aggregate import (aggregate_rowsparse,
                                          aggregate_rowsparse_dense,
                                          apply_rowsparse)
from repro_torch.sparse.compress import topk_rows
from repro_torch.sparse.rowsparse import (RowSparse, count_unique_ids, remap_ids,
                                          unique_ids_padded)

F32_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_kernels.py:14-15
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _t(x):
    return torch.from_numpy(np.array(x))    # a writable copy


def _random_cohort(rng, k, v, d, max_rows):
    """Per-client sorted supports (duplicates across clients), -1 padded."""
    ids = np.full((k, max_rows), -1, np.int32)
    rows = np.zeros((k, max_rows, d), np.float32)
    for i in range(k):
        n = int(rng.integers(1, max_rows + 1))
        ids[i, :n] = np.sort(rng.choice(v, size=n, replace=False))
        rows[i, :n] = rng.normal(size=(n, d))
    return ids, rows


def _hot_cohort(rng, k, v, d, max_rows, hot):
    """Zipf-skewed supports (low ids are common) in which id ``hot`` is held
    by every client, -1 padded."""
    ids = np.full((k, max_rows), -1, np.int32)
    rows = np.zeros((k, max_rows, d), np.float32)
    for i in range(k):
        pick = np.minimum(rng.zipf(1.5, size=int(rng.integers(1, max_rows))) - 1, v - 1)
        u = np.unique(np.append(pick, hot))
        ids[i, :len(u)] = u
        rows[i, :len(u)] = rng.normal(size=(len(u), d))
    return ids, rows


@pytest.fixture
def jax_kernel(monkeypatch):
    """The JAX ``union_segsum`` kernel, runnable in interpret mode here.

    Its body calls ``pl.store``, which this jax release no longer has; the
    shim gives it the indexed-ref assignment that replaced it, so the
    reference kernel runs unchanged.
    """
    from jax.experimental import pallas as pl

    def store(ref, idx, val):
        ref[idx] = val

    if not hasattr(pl, "store"):
        monkeypatch.setattr(pl, "store", store, raising=False)
    return j_union_segsum


def _heat_of(ids, v):
    heat = np.zeros(v, np.float32)
    for row in ids:
        heat[row[row >= 0]] += 1
    return heat


# ---------------------------------------------------------------------------
# id helpers (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cap", [4, 48, 64])
def test_unique_count_remap_exact(seed, cap):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-1, 40, size=64).astype(np.int32)
    want = np.asarray(j_unique(jnp.asarray(raw), cap))
    got = unique_ids_padded(_t(raw), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert int(count_unique_ids(_t(raw))) == int(j_count_unique(jnp.asarray(raw)))
    if cap >= 40:   # remap needs coverage
        np.testing.assert_array_equal(
            remap_ids(_t(raw), got).numpy(),
            np.asarray(j_remap(jnp.asarray(raw), jnp.asarray(want))))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_sub_ids_match_per_client_reference(seed):
    """The port derives a cohort's sub-ids along the last axis in one call;
    the reference maps the unbatched helper over clients."""
    rng = np.random.default_rng(seed)
    feats = rng.integers(-3, 60, size=(6, 125)).astype(np.int32)
    want = np.asarray(j_derive_sub_ids(jnp.asarray(feats), 50, 64))
    got = derive_sub_ids(_t(feats), 50, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    tokens = np.where(feats < 50, feats, -1).reshape(6, 5, 25)
    np.testing.assert_array_equal(
        remap_ids(_t(tokens), got).numpy(),
        np.stack([np.asarray(j_remap(jnp.asarray(t), jnp.asarray(w)))
                  for t, w in zip(tokens, want)]))


# ---------------------------------------------------------------------------
# K1 union_segsum: plain version vs the JAX kernel (interpret) and backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("v,v_blk,t_blk", [(64, 16, 32), (101, 32, 64), (37, 8, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_union_segsum_plain_matches_jax_kernel_and_backends(jax_kernel, seed, v,
                                                            v_blk, t_blk, dtype):
    rng = np.random.default_rng(seed)
    k, d = 4, 5
    ids, rows = _random_cohort(rng, k, v, d, max_rows=max(v // 3, 4))
    heat = _heat_of(ids, v)
    total, scale = 24.0, 0.25
    cap = min(v, ids.size)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    j_rows = jnp.asarray(rows).astype(dtype)
    t_rows = _t(rows).to(getattr(torch, dtype))
    u_ids, u_rows = jax_kernel(jnp.asarray(ids), j_rows, jnp.asarray(heat),
                               total, cap, v, scale=scale, v_blk=v_blk,
                               t_blk=t_blk)
    got_ids, got_rows = union_segsum_torch(_t(ids), t_rows, _t(heat), total,
                                           cap, v, scale=scale)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(u_ids))
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(u_rows), **tol)
    # the CPU wrapper is the plain version; every torch backend agrees with
    # the JAX backend of the same name
    w_ids, w_rows = union_segsum(_t(ids), t_rows, _t(heat), total, cap, v,
                                 scale=scale)
    np.testing.assert_array_equal(w_ids.numpy(), got_ids.numpy())
    np.testing.assert_array_equal(w_rows.numpy(), got_rows.numpy())
    stacked_j = JRowSparse(jnp.asarray(ids), j_rows, v)
    stacked_t = RowSparse(_t(ids), t_rows, v)
    for backend in ("bitmap", "sort", "auto"):
        want = j_aggregate(stacked_j, jnp.asarray(heat), total, scale,
                           union_backend=backend)
        got = aggregate_rowsparse(stacked_t, _t(heat), total, scale,
                                  union_backend=backend)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids),
                                      err_msg=backend)
        np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                                   err_msg=backend, **tol)


@pytest.mark.parametrize("heat_on", [True, False])
def test_union_segsum_all_pad_clients_exact_cap_and_overflow(jax_kernel, rng,
                                                              heat_on):
    v, d = 40, 3
    ids = np.array([[3, 7, 11, -1], [-1, -1, -1, -1], [7, 20, -1, -1]], np.int32)
    rows = rng.normal(size=(3, 4, d)).astype(np.float32)
    rows[ids < 0] = 0
    heat = rng.integers(0, 5, v).astype(np.float32) if heat_on else None
    j_heat = jnp.asarray(heat) if heat_on else None
    t_heat = _t(heat) if heat_on else None
    for cap in (4, 3, 7):     # exact union size, overflow, slack
        u_ids, u_rows = jax_kernel(jnp.asarray(ids), jnp.asarray(rows),
                                   j_heat, 10.0, cap, v, scale=0.5)
        got_ids, got_rows = union_segsum_torch(_t(ids), _t(rows), t_heat, 10.0,
                                               cap, v, scale=0.5)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(u_ids))
        np.testing.assert_allclose(got_rows.numpy(), np.asarray(u_rows), **F32_TOL)
        for backend in ("bitmap", "sort"):
            want = j_aggregate(JRowSparse(jnp.asarray(ids), jnp.asarray(rows), v),
                               j_heat, 10.0, 0.5, union_capacity=cap,
                               union_backend=backend)
            got = aggregate_rowsparse(RowSparse(_t(ids), _t(rows), v), t_heat,
                                      10.0, 0.5, union_capacity=cap,
                                      union_backend=backend)
            np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
            np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                                       **F32_TOL)
    lone_ids, lone_rows = union_segsum_torch(_t(ids[1:2]), _t(rows[1:2]), t_heat,
                                             10.0, 4, v)
    assert (lone_ids.numpy() == -1).all() and (lone_rows.numpy() == 0).all()


@pytest.mark.parametrize("skew", ["uniform", "hot"])
@pytest.mark.parametrize("d", [1, 18, 25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_union_segsum_plain_matches_jax_kernel_at_the_port_widths(jax_kernel, skew, d,
                                                                  dtype):
    """The widths the CUDA kernel branches on (LR 1, DIN 18, LSTM 25: vector
    widths 1, 2, 1) and a cohort whose hot id every client holds."""
    rng = np.random.default_rng(d)
    k, v = 6, 96
    ids, rows = (_random_cohort(rng, k, v, d, max_rows=24) if skew == "uniform"
                 else _hot_cohort(rng, k, v, d, max_rows=24, hot=5))
    if skew == "hot":
        assert (ids == 5).any(axis=1).all()
    heat = _heat_of(ids, v) * 4.0
    total, scale, cap = 24.0, 1.0 / k, min(v, ids.size)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    j_rows = jnp.asarray(rows).astype(dtype)
    t_rows = _t(rows).to(getattr(torch, dtype))
    u_ids, u_rows = jax_kernel(jnp.asarray(ids), j_rows, jnp.asarray(heat), total, cap, v,
                               scale=scale, v_blk=32, t_blk=48)
    got_ids, got_rows = union_segsum_torch(_t(ids), t_rows, _t(heat), total, cap, v,
                                           scale=scale)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(u_ids))
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(u_rows), **tol)
    w_ids, w_rows = union_segsum(_t(ids), t_rows, _t(heat), total, cap, v, scale=scale)
    np.testing.assert_array_equal(w_ids.numpy(), got_ids.numpy())
    np.testing.assert_array_equal(w_rows.numpy(), got_rows.numpy())


def test_union_segsum_drops_ids_outside_the_table(rng):
    """Ids >= V are dropped like pads (the kernel's contract); the union of
    the remaining ids is unchanged."""
    v, d = 30, 2
    ids = np.array([[1, 5, 31, 40], [5, 29, 30, -1]], np.int32)
    rows = rng.normal(size=(2, 4, d)).astype(np.float32)
    heat = np.ones(v, np.float32)
    got_ids, got_rows = union_segsum_torch(_t(ids), _t(rows), _t(heat), 2.0, 8, v)
    keep = (ids >= 0) & (ids < v)
    want_ids, want_rows = union_segsum_torch(_t(np.where(keep, ids, -1)),
                                             _t(rows * keep[..., None]),
                                             _t(heat), 2.0, 8, v)
    np.testing.assert_array_equal(got_ids.numpy(), [1, 5, 29, -1, -1, -1, -1, -1])
    np.testing.assert_array_equal(got_ids.numpy(), want_ids.numpy())
    np.testing.assert_array_equal(got_rows.numpy(), want_rows.numpy())
    sort = aggregate_rowsparse(RowSparse(_t(ids), _t(rows), v), _t(heat), 2.0,
                               union_capacity=8, union_backend="sort")
    np.testing.assert_array_equal(sort.ids.numpy(), got_ids.numpy())
    np.testing.assert_allclose(sort.rows.numpy(), got_rows.numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# K2 rowsparse_scatter: plain version vs the JAX oracle and kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,d,v,v_blk,t_blk", [
    (256, 8, 64, 16, 64),
    (1024, 32, 128, 128, 256),
    (512, 16, 512, 512, 512),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowsparse_scatter_plain_matches_jax(rng, t, d, v, v_blk, t_blk, dtype):
    ids = rng.integers(-1, v, t).astype(np.int32)
    rows = rng.normal(0, 1, (t, d)).astype(np.float32)
    heat = rng.integers(0, 9, v).astype(np.float32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    j_rows = jnp.asarray(rows).astype(dtype)
    t_rows = _t(rows).to(getattr(torch, dtype))
    got = rowsparse_scatter_torch(_t(ids), t_rows, _t(heat), 100.0, v, scale=0.125)
    want_ref = j_ref.rowsparse_scatter_ref(jnp.asarray(ids), j_rows,
                                           jnp.asarray(heat), 100.0, v, scale=0.125)
    want_kernel = j_ops.rowsparse_scatter(jnp.asarray(ids), j_rows,
                                          jnp.asarray(heat), 100.0, v,
                                          scale=0.125, v_blk=v_blk, t_blk=t_blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **tol)
    np.testing.assert_array_equal(
        rowsparse_scatter(_t(ids), t_rows, _t(heat), 100.0, v, scale=0.125).numpy(),
        got.numpy())
    np.testing.assert_allclose(
        heat_scatter_ref(_t(ids), t_rows, _t(heat), 100.0, v).numpy(),
        np.asarray(j_ref.heat_scatter_ref(jnp.asarray(ids), j_rows,
                                          jnp.asarray(heat), 100.0, v)), **tol)


@pytest.mark.parametrize("skew", ["uniform", "hot"])
@pytest.mark.parametrize("d", [1, 18, 25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowsparse_scatter_plain_matches_jax_at_the_port_widths(skew, d, dtype):
    rng = np.random.default_rng(100 + d)
    k, v = 6, 96
    ids, rows = (_random_cohort(rng, k, v, d, max_rows=24) if skew == "uniform"
                 else _hot_cohort(rng, k, v, d, max_rows=24, hot=5))
    ids, rows = ids.reshape(-1), rows.reshape(-1, d)
    heat = _heat_of(ids[None], v) * 4.0
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    j_rows = jnp.asarray(rows).astype(dtype)
    t_rows = _t(rows).to(getattr(torch, dtype))
    got = rowsparse_scatter_torch(_t(ids), t_rows, _t(heat), 24.0, v, scale=1.0 / k)
    want_ref = j_ref.rowsparse_scatter_ref(jnp.asarray(ids), j_rows, jnp.asarray(heat),
                                           24.0, v, scale=1.0 / k)
    want_kernel = j_ops.rowsparse_scatter(jnp.asarray(ids), j_rows, jnp.asarray(heat),
                                          24.0, v, scale=1.0 / k, v_blk=32, t_blk=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **tol)
    np.testing.assert_array_equal(
        rowsparse_scatter(_t(ids), t_rows, _t(heat), 24.0, v, scale=1.0 / k).numpy(),
        got.numpy())


@pytest.mark.parametrize("shape,t,d,v,cap,vec,team,blocks", [
    # the LR trainer's round: V = 37,069, 100 clients x 128 rows, D = 1
    ("trainer", 12_800, 1, 37_069, 12_800, 1, 1, 25),
    # the aggregation-heavy shape: V = 2^22, 1,000 x 512 rows, DIN's D = 18
    ("heavy", 512_000, 18, 1 << 22, 512_000, 2, 16, 396),
    ("LSTM width", 12_800, 25, 37_069, 12_800, 1, 32, 396),
    ("wide", 32_768, 16, 262_144, 32_768, 4, 4, 256),
    ("empty", 0, 0, 0, 1, 4, 1, 1),
])
def test_k1_launch_plan(shape, t, d, v, cap, vec, team, blocks):
    """Vector width, team and grid of K1 at the shapes the card runs, and a
    scratch of one (bits, rank offset) pair per 32 table rows plus one int
    per block: ~V/4 bytes, never a V-sized array."""
    assert _rows.vector_width(d, 1 << 20, 4) == vec
    plan = _rows.union_plan(t, d, v, cap, vec, max_blocks=3 * 132)
    assert (plan.vec, plan.team, plan.blocks) == (vec, team, blocks)
    assert plan.words == -(-v // 32)
    assert plan.scratch_bytes == 8 * -(-v // 32) + 4 * plan.blocks
    assert plan.scratch_bytes <= v / 4 + 8 + 4 * plan.blocks
    if v:
        assert plan.scratch_bytes < 4 * v      # less than one int32 per row


@pytest.mark.parametrize("t,d,v,vec,team,blocks", [
    (12_800, 1, 37_069, 1, 1, 25),            # the trainer's round
    (512_000, 18, 1 << 22, 2, 16, 396),       # the heavy shape
    (0, 18, 37_069, 2, 16, 326),              # no rows: the zero phase alone
])
def test_k2_launch_plan(t, d, v, vec, team, blocks):
    plan = _rows.scatter_plan(t, d, v, vec, max_blocks=3 * 132)
    assert (plan.vec, plan.team, plan.blocks, plan.scratch_ints) == (
        vec, team, blocks, blocks)


@pytest.mark.parametrize("d,ptr,esize,vec", [
    (16, 0, 4, 4), (16, 8, 4, 2), (16, 4, 4, 1), (18, 0, 4, 2), (18, 2, 2, 1),
    (8, 8, 2, 4), (25, 0, 4, 1), (1, 0, 2, 1),
])
def test_vector_width_follows_width_and_alignment(d, ptr, esize, vec):
    assert _rows.vector_width(d, ptr, esize) == vec
    assert _rows.team_size(d, vec) == min(32, 1 << (max(d // vec, 1) - 1).bit_length())


def test_wrappers_never_fall_back_on_a_device_tensor():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not handed to the plain version."""
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    rows = torch.zeros((4, 18), device="meta")
    heat = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        union_segsum(ids, rows, heat, 1.0, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rowsparse_scatter(ids, rows, heat, 1.0, 8)


def test_aggregate_rowsparse_dense_union_matches_plain_k2(rng):
    k, v, d = 4, 64, 8
    ids, rows = _random_cohort(rng, k, v, d, max_rows=12)
    heat = rng.integers(0, 4, v).astype(np.float32)
    got = aggregate_rowsparse_dense(RowSparse(_t(ids), _t(rows), v), _t(heat),
                                    32.0, scale=0.25)
    want = rowsparse_scatter_torch(_t(ids.reshape(-1)), _t(rows.reshape(-1, d)),
                                   _t(heat), 32.0, v, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_cuda_backends_refuse_cpu_tensors(rng):
    """An explicit CUDA backend on CPU tensors raises; it never falls back."""
    ids, rows = _random_cohort(rng, 3, 20, 2, max_rows=5)
    stacked = RowSparse(_t(ids), _t(rows), 20)
    heat = _t(np.ones(20, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        aggregate_rowsparse(stacked, heat, 3.0, union_backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        aggregate_rowsparse_dense(stacked, heat, 3.0, backend="cuda")


# ---------------------------------------------------------------------------
# compression, apply, client delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_topk_rows_tied_norms_keep_lower_slots(k):
    """LR deltas tie exactly (a client's gender and age rows); the port keeps
    the lower slot among equal norms, as ``jax.lax.top_k`` does."""
    ids = np.array([[0, 2, 5, 7, 9, 11, -1, -1],
                    [1, 3, 4, 8, -1, -1, -1, -1]], np.int32)
    rows = np.array([[1., 3., 3., 2., -3., 3., 0., 0.],
                     [2., -2., 2., 2., 0., 0., 0., 0.]], np.float32)[..., None]
    got = topk_rows(RowSparse(_t(ids), _t(rows), 20), k)
    for c in range(2):
        want = j_topk_rows(JRowSparse(jnp.asarray(ids[c]), jnp.asarray(rows[c]), 20), k)
        np.testing.assert_array_equal(got.ids[c].numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.rows[c].numpy(), np.asarray(want.rows))


def test_apply_rowsparse_matches_reference(rng):
    v, d = 16, 2
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = np.array([0, 3, 9, -1], np.int32)
    rows = rng.normal(size=(4, d)).astype(np.float32) * (ids >= 0)[:, None]
    want = j_apply(jnp.asarray(table), JRowSparse(jnp.asarray(ids), jnp.asarray(rows), v), 0.5)
    got = apply_rowsparse(_t(table.copy()), RowSparse(_t(ids), _t(rows), v), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("init", ["zeros", "normal"])
@pytest.mark.parametrize("alg", ["fedavg", "fedprox"])
def test_submodel_client_delta_matches(rng, init, alg):
    k, i, b, f, v = 4, 5, 5, 5, 60
    feats = rng.integers(-1, v, (k, i, b, f)).astype(np.int32)
    batch = {"features": feats,
             "label": rng.integers(0, 2, (k, i, b)).astype(np.int32),
             "sample_mask": np.ones((k, i, b), np.float32)}
    np_params = {"w": np.zeros((v, 1), np.float32), "b": np.zeros((1,), np.float32)}
    if init == "normal":
        np_params = {"w": rng.normal(size=(v, 1)).astype(np.float32),
                     "b": rng.normal(size=(1,)).astype(np.float32)}
    kw = dict(local_iters=i, local_batch=b, lr=0.5, algorithm=alg, prox_mu=0.3)
    sub = np.asarray(j_derive_sub_ids(jnp.asarray(feats.reshape(k, -1)), v, 128))
    want = j_cohort_deltas(
        j_local_trainer(j_lr_loss, JFedConfig(**kw), [("w",)], ("features",)),
        jax.tree.map(jnp.asarray, np_params),
        {key: jnp.asarray(val) for key, val in batch.items()}, jnp.asarray(sub))
    params, _ = params_from_jax(np_params, device="cpu")
    got = cohort_submodel_deltas(
        make_submodel_local_trainer(lr_loss, FedConfig(**kw), ["w"], ("features",)),
        params, {key: _t(val) for key, val in batch.items()}, _t(sub))
    np.testing.assert_array_equal(got["w"].ids.numpy(), np.asarray(want["w"].ids))
    np.testing.assert_allclose(got["w"].rows.numpy(), np.asarray(want["w"].rows),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                               rtol=1e-6, atol=1e-6)
