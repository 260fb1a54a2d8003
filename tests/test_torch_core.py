"""Port parity, small core modules: ``core/submodel.py`` (index sets, row
gather and scatter, involvement and counts), ``core/preconditioner.py``
(Theorems 1-2's condition numbers, Example 1's Hessian) and
``optim/optimizers.py`` (sgd, momentum, adam), against the JAX package on
the same numpy inputs, float32 within 1e-5 (ids and counts exact)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import preconditioner as jpre
from repro.core import submodel as jsub
from repro.optim import optimizers as jopt

from repro_torch.core import preconditioner as pre
from repro_torch.core import submodel as sub
from repro_torch.optim import Optimizer, adam, sgd

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("tokens,max_ids", [
    ([[7, 3, 3, 9], [9, 7, 7, 7]], 5),          # tests/test_algorithms.py's
    ([[7, 3, 3, 9], [9, 7, 7, 7]], 2),          # over capacity: largest dropped
    ([[5, -1, 2], [-1, 8, 8]], 6),              # pads take a slot, read as pads
])
def test_index_set_and_row_roundtrip_match_jax(tokens, max_ids):
    toks = np.asarray(tokens, np.int32)
    want = jsub.index_set_from_tokens(jnp.asarray(toks), max_ids)
    got = sub.index_set_from_tokens(_t(toks), max_ids)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    table = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
    rows_j = jsub.gather_rows(jnp.asarray(table), want)
    rows = sub.gather_rows(_t(table), got)
    np.testing.assert_allclose(rows.numpy(), np.asarray(rows_j), **TOL)
    upd = np.random.default_rng(1).normal(size=rows.shape).astype(np.float32)
    np.testing.assert_allclose(
        sub.scatter_row_updates(12, got, _t(upd)).numpy(),
        np.asarray(jsub.scatter_row_updates(12, want, jnp.asarray(upd))), **TOL)


def test_involvement_and_counts_match_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, 9, (5, 7)).astype(np.int32)
    ids[0, 0] = 11                       # past the table: dropped by both
    np.testing.assert_array_equal(
        sub.involvement_matrix(_t(ids), 9).numpy(),
        np.asarray(jsub.involvement_matrix(jnp.asarray(ids), 9)))
    np.testing.assert_array_equal(
        sub.count_token_rows(_t(ids), 9).numpy(),
        np.asarray(jsub.count_token_rows(jnp.asarray(ids), 9)))
    # tests/test_algorithms.py::test_involvement_and_counts's values
    np.testing.assert_array_equal(
        sub.involvement_matrix(torch.tensor([[1, 2, -1], [2, 2, 4]]), 6).sum(0).numpy(),
        [0, 1, 2, 0, 1, 0])


def _synthetic_quadratic_hessian(rng, n_clients=64, m=10, p_cold=0.1):
    """tests/test_theory.py's: H = (2/N) diag(n_m)."""
    involved = rng.random((n_clients, m)) < np.linspace(p_cold, 1.0, m)
    involved[:, -1] = True
    involved[0] = True
    counts = involved.sum(axis=0).astype(np.float64)
    return np.diag(2.0 * counts / n_clients), counts, n_clients


@pytest.mark.parametrize("case", ["theorem1", "theorem2", "nondiagonal", "example1"])
def test_preconditioner_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "example1":               # examples/example1_illconditioning.py
        n = 100
        h, counts = np.diag([2.0 / n, 2.0]), np.array([1.0, float(n)])
    else:
        h, counts, n = _synthetic_quadratic_hessian(rng)
        if case == "nondiagonal":
            a = rng.normal(size=h.shape) * 0.05
            h = h + a @ a.T * np.sqrt(np.outer(counts, counts)) / n
    h32 = h.astype(np.float32)
    hh_j = jpre.preconditioned_hessian(jnp.asarray(h32), counts, float(n))
    hh = pre.preconditioned_hessian(_t(h32), counts, float(n))
    np.testing.assert_allclose(hh.numpy(), np.asarray(hh_j), **TOL)
    for got, want in ((pre.condition_number(_t(h32)), jpre.condition_number(jnp.asarray(h32))),
                      (pre.condition_number(hh), jpre.condition_number(hh_j))):
        assert got == pytest.approx(want, rel=1e-5)
    assert (pre.measured_dispersion_bound(_t(h32), counts, rho2=2.0)
            == jpre.measured_dispersion_bound(jnp.asarray(h32), counts, rho2=2.0))
    if case == "theorem2":
        assert pre.condition_number(hh) == pytest.approx(1.0, rel=1e-5)
    if case == "example1":
        assert pre.condition_number(_t(h32)) == pytest.approx(n, rel=1e-5)


def test_hessian_of_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    x = rng.normal(size=4).astype(np.float32)
    want = jpre.hessian_of(lambda v: jnp.sum(jnp.tanh(jnp.asarray(a) @ v) ** 2),
                           jnp.asarray(x))
    got = pre.hessian_of(lambda v: torch.sum(torch.tanh(_t(a) @ v) ** 2), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("make", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax(make):
    rng = np.random.default_rng(4)
    names = ("w", "b")
    params = {k: rng.normal(size=(3, 2) if k == "w" else (2,)).astype(np.float32)
              for k in names}
    grads = [{k: rng.normal(size=params[k].shape).astype(np.float32) for k in names}
             for _ in range(4)]
    opt_j, opt = {"sgd": (jopt.sgd(0.1), sgd(0.1)),
                  "momentum": (jopt.sgd(0.1, momentum=0.9), sgd(0.1, momentum=0.9)),
                  "adam": (jopt.adam(0.05), adam(0.05))}[make]
    assert isinstance(opt, Optimizer)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: _t(v) for k, v in params.items()}
    sj, st = opt_j.init(pj), opt.init(pt)
    for g in grads:
        uj, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        ut, st = opt.update({k: _t(v) for k, v in g.items()}, st, pt)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt = {k: pt[k] + ut[k] for k in pt}
    for k in names:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), **TOL)
