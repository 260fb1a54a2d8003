"""Port parity for the server side: ``make_server_algorithm(...).apply`` of
every algorithm over 5 rounds on the same numpy parameters and deltas
(parameters and optimizer slots within 1e-5), the cohort reductions and the
FedSubAvg tree correction (1e-6), the densify at the server boundary, dense
local training under ``vmap`` (1e-5), and ``server_state_from_jax``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FedConfig as JFedConfig
from repro.core import aggregate as jagg
from repro.core.algorithms import make_server_algorithm as j_make_server_algorithm
from repro.federated.client import cohort_deltas as j_cohort_deltas
from repro.federated.client import make_local_trainer as j_make_local_trainer
from repro.models import recsys as j_recsys
from repro.sharding.logical import unbox
from repro.sparse.encode import decode_delta_tree as j_decode_delta_tree
from repro.sparse.rowsparse import RowSparse as JRowSparse

from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax, server_state_from_jax
from repro_torch.core import aggregate
from repro_torch.core.algorithms import make_server_algorithm
from repro_torch.federated.client import cohort_deltas, make_local_trainer
from repro_torch.models import recsys
from repro_torch.sparse.encode import decode_delta_tree
from repro_torch.sparse.rowsparse import RowSparse

V, D, K = 50, 3, 7
SPACES = {"table": ("vocab", 0), "head": ("vocab", 1), "bias": None}


def _tree(rng, scale=1.0, lead=()):
    return {"table": (rng.normal(size=lead + (V, D)) * scale).astype(np.float32),
            "head": (rng.normal(size=lead + (D, V)) * scale).astype(np.float32),
            "bias": (rng.normal(size=lead + (D,)) * scale).astype(np.float32)}


def _heat(rng):
    counts = rng.integers(0, 12, size=V).astype(np.float32)
    return counts, 11.0


def _close(got, want, tol, what=""):
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("alg", ["fedavg", "fedprox", "fedsubavg", "scaffold", "fedadam"])
def test_server_algorithm_matches_over_five_rounds(alg):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    deltas = [_tree(rng, scale=0.05) for _ in range(5)]
    counts, total = _heat(rng)
    kw = dict(algorithm=alg, num_clients=40, clients_per_round=K,
              server_lr=0.03 if alg == "fedadam" else 0.7)
    j_alg = j_make_server_algorithm(
        JFedConfig(**kw), heat_spec=jagg.HeatSpec(SPACES),
        heat_counts={"vocab": jnp.asarray(counts)}, total=total)
    t_alg = make_server_algorithm(
        FedConfig(**kw), heat_spec=aggregate.HeatSpec(SPACES),
        heat_counts={"vocab": torch.from_numpy(counts)}, total=total)
    j_state = j_alg.init({k: jnp.asarray(v) for k, v in params.items()})
    t_state = t_alg.init({k: torch.from_numpy(v) for k, v in params.items()})
    for r, d in enumerate(deltas):
        j_state = j_alg.apply(j_state, {k: jnp.asarray(v) for k, v in d.items()})
        t_state = t_alg.apply(t_state, {k: torch.from_numpy(v) for k, v in d.items()})
        _close(t_state.params, j_state.params, 1e-5, f"round {r}")
        assert t_state.rounds == int(j_state.rounds) == r + 1
        j_slots = (j_state.opt,) if isinstance(j_state.opt, dict) else j_state.opt
        t_slots = (t_state.opt,) if isinstance(t_state.opt, dict) else t_state.opt
        assert len(t_slots) == len(j_slots) == {"scaffold": 1, "fedadam": 2}.get(alg, 0)
        for t_slot, j_slot in zip(t_slots, j_slots):
            _close(t_slot, j_slot, 1e-5, f"round {r} slot")


def test_server_algorithm_leaves_its_input_state_alone():
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    before = {k: v.clone() for k, v in params.items()}
    for alg in ("scaffold", "fedadam"):
        a = make_server_algorithm(FedConfig(algorithm=alg))
        state = a.init(params)
        a.apply(state, {k: torch.from_numpy(v) for k, v in _tree(rng).items()})
        for k in params:
            assert torch.equal(params[k], before[k])


def test_correct_update_tree_matches():
    rng = np.random.default_rng(2)
    update, (counts, total) = _tree(rng), _heat(rng)
    want = jagg.correct_update_tree({k: jnp.asarray(v) for k, v in update.items()},
                                    jagg.HeatSpec(SPACES), {"vocab": jnp.asarray(counts)},
                                    total)
    got = aggregate.correct_update_tree({k: torch.from_numpy(v) for k, v in update.items()},
                                        aggregate.HeatSpec(SPACES),
                                        {"vocab": torch.from_numpy(counts)}, total)
    _close(got, want, 1e-6)


def test_cohort_reductions_match():
    rng = np.random.default_rng(3)
    stack = _tree(rng, lead=(K,))
    j_stack = {k: jnp.asarray(v) for k, v in stack.items()}
    t_stack = {k: torch.from_numpy(v) for k, v in stack.items()}
    _close(aggregate.cohort_sum(t_stack), jagg.cohort_sum(j_stack), 1e-6, "sum")
    _close(aggregate.cohort_mean(t_stack), jagg.cohort_mean(j_stack), 1e-6, "mean")
    tables = {"table": stack["table"], "wide": rng.normal(size=(K, V)).astype(np.float32)}
    inv = (rng.random((K, V)) < 0.4).astype(np.float32)
    inv[:, 0] = 0.0                               # a row no client involves
    want = jagg.masked_cohort_mean({k: jnp.asarray(v) for k, v in tables.items()},
                                   jnp.asarray(inv))
    got = aggregate.masked_cohort_mean({k: torch.from_numpy(v) for k, v in tables.items()},
                                       torch.from_numpy(inv))
    _close(got, want, 1e-6, "masked")


def test_decode_delta_tree_matches():
    rng = np.random.default_rng(4)
    ids = np.array([0, 3, 9, 41, -1, -1], np.int32)
    rows = rng.normal(size=(6, D)).astype(np.float32)
    rows[ids < 0] = 0.0
    bias = rng.normal(size=(D,)).astype(np.float32)
    want = j_decode_delta_tree({"table": JRowSparse(jnp.asarray(ids), jnp.asarray(rows), V),
                                "bias": jnp.asarray(bias)})
    got = decode_delta_tree({"table": RowSparse(torch.from_numpy(ids),
                                                torch.from_numpy(rows), V),
                             "bias": torch.from_numpy(bias)})
    _close(got, want, 0.0)


@pytest.mark.parametrize("alg", ["fedavg", "fedprox"])
def test_dense_cohort_deltas_match(alg):
    """K dense LR replicas under ``vmap``, FedProx's prox term included."""
    rng = np.random.default_rng(5)
    v, i, b, f = 40, 3, 4, 5
    params = {"w": (rng.normal(size=(v, 1)) * 0.1).astype(np.float32),
              "b": np.array([0.05], np.float32)}
    batch = {"features": rng.integers(-1, v, size=(K, i, b, f)).astype(np.int32),
             "label": rng.integers(0, 2, size=(K, i, b)).astype(np.float32),
             "sample_mask": np.ones((K, i, b), np.float32)}
    kw = dict(algorithm=alg, lr=0.5, prox_mu=0.3)
    want = j_cohort_deltas(j_make_local_trainer(j_recsys.lr_loss, JFedConfig(**kw)),
                           {k: jnp.asarray(x) for k, x in params.items()},
                           {k: jnp.asarray(x) for k, x in batch.items()})
    got = cohort_deltas(make_local_trainer(recsys.lr_loss, FedConfig(**kw)),
                        {k: torch.from_numpy(x) for k, x in params.items()},
                        {k: torch.from_numpy(x) for k, x in batch.items()})
    _close(got, want, 1e-5)


@pytest.mark.parametrize("alg", ["fedavg", "scaffold", "fedadam"])
@pytest.mark.parametrize("model", ["lr", "lstm"])
def test_server_state_from_jax_round_trips(alg, model):
    """A JAX ``ServerState`` two rounds in, carried into the port: the same
    parameters, slots (the LSTM's tuple of cells flattened alike) and round
    count."""
    make = {"lr": functools.partial(j_recsys.make_lr_params, 30),
            "lstm": functools.partial(j_recsys.make_lstm_params, 30, emb_dim=4,
                                      hidden=5)}[model]
    params = unbox(make(rng=jax.random.PRNGKey(1)))
    j_alg = j_make_server_algorithm(JFedConfig(algorithm=alg, num_clients=20,
                                               clients_per_round=4))
    state = j_alg.init(params)
    for s in range(2):
        delta = jax.tree.map(lambda x: jnp.full_like(x, 0.01 * (s + 1)), params)
        state = j_alg.apply(state, delta)
    to_np = functools.partial(jax.tree.map, np.asarray)
    got = server_state_from_jax(to_np(state.params), to_np(state.opt),
                                state.rounds, device="cpu")
    want_params, _ = params_from_jax(to_np(state.params), device="cpu")
    assert got.rounds == 2
    assert set(got.params) == set(want_params)
    for k in want_params:
        assert torch.equal(got.params[k], want_params[k])
    j_slots = state.opt
    j_slots = (j_slots,) if alg == "scaffold" else j_slots
    t_slots = (got.opt,) if alg == "scaffold" else got.opt
    assert len(t_slots) == len(j_slots) == {"scaffold": 1, "fedadam": 2}.get(alg, 0)
    for t_slot, j_slot in zip(t_slots, j_slots):
        want_slot, _ = params_from_jax(to_np(j_slot), device="cpu")
        assert set(t_slot) == set(want_slot)
        for k in want_slot:
            assert torch.equal(t_slot[k], want_slot[k])
    if alg == "scaffold":
        with pytest.raises(ValueError, match="do not match"):
            server_state_from_jax(to_np(state.params),
                                  {"w": np.zeros((30, 1), np.float32)}, 2, device="cpu")
