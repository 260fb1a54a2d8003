"""Port parity for the paper's Table 2 and Table 3 protocol: the trainer
of ``repro_torch`` against the JAX package's trainer on the same seeds for
every server algorithm on the sparse plan (K1 once per round) and the dense
plan (K dense replicas, as ``benchmarks/common.py::rounds_to_target`` runs
it), central SGD, and FedSubAvg under randomized-response and weighted
heat. Per-round losses, parameters and optimizer slots within 1e-5 (rtol
and atol), through ``run_round`` and ``run_rounds``, at
``test_torch_trainer.py``'s shape and at ``bench_table2.py``'s."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import FedConfig as JFedConfig
from repro.data import make_movielens_like as j_movielens
from repro.federated import FederatedTrainer as JTrainer
from repro.federated.plan import DenseTransport as JDenseTransport
from repro.federated.plan import RoundPlan as JRoundPlan
from repro.federated.plan import ServerUpdate as JServerUpdate
from repro.federated.plan import SubmodelReplicatedLocal as JSubmodelReplicatedLocal
from repro.models.recsys import lr_logits as j_lr_logits
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated.plan import (DenseTransport, ReplicatedLocal,
                                        RoundPlan, ServerUpdate,
                                        SubmodelReplicatedLocal)
from repro_torch.federated.server import FederatedTrainer
from repro_torch.models.recsys import lr_logits, lr_loss, make_lr_params

ROUNDS = 8


# the paper's Table 2 protocol on both plans: (algorithm, FedConfig flags)
PROTOCOL = {
    "scaffold-sparse": ("scaffold", dict(sparse=True)),
    "scaffold-dense": ("scaffold", dict(sparse=False)),
    "fedadam-sparse": ("fedadam", dict(sparse=True, server_lr=0.03)),
    "fedadam-dense": ("fedadam", dict(sparse=False, server_lr=0.03)),
    "fedsubavg-dense": ("fedsubavg", dict(sparse=False)),
    "fedavg-dense": ("fedavg", dict(sparse=False)),
    "fedprox-dense": ("fedprox", dict(sparse=False)),
    "central": ("central", dict(sparse=False)),
    "fedsubavg-rr": ("fedsubavg", dict(sparse=True, heat_estimator="randomized_response")),
    "fedsubavg-rr-weighted": ("fedsubavg", dict(sparse=True, weighted=True,
                                                heat_estimator="randomized_response")),
    "fedsubavg-weighted-dense": ("fedsubavg", dict(sparse=False, weighted=True)),
}
#: the file's shape (K = 6) and bench_table2.py's (150 clients, 120 movies, K = 10)
SHAPES = {"test": (dict(num_clients=40, num_items=40, mean_samples=15), 6), "table2": (dict(num_clients=150, num_items=120,
                                               mean_samples=30), 10)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def shaped(request):
    kw, k = SHAPES[request.param]
    ref = j_movielens(**kw)
    init = jax.tree.map(np.asarray,
                        unbox(j_make_lr_params(ref.num_features,
                                               rng=jax.random.PRNGKey(0))))
    return ref, make_movielens_like(**kw), init, k


def _protocol_trainers(shaped, case, j_plan=None, plan=None):
    ref, port, init, k = shaped
    alg, flags = PROTOCOL[case]
    kw = dict(num_clients=port.num_clients, clients_per_round=k, local_iters=5,
              local_batch=5, lr=0.5, algorithm=alg, **flags)
    jt = JTrainer(ref, functools.partial(j_make_lr_params, ref.num_features),
                  j_lr_loss, JFedConfig(**kw), plan=j_plan,
                  predict_fn=lambda p, t: j_lr_logits(p, jnp.asarray(t["features"])),
                  telemetry=False)
    tt = FederatedTrainer(port, functools.partial(params_from_jax, init), lr_loss,
                          FedConfig(**kw), plan=plan,
                          predict_fn=lambda p, t: lr_logits(p, t["features"]),
                          device="cpu")
    return jt, tt


def _assert_state_close(jt, tt):
    """Parameters, optimizer slots and round count against the reference."""
    want = jax.tree.map(np.asarray, unbox(jt.state.params))
    assert set(want) == set(tt.state.params)
    for name, w in want.items():
        np.testing.assert_allclose(tt.state.params[name].numpy(), w,
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert tt.state.rounds == int(jt.state.rounds)
    want = jax.tree.map(np.asarray, unbox(jt.state.opt))
    got = tt.state.opt
    if isinstance(got, dict):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], rtol=1e-5,
                                       atol=1e-5, err_msg=f"opt {name}")


@pytest.mark.parametrize("case", sorted(PROTOCOL))
@pytest.mark.parametrize("entry", ["run_round", "run_rounds"])
def test_protocol_trainer_matches_jax(shaped, case, entry):
    jt, tt = _protocol_trainers(shaped, case)
    np.testing.assert_array_equal(tt.heat.counts, jt.heat.counts)
    assert tt.heat.total == jt.heat.total
    if entry == "run_round":
        want = [jt.run_round() for _ in range(ROUNDS)]
        got = [tt.run_round() for _ in range(ROUNDS)]
    else:
        want, got = jt.run_rounds(ROUNDS), tt.run_rounds(ROUNDS)
        assert tt._last_capacity == jt._last_capacity
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _assert_state_close(jt, tt)
    assert tt.comm_summary() == jt.comm_summary()
    assert abs(tt.train_loss() - jt.train_loss()) <= 1e-5


def test_submodel_replicas_on_the_dense_transport_match_jax(shaped):
    """``SubmodelReplicatedLocal x DenseTransport``, an explicit plan: the
    born-sparse deltas scatter back to dense stacks before the mean."""
    jt, tt = _protocol_trainers(
        shaped, "scaffold-dense",
        j_plan=JRoundPlan(JSubmodelReplicatedLocal(), JDenseTransport(),
                          JServerUpdate("scaffold")),
        plan=RoundPlan(SubmodelReplicatedLocal(), DenseTransport(),
                       ServerUpdate("scaffold")))
    want = [jt.run_round() for _ in range(ROUNDS)]
    got = [tt.run_round() for _ in range(ROUNDS)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _assert_state_close(jt, tt)


def test_central_takes_no_plan(shaped):
    port = shaped[1]
    cfg = FedConfig(num_clients=port.num_clients, algorithm="central")
    with pytest.raises(ValueError, match="no RoundPlan"):
        FederatedTrainer(port, functools.partial(make_lr_params, port.num_features),
                         lr_loss, cfg, device="cpu",
                         plan=RoundPlan(ReplicatedLocal(), DenseTransport(),
                                        ServerUpdate("fedavg")))


@pytest.fixture(scope="module")
def table_data():
    from tools.paper_tables import TABLE_DATA
    return j_movielens(**TABLE_DATA), make_movielens_like(**TABLE_DATA)


@pytest.mark.parametrize("alg, kw", [
    ("central", {}), ("fedavg", {}), ("fedsubavg", {}), ("fedsubavg", {"sparse": True}),
    ("fedadam", {"server_lr": 0.03}), ("scaffold", {"sparse": True}),
    ("fedsubavg", {"clients_per_round": 5}),
])
def test_paper_tables_protocol_matches_the_jax_benchmark(table_data, alg, kw):
    """``tools/paper_tables.py::rounds_to_target`` against
    ``benchmarks/common.py::rounds_to_target``: the same rounds to a target
    and the same best loss."""
    from benchmarks.common import rounds_to_target as j_rounds_to_target
    from tools.paper_tables import rounds_to_target

    ref, port = table_data
    want = j_rounds_to_target(ref, alg, 0.56, 15, fed_kw=kw)
    got = rounds_to_target(port, alg, 0.56, 15, fed_kw=kw, device="cpu")
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-5
    assert got[3] > 0
