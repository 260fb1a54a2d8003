"""Port parity, host side: data generation, cohort sampling, configuration,
heat factors, metrics and comm pricing — the JAX package against
``repro_torch`` on the same seeds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.core.heat import heat_correction_factors as j_heat_factors
from repro.data import make_movielens_like as j_movielens
from repro.data import synthetic as j_synthetic
from repro.data.batching import pooled_batches as j_pooled
from repro.data.batching import sample_cohort_batch as j_sample
from repro.federated.metrics import accuracy as j_accuracy
from repro.federated.metrics import auc as j_auc
from repro.sparse.comm import round_comm_stats as j_round_comm

from repro_torch.configs.base import FedConfig
from repro_torch.core.heat import heat_correction_factors
from repro_torch.data.batching import pooled_batches, sample_cohort_batch
from repro_torch.data import synthetic
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated.metrics import accuracy, auc
from repro_torch.sparse.comm import round_comm_stats

DS_KW = [dict(num_clients=40, num_items=40, mean_samples=15),
         dict(num_clients=25, num_items=17, mean_samples=9, seed=3, zipf_a=1.5)]


@pytest.fixture(scope="module", params=range(len(DS_KW)))
def datasets(request):
    kw = DS_KW[request.param]
    return j_movielens(**kw), make_movielens_like(**kw)


def test_make_movielens_like_bit_identical(datasets):
    ref, port = datasets
    assert port.num_features == ref.num_features
    assert port.num_clients == ref.num_clients
    for key in ref.client_data:
        np.testing.assert_array_equal(port.client_data[key], ref.client_data[key])
        assert port.client_data[key].dtype == ref.client_data[key].dtype
    for key in ref.test_data:
        np.testing.assert_array_equal(port.test_data[key], ref.test_data[key])
    np.testing.assert_array_equal(port.sample_counts, ref.sample_counts)
    np.testing.assert_array_equal(port.heat.counts, ref.heat.counts)
    assert port.heat.total == ref.heat.total
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_cohort_batch_bit_identical(datasets, seed):
    ref, port = datasets
    rng_r, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):   # the streams stay in step across rounds
        ids_r = rng_r.choice(ref.num_clients, size=6, replace=False)
        ids_p = rng_p.choice(port.num_clients, size=6, replace=False)
        np.testing.assert_array_equal(ids_p, ids_r)
        want = j_sample(ref, ids_r, 5, 5, rng_r)
        got = sample_cohort_batch(port, ids_p, 5, 5, rng_p)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype


# the DIN and LSTM generators at two seeds each, with and without the
# defaults' other sizes
DEEP_KW = [
    ("make_sent140_like", dict(num_clients=12, vocab=300, seq_len=10, mean_samples=8)),
    ("make_sent140_like", dict(num_clients=9, vocab=120, mean_samples=6, seed=5,
                               zipf_a=1.3)),
    ("make_amazon_like", dict(num_clients=12, num_items=400, mean_samples=9)),
    ("make_amazon_like", dict(num_clients=10, num_items=150, hist_len=6, seed=3,
                              emb_rank=4)),
    ("make_alibaba_like", dict(num_clients=12, num_items=300)),
    ("make_alibaba_like", dict(num_clients=8, num_items=90, seed=4)),
]


def _assert_datasets_identical(ref, port):
    for field in ("name", "task", "num_clients", "num_features", "feature_key"):
        assert getattr(port, field) == getattr(ref, field), field
    for got, want in ((port.client_data, ref.client_data),
                      (port.test_data, ref.test_data)):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(port.sample_counts, ref.sample_counts)
    np.testing.assert_array_equal(port.heat.counts, ref.heat.counts)
    assert port.heat.total == ref.heat.total
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("name,kw", DEEP_KW)
def test_din_and_lstm_generators_bit_identical(name, kw):
    ref = getattr(j_synthetic, name)(**kw)
    port = getattr(synthetic, name)(**kw)
    _assert_datasets_identical(ref, port)
    if ref.task == "din":
        # targets pad with 0, histories with -1; heat counts both
        assert (port.client_data["target"] >= 0).all()
        assert (port.client_data["hist"] == -1).any()


def test_datasets_registry():
    assert synthetic.DATASETS.keys() == j_synthetic.DATASETS.keys() - {"lm"}


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_cohort_batch_din_bit_identical(seed):
    kw = dict(num_clients=14, num_items=200, mean_samples=9)
    ref, port = j_synthetic.make_amazon_like(**kw), synthetic.make_amazon_like(**kw)
    rng_r, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        ids = rng_r.choice(ref.num_clients, size=5, replace=False)
        np.testing.assert_array_equal(
            rng_p.choice(port.num_clients, size=5, replace=False), ids)
        want = j_sample(ref, ids, 5, 5, rng_r)
        got = sample_cohort_batch(port, ids, 5, 5, rng_p)
        assert got.keys() == want.keys() == {"hist", "target", "label", "sample_mask"}
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype
        assert got["target"].shape == (5, 5, 5)


def test_pooled_batches_bit_identical(datasets):
    ref, port = datasets
    want = j_pooled(ref, 8, 32, np.random.default_rng(123))
    got = pooled_batches(port, 8, 32, np.random.default_rng(123))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("kw", [
    dict(algorithm="nope"), dict(heat_estimator="nope"),
    dict(sparse_local="nope"), dict(sparse_topk=-1),
    dict(microbatches=2, sparse=True),
])
def test_fedconfig_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        JFedConfig(**kw)
    with pytest.raises(ValueError):
        FedConfig(**kw)


def test_fedconfig_fields_match_reference():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(JFedConfig)}
    port = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    assert port == ref


def test_heat_correction_factors_exact(rng):
    counts = rng.integers(0, 50, 300).astype(np.float64)
    for total in (6040.0, 40.0, 7.5):
        want = np.asarray(j_heat_factors(jnp.asarray(counts, jnp.float32), total))
        got = heat_correction_factors(torch.tensor(counts, dtype=torch.float32), total)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
def test_auc_and_accuracy_match(rng, ties):
    labels = rng.integers(0, 2, 500)
    scores = rng.normal(size=500).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    assert auc(labels, scores) == j_auc(labels, scores)
    assert accuracy(labels, scores) == j_accuracy(labels, scores)
    assert np.isnan(auc(np.ones(5), scores[:5]))


@pytest.mark.parametrize("topk_rows", [None, 3])
def test_round_comm_stats_match(rng, topk_rows):
    valid = rng.integers(1, 30, 6)
    up = None if topk_rows is None else np.minimum(valid, topk_rows)
    down = np.full(6, 32)
    args = (4, 1480.0, 4.0, 4.0, valid, 369)
    kw = dict(uplink_rows_per_client=up, downlink_rows_per_client=down,
              local_iters=5)
    assert (round_comm_stats(*args, **kw).as_dict()
            == j_round_comm(*args, **kw).as_dict())


@pytest.mark.parametrize("alg", ["fedavg", "fedprox", "fedsubavg"])
def test_server_algorithm_apply_matches(rng, alg):
    from repro.core.aggregate import HeatSpec as JHeatSpec
    from repro.core.algorithms import make_server_algorithm as j_make_alg
    from repro_torch.core.aggregate import HeatSpec
    from repro_torch.core.algorithms import make_server_algorithm

    v = 50
    params = {"w": rng.normal(size=(v, 1)).astype(np.float32),
              "b": rng.normal(size=(1,)).astype(np.float32)}
    delta = {"w": rng.normal(size=(v, 1)).astype(np.float32),
             "b": rng.normal(size=(1,)).astype(np.float32)}
    counts = rng.integers(0, 9, v).astype(np.float32)
    cfg_kw = dict(algorithm=alg, server_lr=0.7)
    j_alg = j_make_alg(JFedConfig(**cfg_kw),
                       JHeatSpec({"w": ("vocab", 0), "b": None}),
                       {"vocab": jnp.asarray(counts)}, 40.0)
    alg_t = make_server_algorithm(FedConfig(**cfg_kw),
                                  HeatSpec({"w": ("vocab", 0), "b": None}),
                                  {"vocab": torch.tensor(counts)}, 40.0)
    want = j_alg.apply(j_alg.init({k: jnp.asarray(x) for k, x in params.items()}),
                       {k: jnp.asarray(x) for k, x in delta.items()})
    got = alg_t.apply(alg_t.init({k: torch.tensor(x) for k, x in params.items()}),
                      {k: torch.tensor(x) for k, x in delta.items()})
    assert got.rounds == int(want.rounds) == 1
    for k in params:
        np.testing.assert_array_equal(got.params[k].numpy(), np.asarray(want.params[k]))
