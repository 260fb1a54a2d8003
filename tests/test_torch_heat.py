"""Port parity for the heat estimators (paper §2, App. F, App. D.4): the
numpy functions of ``repro_torch.core.heat`` against ``repro.core.heat`` on
the same seeded inputs, bit for bit (``np.array_equal``): the exact counts,
the secure-aggregation mask streams (pinned and salted, masked vectors
included), randomized response one client chunk at a time against the
reference's one-shot draw, the clamp, and the trainer's ``_resolve_heat``
under every estimator, weighted or not, for LR, DIN (targets among a
client's ids) and the LSTM."""
import numpy as np
import pytest

from repro.configs import FedConfig as JFedConfig
from repro.core import heat as jheat
from repro.data import make_amazon_like as j_amazon
from repro.data import make_movielens_like as j_movielens
from repro.data import make_sent140_like as j_sent140
from repro.federated import FederatedTrainer as JTrainer

from repro_torch.configs.base import FedConfig
from repro_torch.core import heat
from repro_torch.data.synthetic import (make_amazon_like, make_movielens_like,
                                        make_sent140_like)
from repro_torch.federated.server import FederatedTrainer


def _indicators(seed, n=37, m=53, p=0.3):
    return (np.random.default_rng(seed).random((n, m)) < p).astype(np.int64)


def test_client_indicator_matches():
    rng = np.random.default_rng(0)
    for _ in range(5):
        ids = rng.integers(-3, 70, size=(4, 9))
        got, want = heat.client_indicator(ids, 64), jheat.client_indicator(ids, 64)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_compute_heat_exact_matches(weighted):
    rng = np.random.default_rng(1)
    clients = [rng.integers(-1, 80, size=rng.integers(1, 30)) for _ in range(25)]
    w = rng.random(25) * 7 if weighted else None
    np.testing.assert_array_equal(heat.compute_heat_exact(clients, 80, w),
                                  jheat.compute_heat_exact(clients, 80, w))


@pytest.mark.parametrize("stream", ["pinned", "salted"])
@pytest.mark.parametrize("modulus", [1 << 32, 1 << 63, 64])
def test_secure_agg_matches_with_masked_vectors(stream, modulus):
    ind = _indicators(2, n=9, m=31)
    rng_a = None if stream == "pinned" else np.random.default_rng(5)
    rng_b = None if stream == "pinned" else np.random.default_rng(5)
    est, vecs = heat.estimate_heat_secure_agg(ind, rng_a, modulus, return_masked=True)
    want_est, want_vecs = jheat.estimate_heat_secure_agg(ind, rng_b, modulus,
                                                         return_masked=True)
    np.testing.assert_array_equal(est, want_est)
    np.testing.assert_array_equal(vecs, want_vecs)
    assert vecs.dtype == want_vecs.dtype
    np.testing.assert_array_equal(est, ind.sum(axis=0))      # exact
    # without the masked vectors: the same estimate
    np.testing.assert_array_equal(heat.estimate_heat_secure_agg(ind, None, modulus),
                                  jheat.estimate_heat_secure_agg(ind, None, modulus))


@pytest.mark.parametrize("modulus", [0, 3 << 10, 1 << 64, 8])
def test_secure_agg_rejects_bad_moduli_as_the_reference(modulus):
    ind = _indicators(3, n=9, m=4)
    with pytest.raises(ValueError):
        jheat.estimate_heat_secure_agg(ind, modulus=modulus)
    with pytest.raises(ValueError):
        heat.estimate_heat_secure_agg(ind, modulus=modulus)


def test_chunked_uniform_draw_is_the_one_shot_stream():
    """What the chunked randomized response relies on: row chunks of
    ``rng.random`` concatenate to the one-shot ``(n, m)`` draw."""
    want = np.random.default_rng(11).random((50, 17))
    rng = np.random.default_rng(11)
    got = np.concatenate([rng.random((k, 17)) for k in (1, 7, 20, 22)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_rows", [1, 7, 64, 1000])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("as_bool", [False, True])
def test_randomized_response_matches_bit_for_bit(chunk_rows, weighted, as_bool,
                                                monkeypatch):
    monkeypatch.setattr(heat, "RR_CHUNK_ROWS", chunk_rows)
    ind = _indicators(4, n=300, m=700, p=0.2)
    w = np.random.default_rng(6).random(300) * 40 if weighted else None
    want = jheat.estimate_heat_randomized_response(
        ind, 0.1, np.random.default_rng(9), weights=w)
    got = heat.estimate_heat_randomized_response(
        ind.astype(bool) if as_bool else ind, 0.1, np.random.default_rng(9), weights=w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_randomized_response_default_stream_and_bounds():
    ind = _indicators(7)
    np.testing.assert_array_equal(heat.estimate_heat_randomized_response(ind, 0.25),
                                  jheat.estimate_heat_randomized_response(ind, 0.25))
    for p in (-0.1, 0.5):
        with pytest.raises(ValueError, match="flip_prob"):
            heat.estimate_heat_randomized_response(ind, p)


def test_clamp_heat_estimate_matches():
    est = np.random.default_rng(8).normal(3.0, 6.0, 200)
    for total, floor in ((10.0, 1.0), (4.5, 0.5)):
        np.testing.assert_array_equal(heat.clamp_heat_estimate(est, total, floor),
                                      jheat.clamp_heat_estimate(est, total, floor))


DATASETS = {
    "lr": (j_movielens, make_movielens_like, dict(num_clients=60, num_items=50,
                                                  mean_samples=12)),
    "din": (j_amazon, make_amazon_like, dict(num_clients=40, num_items=70,
                                             mean_samples=10)),
    "lstm": (j_sent140, make_sent140_like, dict(num_clients=40, vocab=90, seq_len=8,
                                                mean_samples=10)),
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def datasets(request):
    j_make, make, kw = DATASETS[request.param]
    return j_make(**kw), make(**kw)


@pytest.mark.parametrize("estimator", ["exact", "secure_agg", "randomized_response"])
@pytest.mark.parametrize("weighted", [False, True])
def test_resolve_heat_matches_the_jax_trainer(datasets, estimator, weighted):
    ref, port = datasets
    kw = dict(num_clients=port.num_clients, heat_estimator=estimator,
              weighted=weighted, rr_flip_prob=0.15, seed=3)
    # the reference's method reads nothing of its trainer
    want = JTrainer._resolve_heat(None, ref, JFedConfig(**kw))
    got = FederatedTrainer._resolve_heat(port, FedConfig(**kw))
    assert got.total == want.total
    assert got.counts.dtype == want.counts.dtype
    np.testing.assert_array_equal(got.counts, want.counts)
    if port.task == "din" and weighted and estimator != "randomized_response":
        # DIN's targets are among a client's ids (exact weighted counts)
        t = port.client_data["target"]
        assert (got.counts[np.unique(t[t >= 0])] > 0).all()
