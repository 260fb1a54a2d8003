"""Port parity, end to end: the LR FedSubAvg/FedAvg trainer of ``repro_torch``
against the JAX package's trainer on the same seeds (per-round loss and final
parameters within 1e-5, AUC within 1e-4: tied LR scores can swap ranks under
last-ulp differences), plus the port's device rule and import hygiene."""
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.data import make_movielens_like as j_movielens
from repro.federated import FederatedTrainer as JTrainer
from repro.models.recsys import lr_logits as j_lr_logits
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated.plan import (CohortSharding, RoundPlan,
                                        RowSparseTransport, ServerUpdate,
                                        SubmodelReplicatedLocal)
from repro_torch.federated.server import FederatedTrainer
from repro_torch.models.recsys import lr_logits, lr_loss, make_lr_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
DS_KW = dict(num_clients=40, num_items=40, mean_samples=15)
ROUNDS = 8


@pytest.fixture(scope="module")
def data():
    ref = j_movielens(**DS_KW)
    port = make_movielens_like(**DS_KW)
    init = jax.tree.map(np.asarray,
                        unbox(j_make_lr_params(ref.num_features,
                                               rng=jax.random.PRNGKey(0))))
    return ref, port, init


def _cfg_kw(alg, topk):
    return dict(num_clients=40, clients_per_round=6, local_iters=5,
                local_batch=5, lr=0.5, algorithm=alg, sparse=True,
                sparse_topk=topk)


def _trainers(data, alg, topk):
    ref, port, init = data
    jt = JTrainer(ref, functools.partial(j_make_lr_params, ref.num_features),
                  j_lr_loss, JFedConfig(**_cfg_kw(alg, topk)),
                  predict_fn=lambda p, t: j_lr_logits(p, jnp.asarray(t["features"])),
                  telemetry=False)
    # the port starts from the reference's own initial parameters
    tt = FederatedTrainer(port, functools.partial(params_from_jax, init), lr_loss,
                          FedConfig(**_cfg_kw(alg, topk)),
                          predict_fn=lambda p, t: lr_logits(p, t["features"]),
                          device="cpu")
    return jt, tt


def _assert_params_close(jt, tt):
    want = jax.tree.map(np.asarray, unbox(jt.state.params))
    assert set(want) == set(tt.state.params)
    for name, w in want.items():
        np.testing.assert_allclose(tt.state.params[name].numpy(), w,
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# topk=48 is above every client's submodel in this dataset (at most 35 rows):
# the top-k path runs (union capacity K*k, ids re-sorted) and keeps every row
@pytest.mark.parametrize("alg", ["fedavg", "fedsubavg"])
@pytest.mark.parametrize("topk", [0, 48])
@pytest.mark.parametrize("entry", ["run_round", "run_rounds", "run"])
def test_trainer_matches_jax(data, alg, topk, entry):
    jt, tt = _trainers(data, alg, topk)
    if entry == "run_round":
        want = [jt.run_round() for _ in range(ROUNDS)]
        got = [tt.run_round() for _ in range(ROUNDS)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif entry == "run_rounds":
        want, got = jt.run_rounds(ROUNDS), tt.run_rounds(ROUNDS)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert tt._last_capacity == jt._last_capacity
    else:
        want = jt.run(ROUNDS, eval_every=4, engine=True)
        got = tt.run(ROUNDS, eval_every=4, engine=True)
        assert [r.round for r in got] == [r.round for r in want]
        for g, w in zip(got, want):
            assert abs(g.train_loss - w.train_loss) <= 1e-5
            assert abs(g.test_metric - w.test_metric) <= 1e-4
            assert (g.bytes_up, g.bytes_down, g.density) == (
                w.bytes_up, w.bytes_down, w.density)
            assert g.wall_time > 0
    _assert_params_close(jt, tt)
    assert abs(tt.evaluate() - jt.evaluate()) <= 1e-4
    assert abs(tt.train_loss() - jt.train_loss()) <= 1e-5
    assert tt.comm_summary() == jt.comm_summary()


@pytest.mark.parametrize("alg", ["fedavg", "fedsubavg"])
def test_trainer_binding_topk_first_round_matches(data, alg):
    """A binding top-k from the zero initialisation: a client's tied rows
    are bit-equal in both packages there, so both keep the lower slots.

    Later rounds are not compared: the rows of a movie's three co-occurring
    features have equal deltas in exact arithmetic but differ in the last ulp
    in both packages, each in its own way, and top-k then keeps different
    members of the tie (ROADMAP Queue 3).
    """
    jt, tt = _trainers(data, alg, 4)
    assert abs(tt.run_round() - jt.run_round()) <= 1e-5
    _assert_params_close(jt, tt)
    # the next round's loss reads the parameters the first round produced
    assert abs(tt.run_round() - jt.run_round()) <= 1e-5
    assert tt.comm_summary() == jt.comm_summary()


def test_explicit_plan_matches_config_flags(data):
    _, port, _ = data
    mk = functools.partial(make_lr_params, port.num_features)
    cfg = FedConfig(**_cfg_kw("fedsubavg", 0))
    by_flags = FederatedTrainer(port, mk, lr_loss, cfg, device="cpu")
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                     ServerUpdate("fedsubavg"))
    by_plan = FederatedTrainer(port, mk, lr_loss, cfg, plan=plan, device="cpu")
    assert by_plan.plan == by_flags.plan
    assert by_plan.run_rounds(3) == by_flags.run_rounds(3)
    with pytest.raises(ValueError, match="disagrees"):
        FederatedTrainer(port, mk, lr_loss, cfg, device="cpu",
                         plan=RoundPlan(SubmodelReplicatedLocal(),
                                        RowSparseTransport(), ServerUpdate("fedavg")))


@pytest.mark.parametrize("kw", [
    dict(sparse=False), dict(sparse_int8=True), dict(algorithm="fedadam"),
    dict(algorithm="central"), dict(heat_estimator="randomized_response"),
    dict(plan=dict(sharding=CohortSharding(mesh=None))),
    dict(plan=dict(debug_checks=True)),
])
def test_unported_paths_raise(data, kw):
    _, port, _ = data
    plan = kw.pop("plan", None)
    if plan is not None:
        plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                         ServerUpdate("fedsubavg"), **plan)
    cfg = FedConfig(**{**_cfg_kw("fedsubavg", 0), **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederatedTrainer(port, functools.partial(make_lr_params, port.num_features),
                         lr_loss, cfg, plan=plan, device="cpu")


def test_default_device_is_cuda_and_raises_without_it(data, monkeypatch):
    _, port, init = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FedConfig(**_cfg_kw("fedsubavg", 0))
    for make in (functools.partial(make_lr_params, port.num_features),
                 functools.partial(params_from_jax, init)):
        with pytest.raises(RuntimeError, match="CUDA"):
            FederatedTrainer(port, make, lr_loss, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device=None)


_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"), *(ROOT / "tools").glob("*.py"),
              ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert not _FORBIDDEN.search((ROOT / path).read_text()), path
