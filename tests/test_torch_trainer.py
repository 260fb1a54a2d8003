"""Port parity, end to end: the trainer of ``repro_torch`` against the JAX
package's trainer on the same seeds, for LR on the sparse plan (per-round
loss and final parameters within 1e-5, AUC within 1e-4: tied LR scores can
swap ranks under last-ulp differences) and for DIN and LSTM from the
reference's random initialisation, stateful server optimizers included
(per-round loss, final parameters and optimizer slots within 1e-5, comm
bytes equal per round, DIN's targets among the sub-ids), plus the port's
device rule and import hygiene. The paper's Table 2 protocol (every
algorithm on both plans, central SGD, the private heat estimators) is held
in ``test_torch_protocol.py``."""
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.data import make_amazon_like as j_amazon
from repro.data import make_movielens_like as j_movielens
from repro.data import make_sent140_like as j_sent140
from repro.federated import FederatedTrainer as JTrainer
from repro.federated.server import derive_sub_ids as j_derive_sub_ids
from repro.models import recsys as j_recsys
from repro.models.recsys import lr_logits as j_lr_logits
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax, server_state_from_jax
from repro_torch.data.synthetic import (make_amazon_like, make_movielens_like,
                                        make_sent140_like)
from repro_torch.federated.plan import (CohortSharding, DenseTransport, RoundPlan,
                                        RowSparseTransport, ServerUpdate,
                                        SubmodelReplicatedLocal)
from repro_torch.federated.server import FederatedTrainer, derive_sub_ids
from repro_torch.launch.mesh import CohortMesh
from repro_torch.models import recsys
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


# DIN at tests/test_sparse.py's size; a small Sent140 with a narrow LSTM
DEEP = {
    "din": (j_amazon, make_amazon_like, dict(num_clients=30, num_items=60, mean_samples=12),
            lambda v: functools.partial(j_recsys.make_din_params, v), j_recsys.din_loss,
            recsys.din_loss),
    "lstm": (j_sent140, make_sent140_like,
             dict(num_clients=30, vocab=80, seq_len=8, mean_samples=10),
             lambda v: functools.partial(j_recsys.make_lstm_params, v, emb_dim=8, hidden=12),
             j_recsys.lstm_loss, recsys.lstm_loss),
}
DEEP_ROUNDS = 6


@pytest.fixture(scope="module", params=sorted(DEEP))
def deep(request):
    j_make_ds, make_ds, kw, j_make, _, _ = DEEP[request.param]
    ref, port = j_make_ds(**kw), make_ds(**kw)
    j_make = j_make(ref.num_features)
    # the JAX trainer draws its initialisation from PRNGKey(cfg.seed = 0)
    init = jax.tree.map(np.asarray, unbox(j_make(rng=jax.random.PRNGKey(0))))
    return request.param, ref, port, j_make, init


def _deep_trainers(deep, alg):
    model, ref, port, j_make, init = deep
    _, _, _, _, j_loss, loss = DEEP[model]
    kw = dict(num_clients=port.num_clients, clients_per_round=6, local_iters=5,
              local_batch=5, lr=0.5, algorithm=alg, sparse=True,
              server_lr=0.03 if alg == "fedadam" else 1.0)
    jt = JTrainer(ref, j_make, j_loss, JFedConfig(**kw), telemetry=False)
    tt = FederatedTrainer(port, functools.partial(params_from_jax, init), loss,
                          FedConfig(**kw), device="cpu")
    return jt, tt


@pytest.mark.parametrize("alg", ["fedavg", "fedsubavg", "fedadam"])
@pytest.mark.parametrize("entry", ["run_round", "run_rounds"])
def test_din_and_lstm_trainers_match_jax(deep, alg, entry):
    jt, tt = _deep_trainers(deep, alg)
    if entry == "run_round":
        want = [jt.run_round() for _ in range(DEEP_ROUNDS)]
        got = [tt.run_round() for _ in range(DEEP_ROUNDS)]
    else:
        want, got = jt.run_rounds(DEEP_ROUNDS), tt.run_rounds(DEEP_ROUNDS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tt._last_capacity == jt._last_capacity
    want = server_state_from_jax(jax.tree.map(np.asarray, unbox(jt.state.params)),
                                 jax.tree.map(np.asarray, unbox(jt.state.opt)),
                                 jt.state.rounds, device="cpu")
    assert tt.state.rounds == want.rounds
    slots = (want.opt,) if isinstance(want.opt, dict) else want.opt
    got_slots = (tt.state.opt,) if isinstance(tt.state.opt, dict) else tt.state.opt
    for w_tree, g_tree in zip((want.params,) + slots, (tt.state.params,) + got_slots):
        assert set(w_tree) == set(g_tree)
        for name, w in w_tree.items():
            torch.testing.assert_close(g_tree[name], w, rtol=1e-5, atol=1e-5,
                                       msg=name)
    assert len(tt.comm_log) == len(jt.comm_log) == DEEP_ROUNDS
    for g, w in zip(tt.comm_log, jt.comm_log):
        assert g.as_dict() == w.as_dict()


def test_cohort_feature_ids_match_jax(deep):
    """The cohort's ``(K, M)`` feature ids and sub-ids are the reference's:
    for DIN its histories and its targets, every target among the sub-ids."""
    jt, tt = _deep_trainers(deep, "fedsubavg")
    for _ in range(3):
        (_, j_feats), (cohort, feats) = (jt._sample_sparse_cohort(),
                                         tt._sample_sparse_cohort())
        np.testing.assert_array_equal(feats, j_feats)
        cap = 128
        want = np.asarray(j_derive_sub_ids(jnp.asarray(j_feats), jt.ds.num_features, cap))
        got = derive_sub_ids(torch.from_numpy(feats), tt.ds.num_features, cap).numpy()
        np.testing.assert_array_equal(got, want)
        if deep[0] == "din":
            assert feats.shape[1] == cohort["hist"][0].size + cohort["target"][0].size
            for c in range(feats.shape[0]):
                assert np.isin(cohort["target"][c], got[c]).all()


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


_MESH = CohortMesh(rank=0, size=1, device=torch.device("cpu"))


@pytest.mark.parametrize("kw,item", [
    (dict(plan=dict(sharding=CohortSharding(_MESH))), 8),
    (dict(plan=dict(sharding=CohortSharding(_MESH), transport=DenseTransport())), 8),
])
def test_unported_paths_raise(data, kw, item):
    """The paths ROADMAP Queue 1 item 8 ported (cohort sharding) now build:
    the trainer keeps the plan's sharding and builds its step (the
    sharded rounds themselves run in tests/test_torch_sharding.py)."""
    _, port, _ = data
    kw = dict(kw)
    plan = RoundPlan(**{"local": SubmodelReplicatedLocal(),
                        "transport": RowSparseTransport(),
                        "server": ServerUpdate("fedsubavg"), **kw.pop("plan")})
    cfg = FedConfig(**_cfg_kw("fedsubavg", 0))
    assert item == 8
    tr = FederatedTrainer(port, functools.partial(make_lr_params, port.num_features),
                          lr_loss, cfg, plan=plan, device="cpu", **kw)
    assert tr.plan.sharding.mesh is _MESH and tr.plan.sharding.num_shards == 1
    assert tr.plan.describe().endswith("[sharded x1 over 'data']")
    assert tr.writes_files


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
