"""Port parity, the rest of the single-device round plan: ``make_round_step``
in every mode x ``correct`` on LR and the LSTM (and microbatched fedsgd,
explicit compositions, int8 on the batch fingerprint), ``resolve_plan``,
``plan_comm_meta``, the trainer on ``ReplicatedLocal x RowSparseTransport``
and on int8 rows, and ``debug_checks`` (bit-identical when on, planted
contract violations raise). The JAX package runs the same numpy inputs;
round steps agree within 1e-5 over 3 steps (trainers 8 rounds), and the
int8 noise is the JAX package's own draws on the same keys."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.data import make_movielens_like as j_movielens
from repro.federated import FederatedTrainer as JTrainer
from repro.federated import make_round_step as j_make_round_step
from repro.federated import plan as jplan
from repro.models.recsys import lr_logits as j_lr_logits
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import lstm_loss as j_lstm_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.models.recsys import make_lstm_params as j_make_lstm_params
from repro.sharding.logical import unbox

import repro_torch.federated.plan as tplan
from repro_torch.analysis import sanitize
from repro_torch.configs.base import FedConfig
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.core.algorithms import ServerState, make_server_algorithm
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated.plan import (DenseTransport, FedSgdLocal, ReplicatedLocal,
                                        RoundPlan, RowSparseTransport, ServerUpdate,
                                        SubmodelReplicatedLocal, build_round_step,
                                        plan_comm_meta, plan_from_config, resolve_plan,
                                        round_capacity, split_heat_batch)
from repro_torch.federated.server import FederatedTrainer
from repro_torch.federated.simulation import batch_fingerprint, make_round_step
from repro_torch.models.recsys import lr_logits, lr_loss, lstm_loss
from repro_torch.sparse import compress
from repro_torch.sparse.rowsparse import RowSparse, unique_ids_padded

TOL = dict(rtol=1e-5, atol=1e-5)
V, E = 128, 6                      # tests/test_plan.py's LSTM
LR_V, LR_F = 96, 5
STEPS = 3


@pytest.fixture
def jax_uniforms(monkeypatch):
    """The port's int8 noise replaced by the JAX package's draws on the
    same ``fold_in(fold_in(PRNGKey(seed), rounds), leaf)`` keys."""
    def uniform(shape, seed, rounds, leaf_index, device):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rounds),
                                 leaf_index)
        return torch.from_numpy(np.array(jax.random.uniform(key, shape))).to(device)

    monkeypatch.setattr(compress, "int8_uniform", uniform)


# ---------------------------------------------------------------------------
# the models and their batches: the same numpy arrays for both packages
# ---------------------------------------------------------------------------


def _jax_params(model):
    if model == "lstm":
        return j_make_lstm_params(V, emb_dim=E, hidden=8, layers=1,
                                  rng=jax.random.PRNGKey(1))
    # LR from small random weights, so that every leaf moves from step one
    tree = j_make_lr_params(LR_V)
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda p: p + jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32) * 0.1), tree)


def _batch(model, seed, stacked):
    rng = np.random.default_rng(seed)
    if model == "lstm":
        lead = (3, 2, 2) if stacked else (6,)
        out = {"tokens": rng.integers(-1 if stacked else 0, V, lead + (8,)),
               "label": rng.integers(0, 2, lead)}
        v = V
    else:
        lead = (3, 2, 3) if stacked else (8,)
        out = {"features": rng.integers(-1, LR_V, lead + (LR_F,)),
               "label": rng.integers(0, 2, lead)}
        v = LR_V
    out = {k: x.astype(np.int32) for k, x in out.items()}
    out["heat_vocab"] = rng.integers(0, 6, v).astype(np.float32)
    return out


def _key(model):
    return "tokens" if model == "lstm" else "features"


def _loss(model):
    return (j_lstm_loss, lstm_loss) if model == "lstm" else (j_lr_loss, lr_loss)


def _fed(**kw):
    return dict(dict(num_clients=16, clients_per_round=3, local_iters=2, lr=0.1,
                     algorithm="fedsubavg"), **kw)


def _assert_tree_close(got, want_jax, **tol):
    want = _flatten(jax.tree.map(np.asarray, unbox(want_jax)))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name, **(tol or TOL))


def _run_both(model, mode_j, mode_t, stacked, fed_kw=None, correct=True, steps=STEPS):
    """``steps`` steps of the JAX package's and the port's make_round_step
    on the same batches; returns both losses, metrics and parameters."""
    j_loss, loss = _loss(model)
    jp = _jax_params(model)
    fed = _fed(**(fed_kw or {}))
    jstep = jax.jit(j_make_round_step(j_loss, jp, JFedConfig(**fed), mode=mode_j,
                                      correct=correct, feature_key=_key(model)))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    step = make_round_step(loss, params, axes, FedConfig(**fed), mode=mode_t,
                           correct=correct, feature_key=_key(model))
    jl, tl = [], []
    for r in range(steps):
        b = _batch(model, 100 + r, stacked)
        jp, jm = jstep(jp, {k: jnp.asarray(x) for k, x in b.items()})
        params, tm = step(params, {k: torch.from_numpy(x) for k, x in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jl, tl, jm, tm, jp, params


def _assert_run_close(model, jl, tl, jm, tm, jp, params):
    np.testing.assert_allclose(tl, jl, **TOL)
    assert set(tm) == set(jm)
    for name in ("sub_rows", "density"):
        if name in jm:
            assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-6)
    _assert_tree_close(params, jp)


# ---------------------------------------------------------------------------
# make_round_step: every mode string x correct, on LR and the LSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["lr", "lstm"])
@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "replicated", "sparse_replicated"])
@pytest.mark.parametrize("correct", [True, False])
def test_make_round_step_matches_jax(model, mode, correct):
    stacked = "replicated" in mode
    _assert_run_close(model, *_run_both(model, mode, mode, stacked, correct=correct))


@pytest.mark.parametrize("nmb", [2, 3])
def test_microbatched_fedsgd_matches_jax(nmb):
    """Gradient accumulation over ``nmb`` microbatches (f32 accumulator)."""
    _assert_run_close("lstm", *_run_both("lstm", "fedsgd", "fedsgd", False,
                                         fed_kw=dict(microbatches=nmb)))


def _plans(cls_mod, local, transport):
    server = cls_mod.ServerUpdate("fedsubavg")
    return cls_mod.RoundPlan(getattr(cls_mod, local)(), transport(cls_mod), server,
                             ("tokens",))


#: explicit compositions no mode string expresses
COMPOSITIONS = {
    "replicated x rowsparse": ("ReplicatedLocal", lambda m: m.RowSparseTransport(), True),
    "replicated x rowsparse top-4": ("ReplicatedLocal",
                                     lambda m: m.RowSparseTransport(topk=4), True),
    "submodel x dense": ("SubmodelReplicatedLocal", lambda m: m.DenseTransport(), True),
    "fedsgd x rowsparse top-4": ("FedSgdLocal", lambda m: m.RowSparseTransport(topk=4),
                                 False),
}


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_explicit_compositions_match_jax(name):
    local, transport, stacked = COMPOSITIONS[name]
    run = _run_both("lstm", _plans(jplan, local, transport),
                    _plans(tplan, local, transport), stacked)
    _assert_run_close("lstm", *run)


INT8_PLANS = {
    "fedsgd": ("FedSgdLocal", lambda m: m.RowSparseTransport(int8=True), False),
    "fedsgd top-4": ("FedSgdLocal", lambda m: m.RowSparseTransport(topk=4, int8=True),
                     False),
    "submodel": ("SubmodelReplicatedLocal", lambda m: m.RowSparseTransport(int8=True),
                 True),
    "replicated top-8": ("ReplicatedLocal",
                         lambda m: m.RowSparseTransport(topk=8, int8=True), True),
}


@pytest.mark.parametrize("name", sorted(INT8_PLANS))
def test_int8_on_the_batch_fingerprint_matches_jax(jax_uniforms, name):
    """The stateless step keys its int8 noise off the batch's fingerprint,
    summed as the JAX package sums it (uint32, -1 pads as 0xFFFFFFFF, 31
    bits): with the JAX package's draws, the whole path agrees."""
    local, transport, stacked = INT8_PLANS[name]
    b = _batch("lstm", 7, stacked)
    tokens = b["tokens"]
    want_fp = int(np.asarray(tokens, np.uint32).sum(dtype=np.uint32) & np.uint32(0x7FFFFFFF))
    assert batch_fingerprint({"tokens": torch.from_numpy(tokens)}, ("tokens",)) == want_fp
    _assert_run_close("lstm", *_run_both("lstm", _plans(jplan, local, transport),
                                         _plans(tplan, local, transport), stacked))


def test_stateless_int8_noise_follows_the_fingerprint():
    """The port's own stream: the same batch draws the same noise, and the
    step's noise is that of rounds = the fingerprint, not of rounds = 0."""
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(_jax_params("lstm"))),
                                   device="cpu")
    cfg = FedConfig(**_fed())
    plan = RoundPlan(FedSgdLocal(), RowSparseTransport(int8=True), ServerUpdate("fedavg"))
    b = {k: torch.from_numpy(x) for k, x in _batch("lstm", 1, False).items()}

    def emb(fn):
        return fn({k: v.clone() for k, v in params.items()})["embedding"]

    wrapper = make_round_step(lstm_loss, params, axes, cfg, mode=plan, correct=False)
    inner = build_round_step(plan, lstm_loss, axes, params, cfg)
    fp = batch_fingerprint(b, ("tokens",))
    assert fp != 0
    got = emb(lambda p: wrapper(p, b)[0])
    assert torch.equal(got, emb(lambda p: inner(ServerState(p, (), fp), b)[0].params))
    assert not torch.equal(got, emb(lambda p: inner(ServerState(p, (), 0), b)[0].params))
    assert torch.equal(got, emb(lambda p: wrapper(p, b)[0]))


def test_build_round_step_drives_stateful_server_with_batch_heat():
    """A fedadam ServerUpdate with heat read from the batch threads its
    optimizer slots through ServerState as the JAX package's does."""
    from repro.core.algorithms import make_server_algorithm as j_make_alg

    fed = _fed(algorithm="fedadam", server_lr=0.05)
    jp = _jax_params("lstm")
    jstate = j_make_alg(JFedConfig(**fed)).init(jp)
    jstep = jax.jit(jplan.build_round_step(
        jplan.RoundPlan(jplan.SubmodelReplicatedLocal(), jplan.RowSparseTransport(),
                        jplan.ServerUpdate("fedadam")), j_lstm_loss, jp, JFedConfig(**fed)))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    cfg = FedConfig(**fed)
    state = make_server_algorithm(cfg).init(params)
    step = build_round_step(RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                                      ServerUpdate("fedadam")), lstm_loss, axes, params, cfg)
    for r in range(STEPS):
        b = _batch("lstm", 70 + r, True)
        jstate, jm = jstep(jstate, {k: jnp.asarray(x) for k, x in b.items()})
        state, tm = step(state, {k: torch.from_numpy(x) for k, x in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert state.rounds == int(jstate.rounds) == STEPS
    _assert_tree_close(state.params, jstate.params)
    _assert_tree_close(state.opt[0], jstate.opt[0])


def test_fedsgd_microbatched_keeps_param_dtype():
    """The f32 accumulator is cast back to each parameter's dtype."""
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"].to(torch.float32)) ** 2)

    step = make_round_step(loss_fn, params, {"w": (None, None)},
                           FedConfig(num_clients=4, lr=0.1, microbatches=2),
                           mode="fedsgd", correct=False)
    new, _ = step(params, {"x": torch.ones((4, 4))})
    assert new["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------


def test_resolve_plan_compositions_and_passthrough():
    cfg = FedConfig(num_clients=8, microbatches=2)
    p = resolve_plan("fedsgd", cfg)
    assert isinstance(p.local, FedSgdLocal) and p.local.microbatches == 2
    assert isinstance(p.transport, DenseTransport)
    assert p.server.correct and p.server.stateless
    p = resolve_plan("sparse_replicated", cfg, correct=False)
    assert isinstance(p.local, SubmodelReplicatedLocal)
    assert isinstance(p.transport, RowSparseTransport)
    assert not p.server.correct
    assert resolve_plan(p, cfg) is p
    assert resolve_plan("replicated", cfg).local == ReplicatedLocal()
    one = FedConfig(num_clients=8)
    assert resolve_plan("sparse", one) == RoundPlan(FedSgdLocal(), RowSparseTransport(),
                                                    ServerUpdate("fedsubavg"))
    with pytest.raises(ValueError):
        resolve_plan("warp", cfg)
    with pytest.raises(ValueError, match="microbatches"):
        resolve_plan("sparse", cfg)


def test_resolve_plan_rejects_conflicting_args():
    cfg = FedConfig(num_clients=8)
    plan = RoundPlan(FedSgdLocal(), RowSparseTransport(), ServerUpdate("fedsubavg"))
    with pytest.raises(ValueError, match="correct=False"):
        resolve_plan(plan, cfg, correct=False)
    with pytest.raises(ValueError, match="feature_key"):
        resolve_plan(plan, cfg, feature_key="hist")
    assert resolve_plan(plan, cfg, feature_key="tokens") is plan
    avg = RoundPlan(FedSgdLocal(), RowSparseTransport(), ServerUpdate("fedavg"))
    assert resolve_plan(avg, cfg, correct=False) is avg


@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "replicated", "sparse_replicated"])
def test_resolve_plan_mirrors_jax(mode):
    for correct in (True, False):
        want = jplan.resolve_plan(mode, JFedConfig(num_clients=8), correct=correct)
        got = resolve_plan(mode, FedConfig(num_clients=8), correct=correct)
        assert got.describe() == want.describe()
        assert got.local == type(got.local)(**dataclasses.asdict(want.local))
        assert got.feature_keys == want.feature_keys


def test_make_round_step_rejects_stateful_server_and_conflicting_microbatches():
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(_jax_params("lstm"))),
                                   device="cpu")
    plan = RoundPlan(ReplicatedLocal(), DenseTransport(), ServerUpdate("fedadam"))
    with pytest.raises(ValueError, match="stateless"):
        make_round_step(lstm_loss, params, axes, FedConfig(num_clients=8,
                                                           algorithm="fedadam"), mode=plan)
    cfg = FedConfig(num_clients=8, microbatches=4)
    with pytest.raises(ValueError, match="microbatches"):
        make_round_step(lstm_loss, params, axes, cfg,
                        mode=RoundPlan(FedSgdLocal(), DenseTransport(), ServerUpdate("fedavg")))
    make_round_step(lstm_loss, params, axes, cfg,
                    mode=RoundPlan(FedSgdLocal(microbatches=4), DenseTransport(),
                                   ServerUpdate("fedavg")))
    with pytest.raises(ValueError, match="microbatches must be 1"):
        build_round_step(RoundPlan(FedSgdLocal(4), RowSparseTransport(),
                                   ServerUpdate("fedavg")), lstm_loss, axes, params, cfg)


def test_plan_from_config_resolution():
    p = plan_from_config(FedConfig(num_clients=8))
    assert isinstance(p.local, ReplicatedLocal) and isinstance(p.transport, DenseTransport)
    p = plan_from_config(FedConfig(num_clients=8, sparse=True, sparse_int8=True),
                         gatherable=True)
    assert isinstance(p.local, SubmodelReplicatedLocal)
    assert p.transport == RowSparseTransport(int8=True)
    p = plan_from_config(FedConfig(num_clients=8, sparse=True, sparse_local="replicated"))
    assert isinstance(p.local, ReplicatedLocal) and p.transport.sparse
    with pytest.raises(ValueError, match="central"):
        plan_from_config(FedConfig(num_clients=8, algorithm="central"))


@pytest.mark.parametrize("model", ["lr", "lstm"])
def test_plan_comm_meta_and_helpers_match_jax(model):
    jp = _jax_params(model)
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    assert tuple(plan_comm_meta(params, axes)) == tuple(jplan.plan_comm_meta(jp))
    for vocab, size in ((50257, 50260), (128, 37), (128, 400), (37069, 12800)):
        assert round_capacity(vocab, size) == jplan.round_capacity(vocab, size)
    b = _batch(model, 0, False)
    heat, data = split_heat_batch({k: torch.from_numpy(x) for k, x in b.items()})
    assert set(heat) == {"heat_vocab"} and "heat_vocab" not in data


# ---------------------------------------------------------------------------
# the trainer: ReplicatedLocal x RowSparseTransport and int8 rows
# ---------------------------------------------------------------------------

DS_KW = dict(num_clients=40, num_items=40, mean_samples=15)
ROUNDS = 8


@pytest.fixture(scope="module")
def data():
    ref = j_movielens(**DS_KW)
    init = jax.tree.map(np.asarray, unbox(j_make_lr_params(ref.num_features,
                                                           rng=jax.random.PRNGKey(0))))
    return ref, make_movielens_like(**DS_KW), init


def _trainers(data, **kw):
    ref, port, init = data
    fed = {**dict(num_clients=40, clients_per_round=6, local_iters=5, local_batch=5,
                  lr=0.5, algorithm="fedsubavg", sparse=True), **kw}
    jt = JTrainer(ref, functools.partial(j_make_lr_params, ref.num_features), j_lr_loss,
                  JFedConfig(**fed),
                  predict_fn=lambda p, t: j_lr_logits(p, jnp.asarray(t["features"])),
                  telemetry=False)
    tt = FederatedTrainer(port, functools.partial(params_from_jax, init), lr_loss,
                          FedConfig(**fed), predict_fn=lambda p, t: lr_logits(p, t["features"]),
                          device="cpu")
    return jt, tt


@pytest.mark.parametrize("kw", [
    dict(sparse_local="replicated"),
    dict(sparse_local="replicated", algorithm="fedavg"),
    dict(sparse_int8=True),
    dict(sparse_int8=True, sparse_local="replicated"),
    dict(sparse_int8=True, sparse_topk=48),
], ids=["replicated", "replicated-fedavg", "int8", "int8-replicated", "int8-top48"])
@pytest.mark.parametrize("entry", ["run_round", "run_rounds"])
def test_trainer_new_sparse_paths_match_jax(jax_uniforms, data, kw, entry):
    jt, tt = _trainers(data, **kw)
    assert type(tt.plan.local).__name__ == type(jt.plan.local).__name__
    assert tt.plan.transport.int8 == jt.plan.transport.int8
    if entry == "run_round":
        want = [jt.run_round() for _ in range(ROUNDS)]
        got = [tt.run_round() for _ in range(ROUNDS)]
    else:
        want, got = jt.run_rounds(ROUNDS), tt.run_rounds(ROUNDS)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_tree_close(tt.state.params, jt.state.params)
    assert tt.comm_summary() == jt.comm_summary()


# ---------------------------------------------------------------------------
# debug_checks: bit-identical when on; planted violations raise
# ---------------------------------------------------------------------------


def _lstm_port():
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(_jax_params("lstm"))),
                                   device="cpu")
    return params, axes, FedConfig(num_clients=50, clients_per_round=6, lr=0.1, seed=0)


def _torch_batch(seed, stacked):
    return {k: torch.from_numpy(x) for k, x in _batch("lstm", seed, stacked).items()}


@pytest.mark.parametrize("mode,stacked", [("sparse", False), ("sparse_replicated", True),
                                          ("int8", False)])
def test_debug_checks_on_and_off_bit_identical(jax_uniforms, mode, stacked):
    params, axes, cfg = _lstm_port()
    plan = (dataclasses.replace(resolve_plan("sparse", cfg),
                                transport=RowSparseTransport(int8=True))
            if mode == "int8" else resolve_plan(mode, cfg))
    dbg = dataclasses.replace(plan, debug_checks=True)
    assert dbg.describe() == plan.describe() + " [debug_checks]"
    p1 = {k: v.clone() for k, v in params.items()}
    p2 = {k: v.clone() for k, v in params.items()}
    plain = make_round_step(lstm_loss, params, axes, cfg, mode=plan)
    checked = make_round_step(lstm_loss, params, axes, cfg, mode=dbg)
    for seed in range(STEPS):
        p1, m1 = plain(p1, _torch_batch(seed, stacked))
        p2, m2 = checked(p2, _torch_batch(seed, stacked))
        assert float(m1["loss"]) == float(m2["loss"])
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name


@pytest.mark.parametrize("entry", ["run_round", "run_rounds"])
def test_debug_checks_trainer_bit_identical(data, entry):
    _, port, init = data
    fed = FedConfig(num_clients=40, clients_per_round=6, local_iters=2, local_batch=4,
                    lr=0.5, algorithm="fedsubavg", sparse=True)
    mk = functools.partial(params_from_jax, init)
    t1 = FederatedTrainer(port, mk, lr_loss, fed, device="cpu")
    t2 = FederatedTrainer(port, mk, lr_loss, fed, device="cpu",
                          plan=dataclasses.replace(t1.plan, debug_checks=True))
    assert "[debug_checks]" in t2.plan.describe()
    if entry == "run_round":
        l1 = [t1.run_round() for _ in range(4)]
        l2 = [t2.run_round() for _ in range(4)]
    else:
        l1, l2 = t1.run_rounds(4), t2.run_rounds(4)
    assert l1 == l2
    for name in t1.state.params:
        assert torch.equal(t1.state.params[name], t2.state.params[name])


def test_dense_plan_debug_checks_is_noop():
    params, axes, cfg = _lstm_port()
    plan = dataclasses.replace(resolve_plan("fedsgd", cfg), debug_checks=True)
    _, m = make_round_step(lstm_loss, params, axes, cfg, mode=plan)(
        params, _torch_batch(0, False))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("bad,match", [
    ([9, 3] + [-1] * 46, "ascending"),
    ([3, -1, 9] + [-1] * 45, "trailing"),
    ([3, 9, 200] + [-1] * 45, "out of range"),
    ([3, -2, 9] + [-1] * 45, "sentinel"),
])
def test_debug_checks_trip_on_planted_sub_ids(bad, match):
    params, axes, cfg = _lstm_port()
    plan = dataclasses.replace(resolve_plan("sparse", cfg), debug_checks=True)
    step = build_round_step(plan, lstm_loss, axes, params, cfg)
    state = ServerState(params, (), 0)
    state, m = step(state, _torch_batch(0, False))            # derived ids: clean
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match=match):
        step(state, _torch_batch(0, False), torch.tensor(bad, dtype=torch.int32))


def test_check_union_ids_bounds_and_cohort_rows():
    sanitize.check_union_ids(torch.tensor([1, 5, 7, -1]), 8)
    with pytest.raises(ValueError, match="out of range"):
        sanitize.check_union_ids(torch.tensor([1, 5, 9, -1]), 8)
    sanitize.check_union_ids(torch.tensor([[1, 5, -1], [0, 2, 3]]), 8)
    with pytest.raises(ValueError, match="ascending"):
        sanitize.check_union_ids(torch.tensor([[1, 5, -1], [0, 3, 2]]), 8)


def test_check_rowsparse_pad_rows_zeroed():
    ids = torch.tensor([2, 5, -1], dtype=torch.int32)
    sanitize.check_rowsparse(RowSparse(ids, torch.tensor([[1.0], [2.0], [0.0]]), 8))
    with pytest.raises(ValueError, match="pad slot"):
        sanitize.check_rowsparse(RowSparse(ids, torch.tensor([[1.0], [2.0], [3.0]]), 8))


def test_check_drop_order():
    toks = torch.arange(12)
    sanitize.check_drop_order(unique_ids_padded(toks, 8), toks)      # drops 8..11
    with pytest.raises(ValueError, match="largest-first"):
        sanitize.check_drop_order(torch.arange(4, 12, dtype=torch.int32), toks)
    with pytest.raises(ValueError):
        sanitize.check_drop_order(unique_ids_padded(torch.tensor([1, 3]), 8),
                                  torch.tensor([1, 3, 5]))
    # per client on a (K, R) stack: client 1 kept its largest ids
    feats = torch.stack([torch.arange(12), torch.arange(12)])
    good = unique_ids_padded(feats, 8)
    sanitize.check_drop_order(good, feats)
    bad = good.clone()
    bad[1] = torch.arange(4, 12)
    with pytest.raises(ValueError, match="largest-first"):
        sanitize.check_drop_order(bad, feats)


def test_check_capacity_static():
    sanitize.check_capacity(16, V)
    sanitize.check_capacity(V, V)
    with pytest.raises(ValueError, match="multiple of 8"):
        sanitize.check_capacity(12, V)
