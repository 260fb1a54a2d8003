"""Port parity, the buffered-async engine: ``repro_torch.federated.arrivals``
and ``async_engine`` and the trainer's ``run_async`` against the JAX
package's on the same seeds. Schedules bit-identical over every delay law,
with stragglers, dropouts and seeds, the makespans equal, the same
validation errors and rejections; ``run_async`` within 1e-5 of the JAX
trainer's (losses, parameters, the EMA heat, telemetry; integers exact);
the zero-delay degeneracy against the port's own ``run_rounds``; a mid-run
checkpoint of an ``AsyncState``; dropped clients' private rows untouched;
the engine cached per server slot."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.data import make_movielens_like as j_movielens
from repro.federated import ArrivalSim as JArrivalSim
from repro.federated import BufferedAsyncServerUpdate as JServerSlot
from repro.federated import FederatedTrainer as JTrainer
from repro.federated import staleness_weight as j_staleness_weight
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.models.recsys import make_lstm_params as j_make_lstm_params
from repro.sharding.logical import unbox

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.algorithms import ServerState
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated import (ArrivalSim, BufferedAsyncServerUpdate,
                                   build_async_engine, staleness_weight)
from repro_torch.federated.arrivals import ARRIVAL, DISPATCH
from repro_torch.federated.plan import (CohortSharding, DenseTransport, FedSgdLocal,
                                        ReplicatedLocal, RoundPlan, RowSparseTransport,
                                        ServerUpdate, SubmodelReplicatedLocal)
from repro_torch.federated.server import FederatedTrainer, derive_sub_ids
from repro_torch.launch.mesh import CohortMesh
from repro_torch.models.recsys import lr_loss, lstm_loss

from test_torch_telemetry import assert_telemetry_close

TOL = dict(rtol=1e-5, atol=1e-5)
COLUMNS = ("kind", "task", "slot", "staleness", "fire", "inflight", "dispatch_time",
           "arrival_time", "dropped", "arrival_tasks")

# ---------------------------------------------------------------------------
# ArrivalSim: bit-identical schedules
# ---------------------------------------------------------------------------

SIMS = {
    "zero": dict(num_rounds=4),
    "exponential": dict(num_rounds=5, delay="exponential", delay_scale=0.7, seed=3),
    "lognormal": dict(num_rounds=6, delay="lognormal", delay_scale=0.5,
                      lognormal_sigma=1.2, seed=8),
    "stragglers": dict(num_rounds=5, delay="exponential", straggler_frac=0.2,
                       straggler_factor=6.0, straggler_tasks=(1, 7), seed=11),
    "dropouts": dict(num_rounds=6, delay="lognormal", lognormal_sigma=1.5,
                     dropout_frac=0.15, dropout_tasks=(2,), seed=5),
    "both": dict(num_rounds=20, delay="lognormal", delay_scale=0.5, lognormal_sigma=1.2,
                 straggler_frac=0.05, dropout_frac=0.02, seed=8),
    "other seed": dict(num_rounds=20, delay="lognormal", delay_scale=0.5,
                       lognormal_sigma=1.2, straggler_frac=0.05, dropout_frac=0.02,
                       seed=9),
}


@pytest.mark.parametrize("name", sorted(SIMS))
@pytest.mark.parametrize("k,m", [(4, 4), (5, 3), (10, 25)])
def test_arrival_schedules_bit_identical_to_jax(name, k, m):
    got = ArrivalSim(**SIMS[name]).compile(k, m)
    want = JArrivalSim(**SIMS[name]).compile(k, m)
    for col in COLUMNS:
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    for attr in ("num_slots", "num_tasks", "num_arrivals", "num_fires", "num_events"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for fn in ("barrier_makespan", "async_makespan", "sim_speedup"):
        assert getattr(got, fn)() == getattr(want, fn)(), fn
    cut = got.num_events // 3
    for g, w in zip(got.slice_events(cut, 2 * cut).values(),
                    want.slice_events(cut, 2 * cut).values()):
        np.testing.assert_array_equal(g, w)
    if name == "zero":
        # the synchronous order: K dispatches then K arrivals per wave
        assert list(got.kind[:2 * k]) == [DISPATCH] * k + [ARRIVAL] * k


@pytest.mark.parametrize("kw,compile_kw", [
    (dict(num_rounds=0), None), (dict(num_rounds=1, delay="gamma"), None),
    (dict(num_rounds=1, delay_scale=0.0), None),
    (dict(num_rounds=1, straggler_frac=1.5), None),
    (dict(num_rounds=1, straggler_factor=0.5), None),
    (dict(num_rounds=1, dropout_frac=-0.1), None),
    (dict(num_rounds=1, straggler_tasks=(9,)), (4, 2)),
    (dict(num_rounds=1, dropout_tasks=(4,)), (4, 2)),
    (dict(num_rounds=1), (0, 2)), (dict(num_rounds=1), (2, 0)),
])
def test_arrival_validation_matches_jax(kw, compile_kw):
    def err(cls):
        try:
            sim = cls(**kw)
            if compile_kw:
                sim.compile(*compile_kw)
        except ValueError as e:
            return str(e)
        return None

    got = err(ArrivalSim)
    assert got is not None and got == err(JArrivalSim)


# ---------------------------------------------------------------------------
# server slot, weights and rejections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(algorithm="scaffold"), dict(buffer_size=0),
                                dict(staleness="linear"), dict(staleness_alpha=-1.0),
                                dict(heat="exact"), dict(heat_beta=0.0)])
def test_server_slot_validation_matches_jax(kw):
    with pytest.raises(ValueError) as got:
        BufferedAsyncServerUpdate(**kw)
    with pytest.raises(ValueError) as want:
        JServerSlot(**kw)
    assert str(got.value) == str(want.value)


def test_staleness_weight_matches_jax():
    s = np.arange(12, dtype=np.int32)
    for scheme, alpha in (("constant", 0.5), ("polynomial", 0.5), ("polynomial", 1.3)):
        np.testing.assert_allclose(staleness_weight(torch.from_numpy(s), scheme, alpha),
                                   np.asarray(j_staleness_weight(jnp.asarray(s), scheme,
                                                                 alpha)),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="unknown staleness"):
        staleness_weight(s, "linear")


V, E = 64, 4


def _lstm():
    jp = j_make_lstm_params(V, emb_dim=E, hidden=8, layers=1, rng=jax.random.PRNGKey(1))
    return params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")


def _cfg(**kw):
    return FedConfig(**{**dict(num_clients=50, clients_per_round=4, local_iters=2,
                               lr=0.2, algorithm="fedsubavg"), **kw})


def _plan(server, local=None, transport=None, **kw):
    return RoundPlan(local or SubmodelReplicatedLocal(), transport or RowSparseTransport(),
                     server, feature_keys=("tokens",), **kw)


COUNTS = {"vocab": torch.full((V,), 5.0)}


@pytest.mark.parametrize("change,exc,match", [
    (dict(server=ServerUpdate("fedsubavg")), TypeError, "BufferedAsyncServerUpdate"),
    (dict(sharding=CohortSharding(CohortMesh(rank=0, size=2, device=torch.device("cpu")))),
     ValueError, "inherently sequential"),
    (dict(transport=DenseTransport()), ValueError, "RowSparseTransport"),
    (dict(transport=RowSparseTransport(int8=True)), ValueError, "int8"),
    (dict(local=FedSgdLocal()), ValueError, "FedSgdLocal"),
    (dict(debug_checks=True), ValueError, "debug_checks"),
    (dict(heat_counts=None), ValueError, "heat_counts"),
    (dict(axes="no tables"), ValueError, "axis-0 feature table"),
    (dict(server=BufferedAsyncServerUpdate(algorithm="fedavg", heat="ema"),
          heat_counts=None), ValueError, "heat_counts"),
])
def test_build_async_engine_rejections(change, exc, match):
    params, axes = _lstm()
    change = dict(change)
    server = change.pop("server", BufferedAsyncServerUpdate())
    counts = change.pop("heat_counts", COUNTS)
    if change.pop("axes", None):
        axes = {k: (None,) * len(v) for k, v in axes.items()}
    local, transport = change.pop("local", None), change.pop("transport", None)
    plan = _plan(server, local, transport, **change)
    with pytest.raises(exc, match=match):
        build_async_engine(plan, lstm_loss, axes, params, _cfg(), heat_counts=counts,
                           total=50.0)


def test_replicated_local_and_fedavg_without_heat_are_accepted():
    params, axes = _lstm()
    build_async_engine(_plan(BufferedAsyncServerUpdate(), local=ReplicatedLocal()),
                       lstm_loss, axes, params, _cfg(), heat_counts=COUNTS, total=50.0)
    build_async_engine(_plan(BufferedAsyncServerUpdate(algorithm="fedavg")), lstm_loss,
                       axes, params, _cfg())


# ---------------------------------------------------------------------------
# the engine on the LSTM: dropped clients, EMA heat, mid-run checkpoints
# ---------------------------------------------------------------------------


def _tasks(num_tasks, seed=0, lo=0, hi=V, special=()):
    rng = np.random.default_rng(seed)
    toks = rng.integers(lo, hi, (num_tasks, 2, 2, 6))
    for t, (slo, shi) in special:
        toks[t] = rng.integers(slo, shi, (2, 2, 6))
    return {"tokens": torch.from_numpy(toks.astype(np.int32)),
            "label": torch.from_numpy(rng.integers(0, 2, (num_tasks, 2, 2)).astype(np.int32))}


def _engine(server, local=None, telemetry=False):
    params, axes = _lstm()
    eng = build_async_engine(_plan(server, local), lstm_loss, axes, params, _cfg(),
                             heat_counts=COUNTS, total=50.0, telemetry=telemetry)
    return eng, params


def _fresh(eng, params, sch, cap):
    return eng.init(ServerState({k: v.clone() for k, v in params.items()}, (), 0),
                    num_slots=sch.num_slots, capacity=cap)


@pytest.mark.parametrize("local", [SubmodelReplicatedLocal(), ReplicatedLocal()],
                         ids=["submodel", "replicated"])
def test_never_arriving_client_rows_untouched(local):
    drop_task = 3
    sch = ArrivalSim(num_rounds=2, delay="exponential", delay_scale=0.5,
                     dropout_tasks=(drop_task,), seed=4).compile(2, 2)
    tasks = _tasks(4, seed=9, hi=48, special=((drop_task, (48, V)),))
    sub_ids = derive_sub_ids(tasks["tokens"].reshape(4, -1), V, 32)
    eng, params = _engine(BufferedAsyncServerUpdate(buffer_size=2), local)
    st, ys = eng.run(_fresh(eng, params, sch, 32), sch.event_arrays(), tasks, sub_ids)
    after = st.server.params["embedding"]
    assert torch.equal(after[48:], params["embedding"][48:])
    assert (after[:48] - params["embedding"][:48]).abs().max() > 0
    assert st.server.rounds == sch.num_fires == int(ys["fired"].sum())
    assert list(ys["version"][ys["fired"]]) == list(range(1, sch.num_fires + 1))


def test_ema_heat_tracks_arrivals_and_stays_clamped():
    sch = ArrivalSim(num_rounds=3, delay="exponential", delay_scale=0.3,
                     seed=6).compile(3, 3)
    eng, params = _engine(BufferedAsyncServerUpdate(buffer_size=3, heat="ema",
                                                    heat_beta=0.2))
    st = _fresh(eng, params, sch, 32)
    p0 = st.heat_ema.clone()
    np.testing.assert_allclose(p0.numpy(), 5.0 / 50, rtol=1e-6)
    tasks = _tasks(sch.num_tasks, seed=3, hi=32)
    sub_ids = derive_sub_ids(tasks["tokens"].reshape(sch.num_tasks, -1), V, 32)
    st, _ = eng.run(st, sch.event_arrays(), tasks, sub_ids)
    p = st.heat_ema
    assert ((0.0 <= p) & (p <= 1.0)).all()
    np.testing.assert_allclose(p[32:].numpy(), p0[32:].numpy() * 0.8 ** sch.num_arrivals,
                               rtol=1e-5)
    assert p[:32].max() > p0.max() and st.arrivals == sch.num_arrivals


def test_mid_run_checkpoint_resume(tmp_path):
    """Run events [0, e), save the AsyncState (server, slots, buffer, EMA
    heat), load it on the host into a fresh state, run [e, E): equal to one
    uninterrupted run (the saved f32 values are exact)."""
    sch = ArrivalSim(num_rounds=4, delay="lognormal", delay_scale=0.5,
                     lognormal_sigma=1.2, seed=8).compile(3, 2)
    eng, params = _engine(BufferedAsyncServerUpdate(buffer_size=2, staleness="polynomial",
                                                    heat="ema", heat_beta=0.1),
                          telemetry=True)
    tasks = _tasks(sch.num_tasks, seed=11)
    feats = tasks["tokens"].reshape(sch.num_tasks, -1)
    sub_ids = derive_sub_ids(feats, V, 32)
    full, ys_full = eng.run(_fresh(eng, params, sch, 32), sch.event_arrays(), tasks,
                            sub_ids, feats)
    cut = sch.num_events // 2
    half, ys_a = eng.run(_fresh(eng, params, sch, 32), sch.slice_events(0, cut), tasks,
                         sub_ids, feats)
    path = str(tmp_path / "async_state")
    save_checkpoint(path, half, step=cut)
    template = _fresh(eng, params, sch, 32)
    resumed = load_checkpoint(path, template)
    assert resumed.arrivals == half.arrivals and resumed.buf_count == half.buf_count
    assert resumed.server.rounds == half.server.rounds
    done, ys_b = eng.run(resumed, sch.slice_events(cut, sch.num_events), tasks, sub_ids,
                         feats)
    for k in full.server.params:
        assert torch.equal(done.server.params[k], full.server.params[k]), k
    assert torch.equal(done.heat_ema, full.heat_ema)
    assert torch.equal(torch.cat([ys_a["loss"], ys_b["loss"]]), ys_full["loss"])
    np.testing.assert_array_equal(np.concatenate([ys_a["version"], ys_b["version"]]),
                                  ys_full["version"])
    for a, b, f in zip(ys_a["telemetry"], ys_b["telemetry"], ys_full["telemetry"]):
        if f is not None:
            assert torch.equal(torch.cat([a, b]), f)


# ---------------------------------------------------------------------------
# the trainer: run_async against the JAX trainer and against run_rounds
# ---------------------------------------------------------------------------

DS_KW = dict(num_clients=40, num_items=40, mean_samples=15)


@pytest.fixture(scope="module")
def data():
    ref = j_movielens(**DS_KW)
    init = jax.tree.map(np.asarray, unbox(j_make_lr_params(ref.num_features,
                                                           rng=jax.random.PRNGKey(0))))
    return ref, make_movielens_like(**DS_KW), init


def _fed(**kw):
    return {**dict(num_clients=40, clients_per_round=6, local_iters=3, local_batch=4,
                   lr=0.5, algorithm="fedsubavg", sparse=True), **kw}


def _port(data, telemetry=True, **kw):
    _, port, init = data
    return FederatedTrainer(port, functools.partial(params_from_jax, init), lr_loss,
                            FedConfig(**_fed(**kw)), device="cpu", telemetry=telemetry)


def _jax(data, **kw):
    ref = data[0]
    return JTrainer(ref, functools.partial(j_make_lr_params, ref.num_features),
                    j_lr_loss, JFedConfig(**_fed(**kw)))


def _assert_params_close(tt, jt):
    want = jax.tree.map(np.asarray, unbox(jt.state.params))
    for name, w in want.items():
        np.testing.assert_allclose(tt.state.params[name].numpy(), w, err_msg=name, **TOL)


def test_zero_delay_full_buffer_matches_run_rounds(data):
    """The degeneracy: same losses, parameters, numpy stream and bytes as
    the port's own synchronous engine (bit for bit on the host)."""
    sync, asyn = _port(data), _port(data)
    want = sync.run_rounds(5)
    got = asyn.run_async(ArrivalSim(num_rounds=5))
    assert got == want
    assert all(torch.equal(sync.state.params[k], asyn.state.params[k])
               for k in sync.state.params)
    assert sync.state.rounds == asyn.state.rounds == 5
    assert sync.np_rng.integers(1 << 30) == asyn.np_rng.integers(1 << 30)
    assert [c.as_dict() for c in sync.comm_log] == [c.as_dict() for c in asyn.comm_log]
    for s, a in zip(sync.telemetry_log, asyn.telemetry_log):
        assert a["staleness_hist"][0] == 6.0 and s["staleness_hist"] is None
        assert {k: a[k] for k in ("union_size", "agg_rows", "heat_hist", "density")} == \
            {k: s[k] for k in ("union_size", "agg_rows", "heat_hist", "density")}


ASYNC_RUNS = {
    "polynomial ema top-k": (dict(sparse_topk=48), dict(
        buffer_size=4, staleness="polynomial", heat="ema", heat_beta=0.1)),
    "constant static": ({}, dict(buffer_size=5)),
    "fedavg polynomial": (dict(algorithm="fedavg"), dict(
        algorithm="fedavg", buffer_size=3, staleness="polynomial", staleness_alpha=1.0)),
}


@pytest.mark.parametrize("name", sorted(ASYNC_RUNS))
def test_run_async_matches_jax(data, name):
    fed, srv = ASYNC_RUNS[name]
    sim = dict(num_rounds=5, delay="lognormal", delay_scale=0.5, lognormal_sigma=1.2,
               straggler_frac=0.1, dropout_frac=0.05, seed=8)
    jt, tt = _jax(data, **fed), _port(data, **fed)
    want = jt.run_async(JArrivalSim(**sim), server=JServerSlot(**srv))
    got = tt.run_async(ArrivalSim(**sim), server=BufferedAsyncServerUpdate(**srv))
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params_close(tt, jt)
    if srv.get("heat") == "ema":
        np.testing.assert_allclose(tt._async_heat_ema.numpy(),
                                   np.asarray(jt._async_heat_ema), **TOL)
    assert len(tt.telemetry_log) == len(jt.telemetry_log) == len(want)
    for g, w in zip(tt.telemetry_log, jt.telemetry_log):
        assert_telemetry_close(g, w)
        assert sum(g["staleness_hist"]) == srv["buffer_size"]
    assert tt.comm_summary() == jt.comm_summary()
    # a second call continues both the numpy stream and the EMA
    sim2 = {**sim, "seed": 9, "num_rounds": 2}
    want = jt.run_async(JArrivalSim(**sim2), server=JServerSlot(**srv))
    got = tt.run_async(ArrivalSim(**sim2), server=BufferedAsyncServerUpdate(**srv))
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params_close(tt, jt)


def test_trainer_caches_one_engine_per_server_slot(data):
    tr = _port(data)
    tr.run_async(ArrivalSim(num_rounds=2))
    tr.run_async(ArrivalSim(num_rounds=2, seed=1))
    assert len(tr._async_engines) == 1
    tr.run_async(ArrivalSim(num_rounds=2), server=BufferedAsyncServerUpdate(buffer_size=3))
    assert len(tr._async_engines) == 2
    off = _port(data, telemetry=False)
    off.run_async(ArrivalSim(num_rounds=2))
    assert off.telemetry_log == [] and list(off._async_engines)[0][1] is False


def test_run_async_needs_the_sparse_plan(data):
    _, port, init = data
    dense = FederatedTrainer(port, functools.partial(params_from_jax, init), lr_loss,
                             FedConfig(**{**_fed(), "sparse": False}), device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        dense.run_async(ArrivalSim(num_rounds=1))
