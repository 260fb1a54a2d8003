"""Port parity, round telemetry: ``repro_torch.telemetry`` and the
telemetry branch of the round plan and the trainer against the JAX
package's on the same numpy inputs. Integers and ids exact, floats within
1e-5; telemetry on and off bit-identical in the port. Also the trace sink
(its JSONL keys equal the reference's), the first-dispatch split of
``RoundRecord``, verbose output through logging, a ``profile_dir`` trace,
and the heat histogram's bucket contract, where the port departs from the
reference's rounded ``log2`` at exact powers of two."""
import dataclasses
import functools
import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.core.algorithms import ServerState as JServerState
from repro.data import make_movielens_like as j_movielens
from repro.federated import FederatedTrainer as JTrainer
from repro.federated import make_round_step as j_make_round_step
from repro.federated import plan as jplan
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import lstm_loss as j_lstm_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.models.recsys import make_lstm_params as j_make_lstm_params
from repro.sharding.logical import unbox
from repro.sparse import rowsparse as j_rowsparse
from repro.telemetry import TraceSink as JTraceSink
from repro.telemetry import round as jtel

from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.algorithms import ServerState
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated import plan as tplan
from repro_torch.federated.server import FederatedTrainer
from repro_torch.federated.simulation import make_round_step
from repro_torch.models.recsys import lr_loss, lstm_loss
from repro_torch.sparse.rowsparse import RowSparse, membership, unique_ids_padded
from repro_torch.telemetry import (HEAT_BUCKETS, PhaseTimer, RoundTelemetry,
                                   TraceSink, read_events)
from repro_torch.telemetry import round as ttel

TOL = dict(rtol=1e-5, atol=1e-5)
V, E = 96, 6                      # the LSTM's vocabulary and width
LR_V, LR_F = 96, 5
STEPS = 2


def _np(x):
    return np.asarray(x)


def _both(a):
    """The same numpy array as a JAX and a torch array."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def assert_telemetry_close(got: dict, want: dict):
    """Host telemetry dicts: every field, integers exact, floats 1e-5."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, name
        elif name in ("dropped_ids", "dropped_per_client", "union_size", "agg_rows",
                      "buffer_occupancy", "heat_hist", "staleness_hist", "round",
                      "event"):
            assert g == w, (name, g, w)
        elif name == "comm":
            assert g == w
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# the counters against repro.telemetry.round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_membership_matches_jax(batched):
    rng = np.random.default_rng(3)
    lead = (4,) if batched else ()
    raw = rng.integers(0, V, lead + (20,)).astype(np.int32)
    tokens = rng.integers(-1, V, lead + (40,)).astype(np.int32)
    ids = unique_ids_padded(torch.from_numpy(raw), 16)
    j_ids = jnp.asarray(ids.numpy())
    if batched:
        want = jax.vmap(j_rowsparse.membership)(jnp.asarray(tokens), j_ids)
    else:
        want = j_rowsparse.membership(jnp.asarray(tokens), j_ids)
    got = membership(torch.from_numpy(tokens), ids)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not membership(torch.tensor([0, 3, -1]), torch.full((8,), -1)).any()


@pytest.mark.parametrize("case", ["per_client", "flat", "overflowing", "flat_overflowing"])
def test_drop_stats_matches_jax(case):
    rng = np.random.default_rng(7)
    batched = not case.startswith("flat")
    feats = rng.integers(-1, V + 4, (5, 24) if batched else (60,)).astype(np.int32)
    cap = 4 if "overflowing" in case else 64
    sub = unique_ids_padded(ttel.valid_feature_ids(torch.from_numpy(feats), V), cap)
    jf, tf = _both(feats)
    jd, jm = jtel.drop_stats(jf, jnp.asarray(sub.numpy()), V)
    td, tm = ttel.drop_stats(tf, sub, V)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    assert td.dtype == torch.int32 and tm.dtype == torch.float32
    assert (int(td.sum()) > 0) == ("overflowing" in case)
    np.testing.assert_array_equal(ttel.valid_feature_ids(tf, V).numpy(),
                                  _np(jtel.valid_feature_ids(jf, V)))
    np.testing.assert_array_equal(ttel.union_ids_vec(sub, V).numpy(),
                                  _np(jtel.union_ids_vec(jnp.asarray(sub.numpy()), V)))


def test_heat_histogram_matches_jax():
    """Heats below 8,192, integer and half-integer (the two rounded ``log2``
    buckets agree there), with pads and repeated ids."""
    rng = np.random.default_rng(5)
    heat = rng.integers(0, 8192, 4000).astype(np.float32)
    heat[::3] += 0.5
    ids = rng.integers(-1, 4000, 3000).astype(np.int32)
    jh, th = _both(heat)
    ji, ti = _both(ids)
    want = _np(jtel.heat_histogram(jh, ji))
    got = ttel.heat_histogram(th, ti)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (HEAT_BUCKETS,) and got.sum() == (ids >= 0).sum()


def test_heat_histogram_buckets_are_exact_exponents():
    """Bucket b holds [2^b, 2^{b+1}): 2^13 lands in bucket 13 and 2^15 in
    15 in the port. The reference's ``floor(log2(h))`` may fall one ulp
    short at exact powers of two (JAX on the CPU: 12 and 14), and the two
    packages may differ only there (ROADMAP Queue 3)."""
    heat = np.asarray([2.0 ** b for b in range(16)] + [2.0 ** b - 1 for b in range(2, 16)]
                      + [2.0 ** b + 1 for b in range(1, 16)] + [0.0, 0.5, 1e9],
                      np.float32)
    ids = np.arange(heat.size, dtype=np.int32)
    exact = np.clip(np.floor(np.log2(np.maximum(heat.astype(np.float64), 1.0))),
                    0, HEAT_BUCKETS - 1).astype(int)
    th, ti = torch.from_numpy(heat), torch.from_numpy(ids)
    for i in range(heat.size):
        one = ttel.heat_histogram(th, ti[i:i + 1]).numpy()
        assert one.argmax() == exact[i] and one.sum() == 1, (heat[i], one)
        jone = _np(jtel.heat_histogram(jnp.asarray(heat), jnp.asarray(ids[i:i + 1])))
        if jone.argmax() != exact[i]:
            assert heat[i] == 2.0 ** exact[i] and jone.argmax() == exact[i] - 1
    for b in (13, 15):
        h = ttel.heat_histogram(torch.tensor([2.0 ** b]), torch.tensor([0]))
        assert int(h.argmax()) == b


def test_staleness_histogram_matches_jax():
    s = np.asarray([0, 0, 1, 3, 15, 16, 40, -1, 2], np.int32)
    js, ts = _both(s)
    np.testing.assert_array_equal(ttel.staleness_histogram(ts).numpy(),
                                  _np(jtel.staleness_histogram(js)))


def test_tree_sums_and_agg_rows_match_jax():
    rng = np.random.default_rng(9)
    ids = np.stack([np.sort(rng.choice(V, 6, replace=False)) for _ in range(3)])
    ids[0, 4:] = -1
    rows = rng.normal(size=(3, 6, E)).astype(np.float32) * (ids >= 0)[..., None]
    dense = rng.normal(size=(3, 4)).astype(np.float32)
    jtree = {"emb": j_rowsparse.RowSparse(jnp.asarray(ids.astype(np.int32)),
                                          jnp.asarray(rows), V),
             "w": jnp.asarray(dense)}
    ttree = {"w": torch.from_numpy(dense),
             "emb": RowSparse(torch.from_numpy(ids.astype(np.int32)),
                              torch.from_numpy(rows), V)}
    np.testing.assert_allclose(float(ttel.tree_sq_sum(ttree)),
                               float(jtel.tree_sq_sum(jtree)), **TOL)
    np.testing.assert_allclose(ttel.tree_sq_per_client(ttree, 3).numpy(),
                               _np(jtel.tree_sq_per_client(jtree, 3)), **TOL)
    flat = {"emb": RowSparse(torch.from_numpy(ids[0].astype(np.int32)),
                             torch.from_numpy(rows[0]), V), "w": torch.from_numpy(dense[0])}
    jflat = {"emb": j_rowsparse.RowSparse(jnp.asarray(ids[0]), jnp.asarray(rows[0]), V),
             "w": jnp.asarray(dense[0])}
    assert int(ttel.tree_agg_rows(flat)) == int(jtel.tree_agg_rows(jflat)) == 4
    assert ttel.tree_agg_rows({"w": torch.zeros(2)}) is None


# ---------------------------------------------------------------------------
# the round plan: make_round_step(telemetry=True) in all four modes
# ---------------------------------------------------------------------------


def _jax_params(model):
    if model == "lstm":
        return j_make_lstm_params(V, emb_dim=E, hidden=8, layers=1,
                                  rng=jax.random.PRNGKey(1))
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
    else:
        lead = (3, 2, 3) if stacked else (8,)
        out = {"features": rng.integers(-1, LR_V, lead + (LR_F,)),
               "label": rng.integers(0, 2, lead)}
    out = {k: x.astype(np.int32) for k, x in out.items()}
    out["heat_vocab"] = rng.integers(0, 6, V).astype(np.float32)
    return out


def _fed(**kw):
    return dict(dict(num_clients=16, clients_per_round=3, local_iters=2, lr=0.1,
                     algorithm="fedsubavg"), **kw)


@pytest.mark.parametrize("model", ["lr", "lstm"])
@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "replicated", "sparse_replicated"])
def test_round_step_telemetry_matches_jax(model, mode):
    j_loss, loss = (j_lstm_loss, lstm_loss) if model == "lstm" else (j_lr_loss, lr_loss)
    key = "tokens" if model == "lstm" else "features"
    stacked = mode.endswith("replicated")
    jp = _jax_params(model)
    jstep = jax.jit(j_make_round_step(j_loss, jp, JFedConfig(**_fed()), mode=mode,
                                      feature_key=key, telemetry=True))
    init = jax.tree.map(np.asarray, unbox(jp))
    runs = {}
    for tel in (True, False):
        params, axes = params_from_jax(init, device="cpu")
        runs[tel] = (make_round_step(loss, params, axes, FedConfig(**_fed()), mode=mode,
                                     feature_key=key, telemetry=tel), params, [])
    for r in range(STEPS):
        b = _batch(model, 100 + r, stacked)
        jp, jm = jstep(jp, {k: jnp.asarray(x) for k, x in b.items()})
        for tel, (step, params, out) in runs.items():
            params, m = step(params, {k: torch.from_numpy(x) for k, x in b.items()})
            runs[tel] = (step, params, out + [m])
        m_on, m_off = runs[True][2][-1], runs[False][2][-1]
        assert "telemetry" not in m_off
        assert torch.equal(m_on["loss"], m_off["loss"])
        got = ttel.telemetry_to_host(m_on["telemetry"])
        assert_telemetry_close(got, jtel.telemetry_to_host(jm["telemetry"]))
        assert got["delta_norm_pre"] > 0 and got["dropped_ids"] == 0
        if mode.startswith("sparse"):
            assert got["union_size"] > 0 and sum(got["heat_hist"]) == got["union_size"]
    p_on, p_off = runs[True][1], runs[False][1]
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_on)


def test_planted_small_capacity_drop_counts_equal_numpy():
    """Sub-ids of capacity 4 handed to ``build_round_step``'s step (what
    make_round_step wraps): the drop counts equal a numpy count of the same
    ids, per client."""
    jp = _jax_params("lstm")
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    plan = tplan.resolve_plan("sparse_replicated", FedConfig(**_fed()))
    step = tplan.build_round_step(plan, lstm_loss, axes, params, FedConfig(**_fed()),
                                  telemetry=True)
    b = _batch("lstm", 31, True)
    feats = b["tokens"].reshape(3, -1)
    cap = 4
    small = unique_ids_padded(torch.from_numpy(feats), cap)
    _, m = step(ServerState(params, (), 0), {k: torch.from_numpy(x) for k, x in b.items()},
                small)
    tel = ttel.telemetry_to_host(m["telemetry"])
    dropped, mass = [], []
    for row in feats:
        row = row[row >= 0]
        kept = np.unique(row)[:cap]
        dropped.append(len(np.unique(row)) - len(kept))
        mass.append(int((~np.isin(row, kept)).sum()))
    assert tel["dropped_per_client"] == dropped and sum(dropped) > 0
    assert tel["dropped_ids"] == sum(dropped) and tel["dropped_mass"] == float(sum(mass))
    jstep = jplan.build_round_step(jplan.resolve_plan("sparse_replicated",
                                                      JFedConfig(**_fed())),
                                   j_lstm_loss, jp, JFedConfig(**_fed()), telemetry=True)
    _, jm = jax.jit(jstep)(JServerState(jp, (), jnp.zeros((), jnp.int32)),
                           {k: jnp.asarray(x) for k, x in b.items()},
                           jnp.asarray(small.numpy()))
    # the counts and the union against the reference; not the delta norms: a
    # dropped token's gradient goes to the last kept row in the port and
    # nowhere in the JAX package (ROADMAP Queue 3)
    want = jtel.telemetry_to_host(jm["telemetry"])
    for name in ("dropped_ids", "dropped_mass", "dropped_per_client", "union_size",
                 "agg_rows", "heat_hist", "density"):
        assert tel[name] == want[name], name


# ---------------------------------------------------------------------------
# the trainer: telemetry_log and telemetry_summary against the JAX trainer
# ---------------------------------------------------------------------------

DS_KW = dict(num_clients=40, num_items=40, mean_samples=15)


@pytest.fixture(scope="module")
def data():
    ref = j_movielens(**DS_KW)
    init = jax.tree.map(np.asarray, unbox(j_make_lr_params(ref.num_features,
                                                           rng=jax.random.PRNGKey(0))))
    return ref, make_movielens_like(**DS_KW), init


def _cfg(sparse=True, **kw):
    return dict(num_clients=40, clients_per_round=6, local_iters=3, local_batch=4,
                lr=0.5, algorithm="fedsubavg", sparse=sparse, **kw)


def _port_trainer(data, sparse=True, **kw):
    _, port, init = data
    return FederatedTrainer(port, functools.partial(params_from_jax, init), lr_loss,
                            FedConfig(**_cfg(sparse)), device="cpu", **kw)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("engine", [False, True], ids=["run", "run_engine"])
def test_trainer_telemetry_matches_jax(data, sparse, engine):
    ref = data[0]
    jt = JTrainer(ref, functools.partial(j_make_lr_params, ref.num_features), j_lr_loss,
                  JFedConfig(**_cfg(sparse)))
    tt = _port_trainer(data, sparse)
    jt.run(4, eval_every=2, engine=engine)
    tt.run(4, eval_every=2, engine=engine)
    assert len(tt.telemetry_log) == len(jt.telemetry_log) == 4
    for got, want in zip(tt.telemetry_log, jt.telemetry_log):
        assert_telemetry_close(got, want)
    ts, js = tt.telemetry_summary(), jt.telemetry_summary()
    assert set(ts) == set(js)
    for k, w in js.items():
        np.testing.assert_allclose(ts[k], w, err_msg=k, **TOL)
    assert [r.round for r in tt.history] == [r.round for r in jt.history]
    # telemetry off: the same losses and parameters, bit for bit
    off = _port_trainer(data, sparse, telemetry=False)
    on = _port_trainer(data, sparse)
    assert on.run_rounds(3) == off.run_rounds(3)
    assert all(torch.equal(on.state.params[k], off.state.params[k])
               for k in on.state.params)
    assert off.telemetry_log == [] and len(on.telemetry_log) == 3


def test_sink_jsonl_keys_match_jax(tmp_path, data):
    ref = data[0]
    paths = {p: str(tmp_path / f"{p}.jsonl") for p in ("jax", "port")}
    jt = JTrainer(ref, functools.partial(j_make_lr_params, ref.num_features), j_lr_loss,
                  JFedConfig(**_cfg()), sink=JTraceSink(paths["jax"]))
    tt = _port_trainer(data, sink=TraceSink(paths["port"]))
    jt.run(4, eval_every=2)
    tt.run(4, eval_every=2)
    jt.sink.close()
    tt.sink.close()
    got, want = read_events(paths["port"]), read_events(paths["jax"])
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert {e["event"] for e in got} == {"round", "record"}
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if g["event"] == "round":
            assert set(g["comm"]) == set(w["comm"])
            assert_telemetry_close(g, w)
    json.dumps(got)


def test_sink_is_json_safe_for_tensors(tmp_path):
    path = tmp_path / "trace.jsonl"
    with TraceSink(str(path)) as sink:
        sink.emit({"event": "round", "round": torch.tensor(3, dtype=torch.int32),
                   "loss": torch.tensor(0.25), "density": np.float64(0.5),
                   "union": np.asarray(7), "hist": torch.arange(3, dtype=torch.float32),
                   "nested": {"occupancy": torch.tensor(2)}})
    (event,) = read_events(str(path))
    assert event == {"event": "round", "round": 3, "loss": 0.25, "density": 0.5,
                     "union": 7, "hist": [0.0, 1.0, 2.0], "nested": {"occupancy": 2}}
    with pytest.raises(TypeError):
        with TraceSink(str(tmp_path / "bad.jsonl")) as sink:
            sink.emit({"obj": object()})


def test_phase_timer_splits_first_dispatches():
    t = PhaseTimer()
    t.add("round", 5.0, compile=True)
    t.add("round", 1.0)
    t.add("round", 3.0)
    assert t.mean("round") == pytest.approx(2.0)
    s = t.summary()["round"]
    assert s["compile_s"] == pytest.approx(5.0) and s["compile_count"] == 1
    assert s["count"] == 2 and s["total_s"] == pytest.approx(4.0)


def test_compile_time_on_first_dispatches_only(data):
    tr = _port_trainer(data)
    tr.run(4, eval_every=2)
    # a new pow2 capacity is a new dispatch key: record 2 books time iff it saw one
    keys = tr.timer.count("round", compile=True)
    assert tr.history[0].compile_time > 0
    assert (tr.history[1].compile_time > 0) == (keys > 1)
    assert all(r.wall_time > 0 for r in tr.history)
    seen = set(tr._dispatched_keys)
    tr.run(4, eval_every=2)
    new = len(tr._dispatched_keys - seen)
    assert sum(r.compile_time > 0 for r in tr.history[2:]) <= new
    records = [e for e in tr.sink.events if e["event"] == "record"]
    assert [r["round"] for r in records] == [2, 4, 6, 8]
    assert {"wall_time", "compile_time", "train_loss"} <= set(records[0])


def test_verbose_reports_through_logging(data, caplog):
    tr = _port_trainer(data)
    with caplog.at_level(logging.INFO, logger="repro_torch.telemetry"):
        tr.run(2, eval_every=2, verbose=True)
    msgs = [r.message for r in caplog.records if r.name == "repro_torch.telemetry"]
    assert any("[fedsubavg] round 2:" in m and "loss=" in m for m in msgs)


def test_profile_dir_writes_a_trace_with_round_ranges(tmp_path, data):
    pdir = tmp_path / "prof"
    tr = _port_trainer(data)
    tr.run(4, eval_every=2, profile_dir=str(pdir))
    files = glob.glob(os.path.join(str(pdir), "*.pt.trace.json"))
    assert len(files) == 1, files
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"rounds[0:2]", "rounds[2:4]"} <= names
    assert len(tr.history) == 2


def test_round_telemetry_field_names_match_jax():
    assert RoundTelemetry._fields == jtel.RoundTelemetry._fields
    assert (ttel.HEAT_BUCKETS, ttel.STALENESS_BUCKETS) == (jtel.HEAT_BUCKETS,
                                                          jtel.STALENESS_BUCKETS)
    from repro.federated.server import RoundRecord as JRecord
    from repro_torch.federated.server import RoundRecord
    assert ([f.name for f in dataclasses.fields(RoundRecord)]
            == [f.name for f in dataclasses.fields(JRecord)])
