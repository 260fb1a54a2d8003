"""Port parity, cohort-sharded rounds over ``torch.distributed``.

Case for case ``tests/test_shard_parity.py`` (every mode x ``correct``,
both combines, a cohort that does not divide, the flat path's refusals,
explicit flat ``sub_ids``, int8 and flat top-k refused, ``CohortSharding``
validation, the trainer's round loop, ``run_rounds``, dense and stateful
plans, mesh conflicts, debug checks) on gloo ranks spawned on the host
(``tests/torch_sharding_ranks.py``, one spawn of 2 ranks and one of 3 for
the whole matrix). The ranks' results are held to:

- the JAX package's single-device step and trainer (in this process):
  losses, parameters, optimizer slots and telemetry within 1e-5;
- the JAX package's sharded step at 2 shards, every field
  (``shard_union_sizes`` exactly), from one subprocess with two virtual CPU
  devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``);
- each other: every rank's state equals rank 0's bit for bit;
- ``round_collective_budget``: the mesh's collective counters equal its
  components on every rank, and the budget equals the JAX function's dict
  at 2 and 4 shards.

Run as a script (``--jax-sharded OUT``) this file is that subprocess.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.federated import CohortSharding as JCohortSharding
from repro.federated import FederatedTrainer as JTrainer
from repro.federated import make_round_step as j_make_round_step
from repro.federated import resolve_plan as j_resolve_plan
from repro.federated.plan import round_collective_budget as j_budget
from repro.data import make_movielens_like as j_movielens
from repro.models.recsys import lr_logits as j_lr_logits
from repro.models.recsys import lr_loss as j_lr_loss
from repro.models.recsys import lstm_loss as j_lstm_loss
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.models.recsys import make_lstm_params as j_make_lstm_params
from repro.sharding.logical import unbox
from repro.telemetry.round import telemetry_to_host as j_telemetry_to_host

import torch_sharding_ranks as ranks
from repro_torch.configs.base import FedConfig
from repro_torch.convert import _flatten, params_from_jax, server_state_from_jax
from repro_torch.federated import CohortSharding, make_cohort_mesh
from repro_torch.federated.arrivals import ArrivalSim
from repro_torch.federated.plan import (FedSgdLocal, RoundPlan, RowSparseTransport,
                                        ServerUpdate, SubmodelReplicatedLocal,
                                        resolve_plan, round_collective_budget)
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch.mesh import CohortMesh, spawn_ranks
from repro_torch.models.recsys import lstm_loss
from test_torch_telemetry import assert_telemetry_close

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ranks.MODES
SPAWN_TIMEOUT_S = 240.0


def _stand_in(size: int) -> CohortMesh:
    """A mesh object for what needs only its shape (no process group)."""
    return CohortMesh(rank=0, size=size, device=torch.device("cpu"))


def _jax_params():
    return j_make_lstm_params(ranks.V, emb_dim=ranks.E, hidden=8, layers=1,
                              rng=jax.random.PRNGKey(1))


def _np_tree(tree) -> dict:
    return _flatten(jax.tree.map(np.asarray, unbox(tree)))


def _jax_steps(mode, correct=True, k=3, mesh=None, combine="auto", rounds=3) -> dict:
    """The JAX package's make_round_step on the same batches (telemetry on:
    pure reads, the same losses and parameters as off)."""
    jp = _jax_params()
    fed = JFedConfig(num_clients=16, clients_per_round=k, local_iters=2, lr=0.1,
                     algorithm="fedsubavg")
    plan = j_resolve_plan(mode, fed, correct=correct)
    if mesh is not None:
        plan = dataclasses.replace(plan, sharding=JCohortSharding(mesh, combine=combine))
    step = jax.jit(j_make_round_step(j_lstm_loss, jp, fed, mode=plan, correct=correct,
                                     telemetry=True))
    out = {"loss": [], "sub_rows": [], "telemetry": []}
    for r in range(rounds):
        b = ranks.mode_batch(mode, 100 + r, k)
        jp, m = step(jp, {key: jnp.asarray(v) for key, v in b.items()})
        out["loss"].append(float(m["loss"]))
        if "sub_rows" in m:
            out["sub_rows"].append(int(m["sub_rows"]))
        out["telemetry"].append(j_telemetry_to_host(m["telemetry"]))
    out["params"] = _np_tree(jp)
    return out


def jax_sharded_main(out_path: str) -> None:
    """Subprocess body: the JAX package's sharded steps on two virtual CPU
    devices (``make_cohort_mesh()`` over both), pickled to ``out_path``."""
    from repro.launch.mesh import make_cohort_mesh as j_make_cohort_mesh
    mesh = j_make_cohort_mesh()
    assert mesh.shape["data"] == 2, mesh
    res = {f"{mode}/{correct}": _jax_steps(mode, correct, mesh=mesh)
           for mode in MODES for correct in (True, False)}
    for mode in ("sparse", "sparse_replicated"):
        for combine in ("psum", "union"):
            res[f"combine/{mode}/{combine}"] = _jax_steps(mode, mesh=mesh, combine=combine)
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the runs: one JAX subprocess, one spawn of 2 ranks and one of 3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    params, _ = params_from_jax(_np_tree(_jax_params()), device="cpu")
    np.savez(d / "params.npz", **{k: v.numpy() for k, v in params.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen([sys.executable, __file__, "--jax-sharded",
                                 str(d / "jax2.pkl")], env=env, cwd=str(ROOT),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for world in (2, 3):
            wd = d / f"world{world}"
            wd.mkdir()
            spawn_ranks(ranks.run_matrix, world,
                        args=(world, str(wd / "store"), str(wd), str(d / "params.npz"),
                              True), timeout_s=SPAWN_TIMEOUT_S)
            out[world] = [torch.load(wd / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
        log, _ = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-4000:]
    with open(d / "jax2.pkl", "rb") as fh:
        out["jax2"] = pickle.load(fh)
    return out


_JAX_SINGLE = {}


def jax_single(mode, correct=True, k=3) -> dict:
    """The JAX single-device step's run, computed once per case."""
    key = (mode, correct, k)
    if key not in _JAX_SINGLE:
        _JAX_SINGLE[key] = _jax_steps(mode, correct, k=k)
    return _JAX_SINGLE[key]


def _assert_params_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), err_msg=name,
                                   **(tol or TOL))


def _assert_run_close(got: dict, want: dict):
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert got["sub_rows"] == want["sub_rows"]           # density agrees exactly
    _assert_params_close(got["params"], want["params"])


def _assert_ranks_equal(results: list, key: str):
    """Every rank's parameters equal rank 0's bit for bit."""
    want = results[0][key]["params"]
    for r, res in enumerate(results[1:], 1):
        for name, w in want.items():
            assert torch.equal(res[key]["params"][name], w), (key, r, name)


#: telemetry a sharded round shares with the single-device one: the drop
#: counters, the union and its heat (a psum combine leaves no aggregated
#: RowSparse to size, and the flat path's norms are the aggregate's)
SINGLE_FIELDS = ("dropped_ids", "dropped_mass", "dropped_per_client", "union_size",
                 "heat_hist", "density")


def _single_fields(tel: dict, stacked: bool) -> dict:
    norms = ("delta_norm_pre", "delta_norm_post") if stacked else ()
    return {k: tel[k] for k in SINGLE_FIELDS + norms}


# ---------------------------------------------------------------------------
# the acceptance matrix: mode x algorithm, sharded against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "sparse_replicated", "replicated"])
@pytest.mark.parametrize("correct", [True, False])
def test_sharded_matches_single_device(runs, mode, correct):
    """Two ranks reproduce the JAX single-device step within 1e-5 over
    three rounds, sub_rows exactly; every rank holds the same state."""
    key = f"steps/{mode}/{correct}"
    _assert_run_close(runs[2][0][key], jax_single(mode, correct))
    _assert_ranks_equal(runs[2], key)


@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "sparse_replicated", "replicated"])
@pytest.mark.parametrize("correct", [True, False])
def test_sharded_matches_jax_sharded_step(runs, mode, correct):
    """Against the JAX sharded step at 2 shards: losses, sub_rows,
    parameters and every telemetry field, ``shard_union_sizes`` exactly;
    the fields a sharded round shares with the single-device one also
    against the single-device step's."""
    got, want = runs[2][0][f"tel/{mode}/{correct}"], runs["jax2"][f"{mode}/{correct}"]
    _assert_run_close(got, want)
    for g, w, single in zip(got["telemetry"], want["telemetry"],
                            jax_single(mode, correct)["telemetry"]):
        assert_telemetry_close(g, w)
        assert g["shard_union_sizes"] == w["shard_union_sizes"]
        assert_telemetry_close(_single_fields(g, mode not in ranks.FLAT_MODES),
                               _single_fields(single, mode not in ranks.FLAT_MODES))
    _assert_ranks_equal(runs[2], f"tel/{mode}/{correct}")


@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "sparse_replicated", "replicated"])
@pytest.mark.parametrize("correct", [True, False])
def test_telemetry_leaves_the_sharded_round_unchanged(runs, mode, correct):
    """Telemetry's extra collectives read only: on and off, the same
    losses and parameters bit for bit."""
    on, off = runs[2][0][f"tel/{mode}/{correct}"], runs[2][0][f"steps/{mode}/{correct}"]
    assert on["loss"] == off["loss"]
    for name, p in off["params"].items():
        assert torch.equal(on["params"][name], p), name


@pytest.mark.parametrize("combine", ["psum", "union"])
def test_both_combine_strategies_are_exact(runs, combine):
    """psum-densify and union-of-unions are the same math: both reproduce
    the single-device sparse_replicated round and the JAX sharded one."""
    got = runs[2][0][f"combine/sparse_replicated/{combine}"]
    _assert_run_close(got, jax_single("sparse_replicated"))
    _assert_run_close(got, runs["jax2"][f"combine/sparse_replicated/{combine}"])
    _assert_run_close(runs[2][0][f"combine/sparse/{combine}"],
                      runs["jax2"][f"combine/sparse/{combine}"])
    _assert_ranks_equal(runs[2], f"combine/sparse_replicated/{combine}")


@pytest.mark.parametrize("world", [2, 3])
def test_non_divisible_cohort_pads_and_masks(runs, world):
    """Five clients over 2 and 3 ranks: padded shard-major by cyclic
    repeats, masked out of every reduction, the mean kept at 1/5."""
    _assert_run_close(runs[world][0]["non_divisible"], jax_single("sparse_replicated", k=5))
    _assert_ranks_equal(runs[world], "non_divisible")


@pytest.mark.parametrize("combine", ["psum", "union"])
def test_three_ranks_agree_bit_for_bit(runs, combine):
    """Three ranks, a cohort of five: exact against the single-device step,
    and the union combine (up to three partial rows per id) leaves every
    rank with rank 0's state on the host."""
    _assert_run_close(runs[3][0][f"combine/{combine}"], jax_single("sparse_replicated", k=5))
    _assert_ranks_equal(runs[3], f"combine/{combine}")


def test_flat_batch_must_divide(runs):
    """Flat (pooled-batch) plans refuse a batch the mesh cannot split, on
    every rank alike, before any collective."""
    for res in runs[2]:
        assert "does not divide" in res["flat_must_divide"]


def test_flat_sparse_explicit_sub_ids_shards_exactly(runs):
    """A caller's flat union goes to every rank and reproduces the
    single-device step."""
    from repro.core.algorithms import ServerState as JServerState
    from repro.federated import build_round_step as j_build_round_step
    from repro.sparse.encode import batch_union_ids as j_batch_union_ids

    jp = _jax_params()
    fed = JFedConfig(num_clients=16, clients_per_round=3, lr=0.1, algorithm="fedsubavg")
    step = jax.jit(j_build_round_step(j_resolve_plan("sparse", fed), j_lstm_loss, jp, fed))
    batch = {k: jnp.asarray(v) for k, v in ranks.flat_batch(3).items()}
    st, m = step(JServerState(jp, (), 0), batch, j_batch_union_ids(batch, ("tokens",), 64))
    got = runs[2][0]["explicit_sub_ids"]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-6)
    assert got["sub_rows"] == int(m["sub_rows"])
    _assert_params_close(got["params"], _np_tree(st.params))
    _assert_ranks_equal(runs[2], "explicit_sub_ids")


def test_sharded_microbatch_divisibility_is_validated(runs):
    """Per-shard gradient accumulation needs B % (ranks * microbatches) ==
    0; every rank raises a ValueError before any collective."""
    for res in runs[2]:
        assert "microbatches" in res["microbatches"]


def test_sharding_rejects_int8_and_flat_topk():
    params, axes = params_from_jax(_np_tree(_jax_params()), device="cpu")
    fed = FedConfig(num_clients=16, lr=0.1, algorithm="fedsubavg")
    sh = CohortSharding(_stand_in(2))
    bad_int8 = RoundPlan(FedSgdLocal(), RowSparseTransport(int8=True),
                         ServerUpdate("fedsubavg"), sharding=sh)
    with pytest.raises(ValueError, match="int8"):
        make_round_step(lstm_loss, params, axes, fed, mode=bad_int8)
    bad_topk = RoundPlan(FedSgdLocal(), RowSparseTransport(topk=4),
                         ServerUpdate("fedsubavg"), sharding=sh)
    with pytest.raises(ValueError, match="top-k"):
        make_round_step(lstm_loss, params, axes, fed, mode=bad_topk)


def test_cohort_sharding_validation():
    mesh = _stand_in(2)
    with pytest.raises(ValueError, match="axis"):
        CohortSharding(mesh, axis="model")
    with pytest.raises(ValueError, match="combine"):
        CohortSharding(mesh, combine="allgather")
    assert CohortSharding(mesh).num_shards == 2
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 2}


def test_sharded_debug_checks_parity(runs):
    """With debug checks on, the sharded round is bit-identical to checks
    off (eight clients over two ranks)."""
    for res in runs[2]:
        plain, checked = res["debug/plain"], res["debug/checked"]
        assert plain["loss"] == checked["loss"]
        for name, p in plain["params"].items():
            assert torch.equal(checked["params"][name], p), name


# ---------------------------------------------------------------------------
# collectives: the mesh's counters and the budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("combine", ["psum", "union"])
def test_collective_counters_equal_budget(runs, mode, combine):
    """Every rank's counted collectives (kind and payload bytes per
    component) equal ``round_collective_budget`` exactly, every step: a
    densified union combine or an extra gather fails here."""
    for world in (2, 3):
        keys = ([f"steps/{mode}/True", f"steps/{mode}/False", f"combine/{mode}/{combine}"]
                if world == 2 else [f"combine/{combine}", "non_divisible"])
        if world == 3 and mode != "sparse_replicated":
            continue
        for res in runs[world]:
            for key in keys:
                assert res[key]["counters_equal_budget"] == [True] * 3, (
                    world, key, res[key]["counters"][-1], res[key]["budget"][-1])
    comps = runs[2][0][f"combine/{mode}/{combine}"]["counters"][-1]
    if mode in ("sparse", "sparse_replicated"):
        op = "all-reduce" if combine == "psum" else "all-gather"
        assert comps["combine:embedding"]["op"] == op


@pytest.mark.parametrize("mode", ["sparse", "sparse_replicated"])
@pytest.mark.parametrize("combine", ["psum", "union"])
def test_comm_drift_holds_on_sharded_plans(runs, mode, combine):
    """``hlo_audit.comm_drift``: every step's counted bytes by collective
    kind equal ``sharded_combine_bytes`` of ``plan_comm_meta`` within 10%
    plus 64 B (the reference's tolerance), at 2 and 3 ranks, and the
    combine's own kind was priced and moved."""
    for world in (2, 3):
        keys = ([f"steps/{mode}/True", f"steps/{mode}/False", f"combine/{mode}/{combine}"]
                if world == 2 else [f"combine/{combine}", "non_divisible"])
        if world == 3 and mode != "sparse_replicated":
            continue
        for res in runs[world]:
            for key in keys:
                assert len(res[key]["drift"]) == 3, (world, key)
                for d in res[key]["drift"]:
                    assert d["ok"], (world, key, d["failures"])
    d = runs[2][0][f"combine/{mode}/{combine}"]["drift"][-1]
    dominant = "all-reduce" if combine == "psum" else "all-gather"
    assert d["predicted_by_op"][dominant] > 0 and d["measured_by_op"][dominant] > 0


def _budget_batch(mode: str, shards: int) -> dict:
    return ranks.mode_batch(mode, 7, k=shards + 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("combine", ["auto", "psum", "union"])
@pytest.mark.parametrize("shards", [2, 4])
def test_round_collective_budget_matches_jax(mode, combine, shards):
    """The port's budget equals the JAX function's dict (a stand-in mesh
    gives the JAX function any shard count: it reads only the mesh's axes
    and shape)."""
    jp = _jax_params()
    params, axes = params_from_jax(_np_tree(jp), device="cpu")
    batch = _budget_batch(mode, shards)
    fed = FedConfig(num_clients=16, clients_per_round=shards + 1, lr=0.1)
    jfed = JFedConfig(num_clients=16, clients_per_round=shards + 1, lr=0.1)
    plan = dataclasses.replace(resolve_plan(mode, fed),
                               sharding=CohortSharding(_stand_in(shards), combine=combine))
    j_mesh = SimpleNamespace(axis_names=("data",), shape={"data": shards})
    jplan = dataclasses.replace(j_resolve_plan(mode, jfed),
                                sharding=JCohortSharding(j_mesh, combine=combine))
    got = round_collective_budget(plan, axes, params, fed,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    want = j_budget(jplan, jp, jfed, batch)
    assert got == want


@pytest.mark.parametrize("combine", ["psum", "union"])
def test_round_collective_budget_with_sub_ids_matches_jax(combine):
    """With the trainer's explicit per-client sub_ids, on LR."""
    jp = j_make_lr_params(96)
    params, axes = params_from_jax(_np_tree(jp), device="cpu")
    batch = {"features": np.zeros((5, 2, 3, 4), np.int32),
             "label": np.zeros((5, 2, 3), np.int32)}
    sub_ids = np.zeros((5, 32), np.int32)
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                     ServerUpdate("fedsubavg"), feature_keys=("features",),
                     sharding=CohortSharding(_stand_in(2), combine=combine))
    jplan = dataclasses.replace(
        j_resolve_plan("sparse_replicated", JFedConfig(), feature_key="features"),
        sharding=JCohortSharding(SimpleNamespace(axis_names=("data",),
                                                 shape={"data": 2}), combine=combine))
    got = round_collective_budget(plan, axes, params, FedConfig(),
                                  {k: torch.from_numpy(v) for k, v in batch.items()},
                                  sub_ids=torch.from_numpy(sub_ids))
    assert got == j_budget(jplan, jp, JFedConfig(), batch, sub_ids=sub_ids)


# ---------------------------------------------------------------------------
# FederatedTrainer(mesh=...)
# ---------------------------------------------------------------------------


def _jax_trainer(clients_per_round: int = 5, **kw):
    ds = j_movielens(num_clients=40, num_items=40, mean_samples=15)
    cfg = JFedConfig(num_clients=ds.num_clients, clients_per_round=clients_per_round,
                     local_iters=3, local_batch=4, lr=0.5,
                     algorithm=kw.pop("algorithm", "fedsubavg"), **kw)
    return JTrainer(ds, lambda rng: j_make_lr_params(ds.num_features, rng=rng), j_lr_loss,
                    cfg, predict_fn=lambda p, t: j_lr_logits(p, jnp.asarray(t["features"])),
                    metric="auc")


def _assert_trainer_close(got: dict, jt):
    state = server_state_from_jax(_np_tree(jt.state.params),
                                  jax.tree.map(np.asarray, unbox(jt.state.opt)),
                                  jt.state.rounds, device="cpu")
    _assert_params_close(got["params"], state.params)
    slots_got = (got["opt"],) if isinstance(got["opt"], dict) else got["opt"]
    slots_want = (state.opt,) if isinstance(state.opt, dict) else state.opt
    assert len(slots_got) == len(slots_want)
    for g, w in zip(slots_got, slots_want):
        _assert_params_close(g, w)


@pytest.mark.parametrize("world", [2, 3])
def test_trainer_mesh_round_loop_parity(runs, world):
    """Same numpy stream, round by round: losses, parameters, comm bytes
    and telemetry against the JAX trainer (five clients over 2 and 3 ranks:
    the non-divisible trainer case)."""
    jt = _jax_trainer(sparse=True)
    want = [jt.run_round() for _ in range(4)]
    got = runs[world][0]["trainer/sparse"]
    np.testing.assert_allclose(got["loss"], want, **TOL)
    _assert_trainer_close(got, jt)
    assert got["comm"]["bytes_up_sparse"] == pytest.approx(
        jt.comm_summary()["bytes_up_sparse"])
    for g, w in zip(got["telemetry"], jt.telemetry_log):
        assert len(g["shard_union_sizes"]) == world
        assert_telemetry_close(_single_fields(g, True), _single_fields(w, True))
    np.testing.assert_allclose(got["auc"], jt.evaluate(), **TOL)
    _assert_ranks_equal(runs[world], "trainer/sparse")


@pytest.mark.parametrize("world", [2, 3])
def test_trainer_mesh_run_rounds_engine_parity(runs, world):
    """``run_rounds`` runs sharded too: the JAX trainer's scan engine's losses."""
    jt = _jax_trainer(sparse=True)
    want = jt.run_rounds(4)
    got = runs[world][0]["trainer/engine"]
    np.testing.assert_allclose(got["loss"], want, **TOL)
    _assert_params_close(got["params"], _np_tree(jt.state.params))
    _assert_ranks_equal(runs[world], "trainer/engine")


@pytest.mark.parametrize("label", ["dense", "fedadam", "scaffold"])
def test_trainer_mesh_dense_and_stateful(runs, label):
    """Dense plans and stateful server optimizers shard alike: losses,
    parameters and optimizer slots against the JAX trainer."""
    jt = _jax_trainer(**ranks.TRAINER_CASES[label])
    want = [jt.run_round() for _ in range(3)]
    for world in (2, 3):
        got = runs[world][0][f"trainer/{label}"]
        np.testing.assert_allclose(got["loss"], want, **TOL)
        _assert_trainer_close(got, jt)
        _assert_ranks_equal(runs[world], f"trainer/{label}")


def _port_trainer(**kw):
    return ranks.make_trainer(ranks.trainer_data(), **kw)


def test_trainer_mesh_conflicts_rejected():
    """Refused before any collective: central training with a mesh, and a
    plan whose CohortSharding names another mesh."""
    with pytest.raises(ValueError, match="central"):
        _port_trainer(mesh=_stand_in(2), algorithm="central")
    mesh, other = _stand_in(2), _stand_in(2)
    ds = ranks.trainer_data()
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.models.recsys import lr_loss, make_lr_params
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                     ServerUpdate("fedsubavg"), sharding=CohortSharding(other))
    with pytest.raises(ValueError, match="conflicts"):
        FederatedTrainer(ds, lambda device: make_lr_params(ds.num_features, device=device),
                         lr_loss, FedConfig(num_clients=ds.num_clients, sparse=True),
                         plan=plan, device="cpu", mesh=mesh)


def test_trainer_mesh_refuses_async_and_writes_on_rank_zero_only(tmp_path):
    """The buffered-async engine does not run on a mesh; a rank other than
    0 closes the sink's file and keeps its events in memory."""
    from repro_torch.telemetry import TraceSink
    tr = _port_trainer(mesh=_stand_in(2), sparse=True)
    assert tr.plan.sharding.num_shards == 2 and tr.writes_files
    with pytest.raises(ValueError, match="CohortSharding"):
        tr.run_async(ArrivalSim(num_rounds=2))
    sink = TraceSink(tmp_path / "trace.jsonl")
    other = CohortMesh(rank=1, size=2, device=torch.device("cpu"))
    tr = ranks.make_trainer(ranks.trainer_data(), mesh=other, sparse=True)
    assert not tr.writes_files
    tr2 = FederatedTrainerWithSink = None  # noqa: F841
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.models.recsys import lr_loss, make_lr_params
    ds = ranks.trainer_data()
    tr2 = FederatedTrainer(ds, lambda device: make_lr_params(ds.num_features, device=device),
                           lr_loss, FedConfig(num_clients=ds.num_clients, sparse=True),
                           device="cpu", mesh=other, sink=sink)
    assert not tr2.writes_files and sink._fh is None
    sink.emit({"event": "x"})
    assert sink.events == [{"event": "x"}]
    assert (tmp_path / "trace.jsonl").read_text() == ""


# ---------------------------------------------------------------------------
# the mesh and its spawner
# ---------------------------------------------------------------------------


def test_make_cohort_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_cohort_mesh()


def test_stuck_collective_fails_within_join_timeout(tmp_path):
    """A rank waiting in a collective that another rank never joins fails
    the spawn at its join timeout instead of hanging it."""
    with pytest.raises(TimeoutError):
        spawn_ranks(ranks.stuck_rank, 2, args=(2, str(tmp_path / "store")), timeout_s=8.0)


def test_failed_rank_fails_the_spawn(tmp_path):
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        spawn_ranks(ranks.failing_rank, 2, args=(2, str(tmp_path / "store")),
                    timeout_s=SPAWN_TIMEOUT_S)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-sharded"]:
        jax_sharded_main(sys.argv[2])
