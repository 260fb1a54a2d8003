"""Port parity, the row-sparse transport on a vocabulary split over
``model``: FedSGD rounds on ``(data, model)`` meshes of gloo ranks whose
embedding rows are split, each rank gathering, correcting and combining
only its slice of the table.

One spawn of 4 gloo ranks on the host (``tests/torch_sparse_tp_ranks.py``)
trains the tiny models of ``repro_torch.launch.train.SCALES`` for two rounds
with telemetry on: Qwen2.5 through ``train(mesh=..., sparse=True)`` on
``(1, 2)``, ``(2, 2)`` and ``(1, 4)``, Mixtral expert parallel on ``(1, 2)``,
Qwen2.5 on ``(2, 2)`` through ``make_round_step`` with each combine forced
(at these widths ``auto`` picks ``psum``; ``union``, K1's path, must be
asked for), a vocabulary the model axis does not divide (the table whole on
every rank), and the dense transport for its telemetry.
Beside it two JAX subprocesses (``XLA_FLAGS=
--xla_force_host_platform_device_count=4``) run the JAX package's sparse
step (``examples/federated_llm.py``'s plan) under ``make_rules("train")``
on Auto-typed meshes, and its cohort-sharded step (``CohortSharding`` over
a ``data`` mesh) whose telemetry the port's sharded step reports. The
ranks' results are held within 1e-5 to:

- the JAX package's step on the same mesh: losses, every parameter after
  each round, ``sub_rows``, ``density``, the uplink bytes and the
  telemetry a sharded round shares with one device;
- the JAX package's sharded step over the same ``data`` ranks: every
  telemetry field (the norms are the aggregate's there);
- the port on one device: losses, parameters, ``sub_rows`` and uplink;
- each other: whole leaves bit-identical on every rank after each round;
- ``tp_collective_budget(sparse=True)``: the counters of every round.

Plus the parts on the CPU alone: ``submodel_value_and_grad`` on a split
table against the unsplit one, K1's plain version on a slice against the
global aggregate restricted to it, the refusals raised before any
collective, split parameters in storage of their own.

Run as a script (``--jax-sparse OUT CASES``) this file is one of those
subprocesses.
"""
import math
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

from repro.configs import get_config as j_get_config
from repro.launch.train import SCALES as J_SCALES
from repro.models import build_model as j_build_model
from repro.sharding.logical import unbox

import torch_sparse_tp_ranks as ranks
from repro_torch.configs.base import get_config
from repro_torch.convert import _flatten
from repro_torch.federated.plan import tp_collective_budget
from repro_torch.kernels.union_segsum import union_segsum_torch
from repro_torch.launch.mesh import CohortMesh, DeviceMesh, spawn_ranks
from repro_torch.launch.shardings import shard_params
from repro_torch.launch.train import SCALES, mesh_rules, train
from repro_torch.models.api import build_model
from repro_torch.models.transformer import train_params, unstack_layers
from repro_torch.sharding import clear_rules, complete_rules, make_rules, set_rules
from repro_torch.sparse.aggregate import aggregate_rowsparse, pick_combine
from repro_torch.sparse.comm import model_comm_meta, sharded_combine_bytes
from repro_torch.sparse.encode import slice_rows, submodel_value_and_grad
from repro_torch.sparse.rowsparse import RowSparse

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT_S = 240.0
#: the JAX package's runs: model, mesh (a (data, model) shape under the
#: rules, ("data", n) for the cohort-sharded step, None for one device),
#: expert_parallel, transport, combine
JAX_CASES = {
    "qwen_1x2": ("qwen", (1, 2), False, "sparse", None),
    "qwen_2x2": ("qwen", (2, 2), False, "sparse", None),
    "qwen_1x4": ("qwen", (1, 4), False, "sparse", None),
    "mixtral_ep_1x2": ("mixtral", (1, 2), True, "sparse", None),
    "qwen_dense_2x2": ("qwen", (2, 2), False, "dense", None),
    "odd": ("odd", None, False, "sparse", None),
    "sharded_qwen_1": ("qwen", ("data", 1), False, "sparse", "auto"),
    "sharded_qwen_2_psum": ("qwen", ("data", 2), False, "sparse", "psum"),
    "sharded_qwen_2_union": ("qwen", ("data", 2), False, "sparse", "union"),
}
#: the JAX cases of each subprocess (four run side by side; a compile
#: takes ~8 s on one core)
JAX_SPLIT = (("qwen_2x2", "qwen_1x4"), ("qwen_1x2", "mixtral_ep_1x2"),
             ("qwen_dense_2x2", "odd"),
             ("sharded_qwen_1", "sharded_qwen_2_psum", "sharded_qwen_2_union"))
#: port case -> the JAX step on its mesh, and the JAX sharded step over its
#: data ranks (Qwen2.5's sparse cases; the dense transport's norms are the
#: step's own, one device's)
ORACLES = {
    "qwen_1x2": ("qwen_1x2", "sharded_qwen_1"),
    "qwen_2x2": ("qwen_2x2", "sharded_qwen_2_psum"),
    "qwen_1x4": ("qwen_1x4", "sharded_qwen_1"),
    "mixtral_ep_1x2": ("mixtral_ep_1x2", None),
    "qwen_2x2_psum": ("qwen_2x2", "sharded_qwen_2_psum"),
    "qwen_2x2_union": ("qwen_2x2", "sharded_qwen_2_union"),
    "odd_1x4": ("odd", None),
    "qwen_dense_2x2": ("qwen_dense_2x2", None),
}
CASES = list(ranks.CASES)
SPARSE_CASES = [c for c in CASES if ranks.CASES[c][5] == "sparse"]
#: telemetry a sharded round shares with the single-device one (the drop
#: counters, the union and its heat); the norms, ``agg_rows`` and
#: ``shard_union_sizes`` are the sharded step's own
SINGLE_FIELDS = ("dropped_ids", "dropped_mass", "dropped_per_client", "union_size",
                 "heat_hist", "density")
EXACT_FIELDS = ("dropped_ids", "dropped_per_client", "union_size", "agg_rows",
                "heat_hist", "shard_union_sizes")


def _jax_tiny(model: str):
    cfg = j_get_config(ranks.ARCH[model]).replace(**J_SCALES["tiny"])
    return cfg.replace(vocab_size=ranks.ODD_VOCAB) if model == "odd" else cfg


def _np_flat(tree) -> dict:
    return _flatten(jax.tree.map(np.asarray, unbox(tree)))


def jax_sparse_run(model: str, mesh_shape, expert_parallel: bool, transport: str,
                   combine) -> dict:
    """``examples/federated_llm.py``'s plan (``FedSgdLocal``, the given
    transport, fedsubavg) in the reference launcher's loop with telemetry:
    under ``make_rules("train")`` (completed as the dry run completes them)
    on an Auto-typed ``(data, model)`` mesh, cohort-sharded over a ``data``
    mesh, or on one device."""
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import FedConfig
    from repro.data import make_lm_federated
    from repro.federated import CohortSharding, make_round_step
    from repro.federated.plan import (DenseTransport, FedSgdLocal, RoundPlan,
                                      RowSparseTransport, ServerUpdate, plan_comm_meta)
    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set
    from repro.sharding.rules import make_rules as j_make_rules
    from repro.telemetry.round import telemetry_to_host

    cfg = _jax_tiny(model)
    run = ranks.RUN
    sparse = transport == "sparse"
    plan = RoundPlan(FedSgdLocal(), RowSparseTransport() if sparse else DenseTransport(),
                     ServerUpdate(run["algorithm"]))
    mesh = None
    if mesh_shape is not None and mesh_shape[0] == "data":
        mesh = jax.make_mesh((mesh_shape[1],), ("data",), axis_types=(AxisType.Auto,),
                             devices=jax.devices()[:mesh_shape[1]])
        plan = dataclasses.replace(plan, sharding=CohortSharding(mesh, combine=combine))
    elif mesh_shape is not None:
        mesh = jax.make_mesh(mesh_shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:math.prod(mesh_shape)])
        m = mesh_shape[1]
        j_set(mesh, dict(j_make_rules("train", expert_parallel=expert_parallel),
                         heads_act=("model",) if cfg.num_heads % m == 0 else None,
                         kv_act=("model",) if (cfg.num_kv_heads % m == 0
                                               and cfg.num_heads % m == 0) else None))
    try:
        api = j_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        ds = make_lm_federated(num_clients=run["clients"], vocab=cfg.vocab_size,
                               seq_len=run["seq"], samples_per_client=4)
        fed = FedConfig(num_clients=ds.num_clients, clients_per_round=run["cohort"],
                        lr=run["lr"], algorithm=run["algorithm"])
        step = jax.jit(make_round_step(api.loss, params, fed, mode=plan, telemetry=True))
        meta = plan_comm_meta(params)
        heat = jnp.asarray(ds.heat.counts, jnp.float32)
        rng = np.random.default_rng(0)
        out = {"losses": [], "rounds": [], "per_round": [], "bytes_up": []}
        ctx = jax.set_mesh(mesh) if mesh is not None else _null()
        with ctx:
            for r in range(run["rounds"]):
                ids = rng.choice(ds.num_clients, size=run["cohort"], replace=False)
                sample = rng.integers(0, ds.client_data["tokens"].shape[1], run["cohort"])
                toks = ds.client_data["tokens"][ids, sample]
                params, metrics = step(params, {"tokens": jnp.asarray(toks),
                                                "heat_vocab": heat})
                got = {"loss": float(metrics["loss"]),
                       "telemetry": telemetry_to_host(metrics["telemetry"])}
                if sparse:
                    got.update(sub_rows=int(metrics["sub_rows"]),
                               density=float(metrics["density"]))
                    out["bytes_up"].append(plan.transport.round_comm(
                        r, meta, np.asarray([got["sub_rows"]]),
                        cfg.vocab_size).bytes_up_sparse)
                out["losses"].append(got["loss"])
                out["rounds"].append(got)
                out["per_round"].append(unstack_layers(_np_flat(params)))
    finally:
        j_clear()
    return out


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def jax_sparse_main(out_path: str, names: str) -> None:
    """Subprocess body: the JAX cases named (comma-separated), pickled to
    ``out_path``."""
    assert len(jax.devices()) == 4, jax.devices()
    res = {name: jax_sparse_run(*JAX_CASES[name]) for name in names.split(",")}
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the runs: two JAX subprocesses beside one spawn of 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse_tp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "--jax-sparse",
                               str(d / f"jax{i}.pkl"), ",".join(names)], env=env,
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i, names in enumerate(JAX_SPLIT)]
    try:
        for model in ranks.ARCH:
            np.savez(d / f"{model}.npz",
                     **_np_flat(j_build_model(_jax_tiny(model)).init(jax.random.PRNGKey(0))))
        spawn_ranks(ranks.run_cases, ranks.WORLD, args=(str(d / "store"), str(d), str(d)),
                    timeout_s=SPAWN_TIMEOUT_S)
        out = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(ranks.WORLD)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    jres = {}
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-4000:]
        with open(d / f"jax{i}.pkl", "rb") as fh:
            jres.update(pickle.load(fh))
    return SimpleNamespace(ranks=out, jax=jres)


def _single(runs, case):
    model, transport = ranks.CASES[case][0], ranks.CASES[case][5]
    return runs.ranks[0][f"single/{model}/{transport}"]


def _assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), err_msg=name, **TOL)


def _assert_telemetry_close(got: dict, want: dict, fields):
    for name in fields:
        g, w = got[name], want[name]
        if w is None:
            assert g is None, name
        elif name in EXACT_FIELDS:
            assert g == w, (name, g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_split_round_matches_jax_step(runs, case):
    """Losses and every parameter after each round, ``sub_rows``,
    ``density``, the uplink bytes and the telemetry a sharded round
    shares with one device, on every rank, against the JAX package's step
    on the same mesh."""
    want = runs.jax[ORACLES[case][0]]
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        np.testing.assert_allclose(res["losses"], want["losses"], **TOL)
        for got_p, want_p in zip(res["per_round"], want["per_round"], strict=True):
            _assert_params_close(got_p, want_p)
        for got, w in zip(res["rounds"], want["rounds"], strict=True):
            assert got.get("sub_rows") == w.get("sub_rows")
            if "density" in w:
                np.testing.assert_allclose(got["density"], w["density"], **TOL)
            fields = SINGLE_FIELDS + (("delta_norm_pre", "delta_norm_post")
                                      if ranks.CASES[case][5] == "dense" else ())
            _assert_telemetry_close(got["telemetry"], w["telemetry"], fields)
        if res["bytes_up"] is not None:
            assert res["bytes_up"] == want["bytes_up"]


@pytest.mark.parametrize("case", [c for c in CASES if ORACLES[c][1]])
def test_split_telemetry_matches_jax_sharded_step(runs, case):
    """Every telemetry field against the JAX package's cohort-sharded step
    over the same data ranks: the aggregate's norms summed over the model
    axis, the heat histogram summed over the slices, ``agg_rows`` under
    the union combine, ``shard_union_sizes`` per data rank."""
    want = runs.jax[ORACLES[case][1]]
    for r in range(ranks.WORLD):
        for got, w in zip(runs.ranks[r][case]["rounds"], want["rounds"], strict=True):
            assert set(got["telemetry"]) == set(w["telemetry"])
            _assert_telemetry_close(got["telemetry"], w["telemetry"], tuple(w["telemetry"]))


@pytest.mark.parametrize("case", CASES)
def test_split_round_matches_single_device(runs, case):
    single = _single(runs, case)
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        np.testing.assert_allclose(res["losses"], single["losses"], **TOL)
        for got_p, want_p in zip(res["per_round"], single["per_round"], strict=True):
            _assert_params_close(got_p, want_p)
        assert ([g.get("sub_rows") for g in res["rounds"]]
                == [w.get("sub_rows") for w in single["rounds"]])
        if res["bytes_up"] is not None:
            assert res["bytes_up"] == single["bytes_up"]


@pytest.mark.parametrize("case", CASES)
def test_whole_leaves_are_bit_identical_on_every_rank(runs, case):
    """After each round every leaf the rules leave whole has the same bits
    on every rank of the mesh; a split leaf the same on the ranks of its
    model coordinate."""
    by_rank = [runs.ranks[r][case] for r in range(ranks.WORLD)]
    for r, res in enumerate(by_rank):
        lead = by_rank[res["mesh_ranks"][0]]
        assert len(res["whole"]) == ranks.ROUNDS
        for rnd, leaves in enumerate(res["whole"]):
            assert set(leaves) == set(lead["whole"][rnd])
            for name, t in leaves.items():
                assert torch.equal(t, lead["whole"][rnd][name]), (r, rnd, name)
        for other in by_rank:
            if other["mesh_ranks"] == res["mesh_ranks"] and other["coords"][1] == res["coords"][1]:
                for name in res["split_leaves"]:
                    assert torch.equal(other["local"][name], res["local"][name]), (r, name)


@pytest.mark.parametrize("case", CASES)
def test_counters_equal_tp_collective_budget(runs, case):
    """The step's collectives every round, per axis and tag, equal
    ``tp_collective_budget``; telemetry's own are the ones named."""
    model, shape, _, _, combine, transport = ranks.CASES[case]
    split_table = model != "odd" and shape[1] > 1
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        assert len(res["counters"]) == ranks.ROUNDS
        for counted in res["counters"]:
            assert counted == res["budget"], (r, counted, res["budget"])
        model_tags = res["budget"]["model"]
        assert ("sub_rows:embedding" in model_tags) == (split_table and transport == "sparse")
        assert "embed" not in model_tags or transport == "dense"
        want_tel = {"model/telemetry:norms"}
        if transport == "sparse":
            want_tel.add("data/telemetry:ids")
            if split_table:
                want_tel.add("model/telemetry:hist")
                if combine == "union":
                    want_tel.add("model/telemetry:rows")
        assert set(res["telemetry_tags"]) == want_tel, res["telemetry_tags"]


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_k1_runs_on_each_rank_slice_under_union(runs, case):
    """Under ``union`` K1 folds the data ranks' slices once a round on
    every rank, at the slice's rows (V/m); under ``psum`` and on one
    device the flat path calls it never."""
    model, shape, _, _, combine, _ = ranks.CASES[case]
    assert _single(runs, case)["k1"] == []
    cfg = ranks.tiny_config(model)
    rows = cfg.vocab_size // shape[1] if model != "odd" else cfg.vocab_size
    for r in range(ranks.WORLD):
        calls = runs.ranks[r][case]["k1"]
        if combine != "union":
            assert calls == []
            continue
        assert len(calls) == ranks.ROUNDS
        for ids_shape, rows_shape, num_rows in calls:
            assert num_rows == rows
            assert rows_shape == ids_shape + (cfg.d_model,)


def test_a_vocabulary_the_model_axis_does_not_divide_stays_whole(runs):
    for r in range(ranks.WORLD):
        res = runs.ranks[r]["odd_1x4"]
        assert "embedding" not in res["split_leaves"] and "lm_head" not in res["split_leaves"]
        assert res["local"]["embedding"].shape[0] == ranks.ODD_VOCAB
        assert any("layers.0" in n for n in res["split_leaves"])


def test_dense_transport_telemetry_is_the_global_norm(runs):
    """The dense transport's telemetry on a model split is the norm of the
    whole update (each split leaf's squares summed over the model axis),
    as the JAX package's step gives it, not the norm of the rank's part."""
    want = runs.jax["qwen_dense_2x2"]["rounds"]
    for r in range(ranks.WORLD):
        for got, w in zip(runs.ranks[r]["qwen_dense_2x2"]["rounds"], want, strict=True):
            for name in ("delta_norm_pre", "delta_norm_post"):
                np.testing.assert_allclose(got["telemetry"][name], w["telemetry"][name],
                                           err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# the parts on the CPU alone
# ---------------------------------------------------------------------------


def _stand_in_mesh(shape, rank: int = 0) -> DeviceMesh:
    """A DeviceMesh whose axes have no process group: any collective on it
    raises."""
    names = ("data", "model")
    mesh = DeviceMesh(names, tuple(shape), tuple(range(math.prod(shape))), rank,
                      torch.device("cpu"))
    coords = dict(zip(names, mesh.coords))
    mesh.axes = {n: CohortMesh(rank=coords[n], size=s, device=torch.device("cpu"), axis=n)
                 for n, s in zip(names, shape)}
    return mesh


class _Gathered(Exception):
    pass


class _ModelAxis:
    """A model axis of ``size`` ranks in one process: ``psum`` records the
    rank's term and stops (``collect``), or returns the sum of the terms
    recorded (``reduce``)."""

    def __init__(self, rank, size, terms, collect):
        self.rank, self.size, self.terms, self.collect = rank, size, terms, collect

    def psum(self, x, tag):
        assert tag == "sub_rows:emb"
        if self.collect:
            self.terms[self.rank] = x
            raise _Gathered
        return sum(self.terms.values())


def _toy():
    rng = np.random.default_rng(7)
    v, d = 64, 8
    params = {"emb": torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)),
              "w": torch.from_numpy(rng.standard_normal((d, 3)).astype(np.float32))}
    tokens = torch.from_numpy(rng.integers(0, v, (5, 7)))

    def loss_fn(p, b):
        return torch.tanh(p["emb"][b["tokens"]] @ p["w"]).square().mean()

    ids = torch.unique(tokens).to(torch.int32)
    ids = torch.cat([ids, torch.full((40 - ids.numel(),), -1, dtype=torch.int32)])
    return params, {"tokens": tokens}, loss_fn, ids


@pytest.mark.parametrize("m", [2, 4])
def test_submodel_grad_on_a_split_table_is_the_slice_of_the_unsplit_one(m):
    params, batch, loss_fn, ids = _toy()
    loss, grads = submodel_value_and_grad(loss_fn, params, batch, "emb", ("tokens",), ids)
    whole = grads["emb"]
    v = params["emb"].shape[0]
    n = v // m
    terms: dict = {}
    for r in range(m):
        part = dict(params, emb=params["emb"][r * n:(r + 1) * n].clone())
        with pytest.raises(_Gathered):
            submodel_value_and_grad(loss_fn, part, batch, "emb", ("tokens",), ids,
                                    split=_ModelAxis(r, m, terms, collect=True))
    seen = torch.zeros(v, dtype=torch.bool)
    for r in range(m):
        part = dict(params, emb=params["emb"][r * n:(r + 1) * n].clone())
        l_r, g_r = submodel_value_and_grad(loss_fn, part, batch, "emb", ("tokens",), ids,
                                           split=_ModelAxis(r, m, terms, collect=False))
        assert torch.equal(l_r, loss)
        assert torch.equal(g_r["w"], grads["w"])
        rs = g_r["emb"]
        assert rs.num_rows == n and rs.capacity == ids.shape[0]
        valid = rs.ids >= 0
        # slice-local ids, sorted, the -1 pads trailing
        assert torch.equal(valid, torch.arange(rs.capacity) < int(valid.sum()))
        glob = rs.ids[valid].long() + r * n
        assert torch.all((glob >= r * n) & (glob < (r + 1) * n))
        assert torch.all(glob[1:] > glob[:-1])
        want = whole.rows[torch.searchsorted(whole.ids[whole.ids >= 0].long(), glob)]
        assert torch.equal(rs.rows[valid], want)
        assert torch.all(rs.rows[~valid] == 0)
        seen[glob] = True
    assert torch.equal(seen.nonzero()[:, 0], whole.ids[whole.ids >= 0].long())


def test_slice_rows_keeps_the_rows_of_its_slice():
    rs = RowSparse(torch.tensor([1, 5, 6, 9, 12, -1, -1], dtype=torch.int32),
                   torch.arange(14, dtype=torch.float32).reshape(7, 2), 16)
    got = slice_rows(rs, 4, 8)
    assert got.ids.tolist() == [1, 2, 5, -1, -1, -1, -1] and got.num_rows == 8
    assert got.rows[:3].tolist() == [[2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert torch.all(got.rows[3:] == 0)
    assert slice_rows(rs, 12, 4).ids.tolist() == [0] + [-1] * 6
    assert slice_rows(rs, 13, 3).ids.tolist() == [-1] * 7


@pytest.mark.parametrize("m", [2, 4])
def test_k1_plain_on_a_slice_is_the_global_aggregate_restricted(m):
    """K1's plain version on a slice (slice-local ids, the heat's slice)
    equals the global aggregate's rows in that slice."""
    rng = np.random.default_rng(11)
    v, d, k, r_cap, n_total = 256, 5, 3, 40, 1000.0
    heat = torch.from_numpy(rng.integers(0, 50, v).astype(np.float32))
    ids = np.full((k, r_cap), -1, np.int32)
    for i in range(k):
        u = np.sort(rng.choice(v, 30, replace=False))
        ids[i, :30] = u
    ids = torch.from_numpy(ids)
    rows = torch.from_numpy(rng.standard_normal((k, r_cap, d)).astype(np.float32))
    rows = torch.where(ids[..., None] >= 0, rows, 0.0)
    g_ids, g_rows = union_segsum_torch(ids, rows, heat, n_total, k * r_cap, v, scale=0.5)
    n = v // m
    cap = min(n, k * r_cap)
    for r in range(m):
        parts = [slice_rows(RowSparse(ids[i], rows[i], v), r * n, n) for i in range(k)]
        s_ids, s_rows = union_segsum_torch(torch.stack([p.ids for p in parts]),
                                           torch.stack([p.rows for p in parts]),
                                           heat[r * n:(r + 1) * n], n_total, cap, n,
                                           scale=0.5)
        in_slice = (g_ids >= r * n) & (g_ids < (r + 1) * n)
        count = int(in_slice.sum())
        assert torch.equal(s_ids[:count].long() + r * n, g_ids[in_slice].long())
        assert torch.all(s_ids[count:] == -1)
        np.testing.assert_allclose(s_rows[:count].numpy(), g_rows[in_slice].numpy(),
                                   rtol=2e-5, atol=2e-5)
        agg = aggregate_rowsparse(RowSparse(torch.stack([p.ids for p in parts]),
                                            torch.stack([p.rows for p in parts]), n),
                                  heat[r * n:(r + 1) * n], n_total, 0.5)
        assert torch.equal(agg.ids, s_ids) and torch.equal(agg.rows, s_rows)


def _tiny_qwen():
    return get_config("qwen2_5_14b").replace(**SCALES["tiny"])


@pytest.mark.parametrize("flag", [dict(topk=4), dict(int8=True), dict(topk=4, int8=True)])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_topk_and_int8_refuse_a_split_before_any_collective(flag, shape):
    """With the reference's reasons, before the model is drawn: the
    stand-in mesh has no process group, so any collective would raise
    something else."""
    with pytest.raises(ValueError, match="int8" if flag.get("int8") else "top-k"):
        train(_tiny_qwen(), rounds=1, device="cpu", mesh=_stand_in_mesh(shape), **flag)


def _tiny_step(plan_kw: dict, shapes: bool):
    """A tiny Qwen2.5 round step on a (1, 2) stand-in mesh's part, its
    ``CohortSharding`` given the global shapes or not."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.federated.plan import CohortSharding, RoundPlan, ServerUpdate
    from repro_torch.federated.simulation import make_round_step

    cfg = _tiny_qwen()
    params, axes = train_params(build_model(cfg).abstract_params())
    mesh = _stand_in_mesh((1, 2))
    rules = mesh_rules(cfg, mesh)
    local = shard_params(params, axes, mesh, rules)
    full = {n: tuple(t.shape) for n, t in params.items()} if shapes else None
    plan = RoundPlan(**plan_kw, server=ServerUpdate("fedsubavg"),
                     sharding=CohortSharding(mesh.axis("data"), shapes=full))
    step = make_round_step(lambda p, b: None, local, axes, FedConfig(num_clients=8), mode=plan)
    return step, local, mesh, rules


@pytest.mark.parametrize("shapes", [False, True])
def test_a_split_step_refuses_before_any_collective(shapes):
    """Without the global shapes a split step cannot tell the table's
    vocabulary; a stacked local would gather whole rows from a slice. Both
    raise before the round's first collective (the stand-in mesh has no
    process group)."""
    from repro_torch.federated.plan import (FedSgdLocal, RowSparseTransport,
                                            SubmodelReplicatedLocal)

    local_step = SubmodelReplicatedLocal() if shapes else FedSgdLocal()
    step, params, mesh, rules = _tiny_step(dict(local=local_step,
                                                transport=RowSparseTransport()), shapes)
    set_rules(mesh, rules)
    try:
        if shapes:
            with pytest.raises(NotImplementedError, match="stacked local"):
                step(params, {"tokens": torch.zeros(2, 1, 1, 8, dtype=torch.long)})
        else:
            with pytest.raises(ValueError, match="global shapes"):
                step(params, {"tokens": torch.zeros(2, 8, dtype=torch.long)})
    finally:
        clear_rules()


def test_split_parameters_hold_storage_of_their_own():
    """A rank's part of a split leaf is a copy, also where it is a run of
    leading rows (contiguous as a view): the sparse apply writes the
    table's rows in place, and a view would write the caller's table and
    keep all of it alive."""
    cfg = _tiny_qwen()
    params, axes = train_params(build_model(cfg).init(torch.Generator().manual_seed(0), "cpu"))
    mesh = _stand_in_mesh((1, 2), rank=1)
    local = shard_params(params, axes, mesh, mesh_rules(cfg, mesh))
    emb = local["embedding"]
    assert emb.shape[0] == cfg.vocab_size // 2 and emb.is_contiguous()
    assert emb.untyped_storage().nbytes() == emb.numel() * emb.element_size()
    assert torch.equal(emb, params["embedding"][cfg.vocab_size // 2:])
    norm = "final_norm.scale"
    assert local[norm] is params[norm]


@pytest.mark.parametrize("combine", ["psum", "union"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_sparse_budget_data_axis_is_sharded_combine_bytes_on_the_slice(shape, combine):
    """The data axis of ``tp_collective_budget(sparse=True)`` is the comm
    plane's ``sharded_combine_bytes`` priced on the slice (``V/m`` rows and
    the rank's parameters), plus the 4-byte loss."""
    cfg = _tiny_qwen()
    mesh = _stand_in_mesh(shape)
    rules = complete_rules(cfg, make_rules("train"), shape[1])
    budget = tp_collective_budget(cfg, mesh, {"tokens": torch.zeros(8, 64)}, rules=rules,
                                  sparse=True, combine=combine)
    params, axes = train_params(build_model(cfg).abstract_params())
    set_rules(mesh, rules)
    try:
        local = shard_params(params, axes, mesh, rules)
    finally:
        clear_rules()
    meta = model_comm_meta(local, {"embedding"})
    rows = cfg.vocab_size // shape[1]
    cap = 8 // shape[0] * 64
    mode = pick_combine(rows, cfg.d_model, combine)
    want = sharded_combine_bytes(meta, rows, cap, shape[0], mode, count_gather_ids=True)
    data = budget["by_op"]["data"]
    assert data.get("all-gather", 0.0) == want["all-gather"]
    assert data["all-reduce"] == want["all-reduce"] + 4
    assert budget["axes"]["model"]["sub_rows:embedding"]["bytes"] == cap * cfg.d_model * 4


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-sparse"]:
        sys.path.insert(0, str(ROOT / "tests"))
        jax_sparse_main(sys.argv[2], sys.argv[3])
