"""Port parity, the dry run's other layouts on the mesh: FSDP (the rules'
``embed`` over ``data``: each weight's ``d_model`` split over the data
ranks and gathered per layer) and the multi-pod ``(pod, data, model)``
mesh (the batch over ``("pod", "data")``).

One spawn of 4 gloo ranks on the host (``tests/torch_fsdp_ranks.py``) trains
the tiny models of ``repro_torch.launch.train.SCALES`` for two rounds of the
reference launcher's loop through ``train(mesh=..., layout=...)``: Qwen2.5
under FSDP on ``(2, 1)`` and ``(2, 2)`` on the dense transport and on
``(2, 2)`` on the row-sparse one, Mixtral under FSDP on ``(2, 2)`` in both
MoE layouts, Qwen2.5 on the 3-D meshes ``(2, 1, 2)`` under TP and
``(2, 2, 1)`` under FSDP, and Qwen2-VL (patches, M-RoPE) under FSDP on
``(2, 2)``; and serves Qwen2.5 (a prefill and 6 greedy steps) under FSDP on
``(2, 2)`` and under TP on ``(2, 1, 2)``. Beside it four JAX subprocesses
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) run the JAX
package's launcher step, sparse step and serving loop under the same rules
on Auto-typed meshes. The ranks' results are held within 1e-5 to the JAX
package (losses, every parameter after each round, ``sub_rows``, logits;
Qwen2-VL is held to one device only), within 1e-5 to the port on one device
(and the greedy tokens identical), to each other (a leaf's part is the same
bits on every rank that holds it), and to the budgets: every rank's
counters, per axis and tag, equal ``tp_collective_budget`` in every round
and ``serve_collective_budget`` in the prefill and every step.

Plus: a gathered FSDP checkpoint that the JAX package's ``load_checkpoint``
reads, ``rules.choose_layout`` against the dry run's for every
architecture (read in a subprocess: ``launch/dryrun.py`` asks for 512
devices when it is imported), and the refusal of FSDP for Whisper, Zamba2
and xLSTM.

Run as a script (``--jax-fsdp OUT CASES IN_DIR``) this file is one of those
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

from repro.checkpoint import load_checkpoint as j_load
from repro.configs import get_config as j_get_config
from repro.launch.train import SCALES as J_SCALES
from repro.models import build_model as j_build_model
from repro.sharding.logical import unbox

import torch_fsdp_ranks as ranks
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import _flatten
from repro_torch.federated.plan import tp_collective_budget
from repro_torch.launch.mesh import MESH_AXES, CohortMesh, DeviceMesh, axis_key, spawn_ranks
from repro_torch.launch.serve import make_mesh, serve_rules
from repro_torch.launch.train import mesh_rules, train
from repro_torch.models.transformer import model_split, unstack_layers
from repro_torch.sharding import (choose_layout, clear_rules, complete_rules, fsdp_rules,
                                  make_rules, set_rules)
from repro_torch.sharding.rules import resolve_layout

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT_S = 240.0
TRAIN = list(ranks.TRAIN_CASES)
SERVE = list(ranks.SERVE_CASES)
#: the training cases the JAX package runs (its launcher gives Qwen2-VL no
#: patches or streams: that case is held to one device)
JAX_TRAIN = [c for c in TRAIN if ranks.TRAIN_CASES[c][0] != "qwen2_vl_7b"]
FSDP_TRAIN = [c for c in TRAIN if ranks.TRAIN_CASES[c][2] == "fsdp"]
#: the JAX cases of each subprocess (four run side by side; a compile takes
#: ~8 s on one core); "choose_layout" reads the dry run's choices
JAX_SPLIT = (("qwen_fsdp_2x1", "qwen_fsdp_2x2", "qwen_fsdp_2x2x1"),
             ("qwen_tp_2x1x2", "qwen_sparse_fsdp_2x2"),
             ("mixtral_tp_fsdp_2x2", "mixtral_ep_fsdp_2x2"),
             ("qwen_serve_fsdp_2x2", "qwen_serve_tp_2x1x2", "choose_layout"))
ARCHS = sorted({arch for arch, *_ in ranks.TRAIN_CASES.values()})


def _jax_tiny(arch: str):
    return j_get_config(arch).replace(**J_SCALES["tiny"])


def _np_flat(tree) -> dict:
    return _flatten(jax.tree.map(np.asarray, unbox(tree)))


def _jax_mesh_rules(cfg, shape, kind: str, layout: str, expert_parallel: bool):
    """An Auto-typed mesh of the first ``prod(shape)`` devices (a ``pod``
    axis first on a 3-D one) and the rules the dry run installs on it
    (``launch/dryrun.py:102-115``)."""
    from jax.sharding import AxisType

    from repro.sharding.rules import make_rules as j_make_rules

    names = MESH_AXES[len(shape)]
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:math.prod(shape)])
    rules = j_make_rules(kind, multi_pod=len(shape) == 3, expert_parallel=expert_parallel)
    if layout == "fsdp":
        rules = dict(rules, embed=("data",))
    mdl = shape[-1]
    rules = dict(rules,
                 heads_act=("model",) if cfg.num_heads % mdl == 0 else None,
                 kv_act=("model",) if (cfg.num_kv_heads % mdl == 0
                                       and cfg.num_heads % mdl == 0) else None)
    return mesh, rules


def jax_train_run(case: str) -> dict:
    """``repro/launch/train.py``'s loop (``make_round_step(mode="fedsgd",
    correct=True)``), or ``examples/federated_llm.py``'s sparse plan, under
    the case's rules: losses, ``sub_rows`` and the parameters after each
    round."""
    import jax.numpy as jnp

    from repro.configs import FedConfig
    from repro.data import make_lm_federated
    from repro.federated import make_round_step
    from repro.federated.plan import FedSgdLocal, RoundPlan, RowSparseTransport, ServerUpdate
    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set

    arch, shape, layout, ep, sparse = ranks.TRAIN_CASES[case]
    cfg = _jax_tiny(arch)
    mesh, rules = _jax_mesh_rules(cfg, shape, "train", layout, ep)
    run = ranks.RUN
    j_set(mesh, rules)
    try:
        api = j_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        ds = make_lm_federated(num_clients=run["clients"], vocab=cfg.vocab_size,
                               seq_len=run["seq"], samples_per_client=4)
        fed = FedConfig(num_clients=ds.num_clients, clients_per_round=run["cohort"],
                        lr=run["lr"], algorithm=run["algorithm"])
        mode = (RoundPlan(FedSgdLocal(), RowSparseTransport(), ServerUpdate(run["algorithm"]))
                if sparse else "fedsgd")
        step = jax.jit(make_round_step(api.loss, params, fed, mode=mode, correct=True))
        heat = jnp.asarray(ds.heat.counts, jnp.float32)
        rng = np.random.default_rng(0)
        out = {"losses": [], "rounds": [], "sub_rows": []}
        with jax.set_mesh(mesh):
            for _ in range(run["rounds"]):
                ids = rng.choice(ds.num_clients, size=run["cohort"], replace=False)
                sample = rng.integers(0, ds.client_data["tokens"].shape[1], run["cohort"])
                toks = ds.client_data["tokens"][ids, sample]
                params, metrics = step(params, {"tokens": jnp.asarray(toks),
                                                "heat_vocab": heat})
                out["losses"].append(float(metrics["loss"]))
                if sparse:
                    out["sub_rows"].append(int(metrics["sub_rows"]))
                out["rounds"].append(unstack_layers(_np_flat(params)))
    finally:
        j_clear()
    return out


def jax_serve_run(case: str, in_dir: Path) -> dict:
    """The reference's serving loop (``repro/launch/serve.py``) under the
    case's decode rules: ``prefill`` then ``GEN`` greedy ``decode_step``s."""
    import jax.numpy as jnp

    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set

    arch, shape, layout = ranks.SERVE_CASES[case]
    cfg = _jax_tiny(arch)
    mesh, rules = _jax_mesh_rules(cfg, shape, "decode", layout, False)
    tokens = np.load(in_dir / "serve_tokens.npy")
    j_set(mesh, rules)
    try:
        api = j_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        with jax.set_mesh(mesh):
            cache = api.init_cache(ranks.BATCH, ranks.PROMPT + ranks.GEN)
            logits, cache = jax.jit(api.prefill)(params, {"tokens": jnp.asarray(tokens)}, cache)
            decode = jax.jit(api.decode_step)
            out, toks = [np.asarray(logits)], []
            for _ in range(ranks.GEN):
                nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                logits, cache = decode(params, cache, {"tokens": nxt})
                out.append(np.asarray(logits))
                toks.append(np.asarray(nxt))
    finally:
        j_clear()
    return {"logits": out, "tokens": np.stack(toks, 1)}


def jax_fsdp_main(out_path: str, names: str, in_dir: str) -> None:
    """Subprocess body: the JAX cases named (comma-separated), pickled to
    ``out_path``. ``choose_layout`` imports the dry run last: its module
    sets ``XLA_FLAGS`` for 512 devices, which the backend, up already with
    4, no longer reads."""
    assert len(jax.devices()) == 4, jax.devices()
    res = {}
    for name in names.split(","):
        if name in ranks.TRAIN_CASES:
            res[name] = jax_train_run(name)
        elif name in ranks.SERVE_CASES:
            res[name] = jax_serve_run(name, Path(in_dir))
    if "choose_layout" in names.split(","):
        from repro.launch.dryrun import choose_layout as j_choose_layout
        res["choose_layout"] = {a: j_choose_layout(j_get_config(a)) for a in ARCH_IDS}
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the runs: four JAX subprocesses beside one spawn of 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    np.save(d / "serve_tokens.npy", ranks.serve_tokens())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "--jax-fsdp", str(d / f"jax{i}.pkl"),
                               ",".join(names), str(d)], env=env, cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, names in enumerate(JAX_SPLIT)]
    try:
        for arch in ARCHS:
            params = j_build_model(_jax_tiny(arch)).init(jax.random.PRNGKey(0))
            np.savez(d / f"{arch}.npz", **_np_flat(params))
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
    return SimpleNamespace(ranks=out, jax=jres, dir=d)


def _assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), err_msg=name, **TOL)


def _rows(res) -> slice:
    """The rank's rows of the served batch: its block over the rules'
    batch axes (``launch.shardings._index``)."""
    w = res["tokens"].shape[0]
    return slice(res["rows"] * w, (res["rows"] + 1) * w)


@pytest.fixture(scope="module")
def by_case(runs):
    """Each case's results on every rank, in rank order."""
    return {case: [runs.ranks[r][case] for r in range(ranks.WORLD)] for case in TRAIN + SERVE}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", TRAIN)
def test_layout_round_matches_single_device(by_case, case):
    """Losses, every parameter (gathered whole) after each round and
    ``sub_rows`` on every rank, against the port on one device."""
    for res in by_case[case]:
        np.testing.assert_allclose(res["losses"], res["single_losses"], **TOL)
        for got, want in zip(res["rounds"], res["single_rounds"], strict=True):
            _assert_params_close(got, want)
        assert res["sub_rows"] == res["single_sub_rows"]


@pytest.mark.parametrize("case", JAX_TRAIN)
def test_layout_round_matches_jax_step(runs, by_case, case):
    """Losses, every parameter after each round and ``sub_rows`` on every
    rank, against the JAX package's step under the same rules on the same
    mesh."""
    want = runs.jax[case]
    for res in by_case[case]:
        np.testing.assert_allclose(res["losses"], want["losses"], **TOL)
        for got, w in zip(res["rounds"], want["rounds"], strict=True):
            _assert_params_close(got, w)
        assert res["sub_rows"] == want["sub_rows"]


@pytest.mark.parametrize("case", TRAIN)
def test_counters_equal_tp_collective_budget(by_case, case):
    layout = ranks.TRAIN_CASES[case][2]
    for res in by_case[case]:
        assert len(res["counters"]) == ranks.ROUNDS
        for counted in res["counters"]:
            assert counted == res["budget"], (counted, res["budget"])
        if layout == "fsdp":
            assert res["budget"]["data"]["fsdp_gather"]["op"] == "all-gather"
            assert res["budget"]["data"]["fsdp_grad"]["op"] == "reduce-scatter"
        else:
            assert "fsdp_gather" not in res["budget"]["data"]
        if "pod" in res["axis_names"]:
            assert res["budget"]["pod+data"]["loss"]["op"] == "all-reduce"


@pytest.mark.parametrize("case", TRAIN)
def test_every_part_is_the_same_bits_on_the_ranks_that_hold_it(by_case, case):
    """After the last round, each leaf's part has the same bits on every
    rank of the mesh whose coordinates agree on the axes that split it:
    a whole leaf on every rank, a leaf split over ``data`` alone (FSDP's
    norm scales) on every model rank."""
    results = by_case[case]
    for res in results:
        names = res["axis_names"]
        for other in results:
            if other["mesh_ranks"] != res["mesh_ranks"]:
                continue
            for leaf, spec in res["specs"].items():
                used = {n for p in spec if p for n in ((p,) if isinstance(p, str) else p)}
                same = all(a == b for n, a, b in zip(names, res["coords"], other["coords"])
                           if n in used)
                if same:
                    assert torch.equal(res["local"][leaf], other["local"][leaf]), leaf


@pytest.mark.parametrize("case", FSDP_TRAIN)
def test_fsdp_rank_keeps_its_slice_of_every_weights_d_model(by_case, case):
    """Under FSDP a rank holds its slice of every leaf's ``d_model`` over
    ``data`` (besides the model split): every leaf with the ``embed`` axis
    is split over ``data`` at 1/data of its width, and the rank's resident
    bytes are those parts."""
    arch, shape, *_ = ranks.TRAIN_CASES[case]
    cfg = ranks.tiny_config(arch)
    data = dict(zip(by_case[case][0]["axis_names"], shape))["data"]
    for res in by_case[case]:
        assert res["rules"]["embed"] == ("data",)
        for leaf, spec in res["specs"].items():
            full = res["full_shapes"][leaf]
            local = tuple(res["local"][leaf].shape)
            for dim, (f, p) in enumerate(zip(full, spec)):
                parts = math.prod(dict(zip(res["axis_names"], shape))[n]
                                  for n in (((p,) if isinstance(p, str) else p) if p else ()))
                assert local[dim] == f // parts, (leaf, dim)
            if full and cfg.d_model in full and "data" in str(spec):
                assert local[spec.index("data")] == cfg.d_model // data, leaf
        d_leaves = [n for n, sp in res["specs"].items() if "data" in sp]
        assert "embedding" in d_leaves and "lm_head" in d_leaves and "final_norm.scale" in d_leaves
        assert any(".attn.wq.w" in n for n in d_leaves)


@pytest.mark.parametrize("case", TRAIN)
def test_split_then_gather_gives_the_input_back(by_case, case):
    """``unshard_params`` of ``shard_params`` is the input, bit for bit, under
    the rules' batch axes on ``d_model`` too: on a 3-D mesh a dim split over
    the joint ``("pod", "data")`` is gathered over that axis, its blocks in
    ``_index``'s row-major order."""
    for res in by_case[case]:
        assert res["round_trip"]
    if len(ranks.TRAIN_CASES[case][1]) == 3:
        assert by_case[case][0]["joint_specs"]["lm_head"][0] == ("pod", "data")


def test_gathered_fsdp_checkpoint_loads_into_the_jax_package(runs, by_case):
    case = ranks.CKPT_CASE
    cfg = _jax_tiny(ranks.TRAIN_CASES[case][0])
    template = j_build_model(cfg).init(jax.random.PRNGKey(1))
    back = unstack_layers(_np_flat(j_load(str(runs.dir / case), template)))
    want = by_case[case][0]["rounds"][-1]
    assert set(back) == set(want)
    for name, w in want.items():
        assert np.array_equal(np.asarray(back[name]), w.numpy()), name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SERVE)
def test_layout_serving_matches_jax(runs, by_case, case):
    """The rank's rows of the prefill's and every step's logits against the
    JAX package's serving loop under the same decode rules, and its greedy
    tokens identical."""
    want = runs.jax[case]
    for res in by_case[case]:
        rows = _rows(res)
        assert len(res["logits"]) == len(want["logits"]) == ranks.GEN + 1
        for got, ref in zip(res["logits"], want["logits"]):
            np.testing.assert_allclose(got.numpy(), ref[rows], **TOL)
        assert np.array_equal(res["tokens"].numpy(), want["tokens"][rows])


@pytest.mark.parametrize("case", SERVE)
def test_layout_serving_matches_single_device(by_case, case):
    for res in by_case[case]:
        rows = _rows(res)
        assert res["tokens"].shape[0] < ranks.BATCH
        for got, ref in zip(res["logits"], res["single_logits"], strict=True):
            np.testing.assert_allclose(got.numpy(), ref[rows].numpy(), **TOL)
        assert torch.equal(res["tokens"], res["single_tokens"][rows])


@pytest.mark.parametrize("case", SERVE)
def test_serving_counters_equal_serve_collective_budget(by_case, case):
    layout = ranks.SERVE_CASES[case][2]
    for res in by_case[case]:
        assert res["counters_prefill"] == res["budget"]["prefill"]
        assert len(res["counters_steps"]) == ranks.GEN
        for counted in res["counters_steps"]:
            assert counted == res["budget"]["step"]
        assert ("fsdp_gather" in res["budget"]["step"]["data"]) == (layout == "fsdp")


# ---------------------------------------------------------------------------
# the layouts without ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_layout_matches_the_dry_run(runs, arch):
    want = runs.jax["choose_layout"][arch]
    assert choose_layout(get_config(arch)) == want
    assert resolve_layout(get_config(arch), "auto") == want


def _stand_in_mesh(shape, rank: int = 0) -> DeviceMesh:
    """A DeviceMesh whose axes have no process group (for what reads only
    the layout), with the joint ``pod+data`` axis on a 3-D one."""
    names = MESH_AXES[len(shape)]
    mesh = DeviceMesh(names, tuple(shape), tuple(range(math.prod(shape))), rank,
                      torch.device("cpu"))
    coords = dict(zip(names, mesh.coords))
    mesh.axes = {n: CohortMesh(rank=coords[n], size=s, device=torch.device("cpu"), axis=n)
                 for n, s in zip(names, shape)}
    if len(shape) == 3:
        mesh.axes["pod+data"] = CohortMesh(rank=coords["pod"] * shape[1] + coords["data"],
                                           size=shape[0] * shape[1],
                                           device=torch.device("cpu"), axis="pod+data")
    return mesh


@pytest.mark.parametrize("arch", ["whisper_large_v3", "zamba2_1_2b", "xlstm_350m"])
def test_fsdp_is_refused_for_the_families_whose_layers_do_not_gather(arch):
    """Whisper, Zamba2 and xLSTM have no FSDP layout: the launchers' rules
    refuse it, ``train`` before it draws the model (the stand-in mesh has
    no process group), and ``model_split`` under rules a caller installs
    by hand. ``auto`` puts them on TP, as the dry run does."""
    cfg = get_config(arch).replace(**ranks.SCALES["tiny"])
    mesh = _stand_in_mesh((2, 2))
    for fn in (mesh_rules, serve_rules):
        with pytest.raises(NotImplementedError, match="no FSDP layout"):
            fn(cfg, mesh, layout="fsdp")
    with pytest.raises(NotImplementedError, match="no FSDP layout"):
        train(cfg, rounds=1, device="cpu", mesh=mesh, layout="fsdp")
    assert choose_layout(get_config(arch)) == "tp"
    assert mesh_rules(cfg, mesh, layout="auto")["embed"] is None
    set_rules(mesh, fsdp_rules(complete_rules(cfg, make_rules("train"), 2)))
    try:
        with pytest.raises(NotImplementedError, match="layout='tp'"):
            model_split(cfg)
    finally:
        clear_rules()


def test_default_layout_is_tp_and_unknown_layouts_raise():
    cfg = ranks.tiny_config("qwen2_5_14b")
    mesh = _stand_in_mesh((2, 2))
    assert mesh_rules(cfg, mesh)["embed"] is None
    assert serve_rules(cfg, mesh)["embed"] is None
    assert mesh_rules(cfg, mesh, layout="fsdp")["embed"] == ("data",)
    with pytest.raises(ValueError, match="layout"):
        mesh_rules(cfg, mesh, layout="zero3")
    rules = mesh_rules(cfg, _stand_in_mesh((2, 1, 2)))
    assert rules["batch"] == ("pod", "data") and rules["clients"] == ("pod", "data")


def test_fsdp_budget_gathers_each_layer_per_forward_pass():
    """Under remat a layer's weights are gathered in the forward and again
    in the recompute, and scattered back once; off remat once each. The
    gathers move the layers' weights whole: data times the rank's part; of
    the embedding only the rows the data ranks look up."""
    cfg = ranks.tiny_config("qwen2_5_14b")
    mesh = _stand_in_mesh((2, 2))
    rules = mesh_rules(cfg, mesh, layout="fsdp")
    batch = {"tokens": torch.zeros(8, 64)}
    on = tp_collective_budget(cfg, mesh, batch, rules=rules)["axes"]["data"]
    off = tp_collective_budget(cfg, mesh, batch, rules=rules, remat=False)["axes"]["data"]
    tp = tp_collective_budget(cfg, mesh, batch, rules=mesh_rules(cfg, mesh))["axes"]["data"]
    # outside the layers: lm_head's and the final norm's columns whole, and
    # the embedding's rows each data rank looks up (2 x 256 tokens)
    t = 8 // 2 * 64
    top = sum(n * 4 for n in (cfg.d_model * cfg.vocab_size // 2, cfg.d_model,
                              2 * t * cfg.d_model))
    assert on["fsdp_grad"] == off["fsdp_grad"]
    assert on["fsdp_gather"]["bytes"] - top == 2 * (off["fsdp_gather"]["bytes"] - top)
    assert off["fsdp_gather"]["bytes"] == off["fsdp_grad"]["bytes"]
    # what the data axis gathers leaves its all-reduce
    assert on["dense_tree"]["bytes"] < tp["dense_tree"]["bytes"] / 2


def test_mesh_cli_shapes():
    assert make_mesh() is None
    with pytest.raises(ValueError, match="P,D,M"):
        make_mesh(mesh_shape="2,2,2,2", device="cpu")
    assert axis_key(("pod", "data")) == "pod+data" and axis_key("data") == "data"
    assert axis_key(("data",)) == "data"
    mesh = _stand_in_mesh((2, 1, 2), rank=3)
    assert mesh.axis(("pod", "data")) is mesh.axes["pod+data"]
    assert mesh.axis(("data",)) is mesh.axes["data"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-fsdp"]:
        sys.path.insert(0, str(ROOT / "tests"))
        jax_fsdp_main(sys.argv[2], sys.argv[3], sys.argv[4])
