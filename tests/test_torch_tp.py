"""Port parity, the transformer's training round split over a ``(data,
model)`` mesh of ``torch.distributed`` ranks.

One spawn of 4 gloo ranks on the host (``tests/torch_tp_ranks.py``) trains
the tiny models of ``repro_torch.launch.train.SCALES`` for two rounds of
the reference launcher's loop through ``train(..., mesh=...)``, on
``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` meshes laid over one world: Qwen2.5's
dense layers, Mixtral's MoE in its tensor-parallel baseline and expert
parallel, Qwen3's QK norms on whole KV heads, Qwen2-VL's patches and M-RoPE.
The ranks' results are held to:

- the JAX package's launcher step under ``make_rules("train")`` on an
  Auto-typed ``(data, model)`` mesh of 4 virtual CPU devices, from two
  subprocesses (``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
  ``jax.make_mesh``'s default Explicit axes refuse ``constrain``): losses
  and every parameter after each round within 1e-5;
- the port's single-device step on the same rounds, within 1e-5;
- each other: every leaf the rules leave whole is bit-identical on every
  rank of its mesh after each round, and the MoE routes and drops the same
  tokens on every rank as on one device;
- ``tp_collective_budget``: each rank's collective counters, per axis and
  tag, equal it in every round.

Plus the rules, specs, fitting and batch layout against the JAX package's
for every rule kind, the parameter split's round trip, and a gathered
checkpoint that the JAX package's ``load_checkpoint`` reads.

Run as a script (``--jax-tp OUT CASES``) this file is one of those
subprocesses (two run side by side, each on some of the cases).
"""
import functools
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
from repro.launch.shardings import _fit_spec as j_fit_spec
from repro.launch.shardings import batch_spec_for as j_batch_spec_for
from repro.launch.train import SCALES as J_SCALES
from repro.models import build_model as j_build_model
from repro.sharding.context import spec_for_axes as j_spec_for_axes
from repro.sharding.logical import unbox
from repro.sharding.rules import DECODE_RULES as J_DECODE_RULES
from repro.sharding.rules import TRAIN_RULES as J_TRAIN_RULES
from repro.sharding.rules import make_rules as j_make_rules

import torch_tp_ranks as ranks
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.convert import _flatten
from repro_torch.federated.plan import tp_collective_budget
from repro_torch.launch.mesh import (CohortMesh, DeviceMesh, make_production_mesh,
                                     production_mesh_shape, spawn_ranks)
from repro_torch.launch.shardings import _fit_spec, batch_spec_for, local_part
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.transformer import model_split, unstack_layers
from repro_torch.sharding import (DECODE_RULES, TRAIN_RULES, axes_tree, boxed_like,
                                  clear_rules, complete_rules, constrain, make_rules,
                                  param_rules, param_shardings, set_rules,
                                  sharding_for_axes, spec_for_axes)
from repro_torch.sharding import unbox as port_unbox

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT_S = 240.0
#: the JAX package's cases: arch, mesh shape, expert_parallel
JAX_CASES = {"qwen_m2": ("qwen2_5_14b", (2, 2), False),
             "qwen_m4": ("qwen2_5_14b", (1, 4), False),
             "mixtral_tp": ("mixtral_8x22b", (2, 2), False),
             "mixtral_ep": ("mixtral_8x22b", (2, 2), True)}
ARCHS = sorted({arch for arch, _, _, _ in ranks.CASES.values()})
CASES = list(ranks.CASES)
JAX_COMPARED = [c for c in CASES if ranks.CASES[c][3] is not None]
MOE_CASES = [c for c in CASES if ranks.CASES[c][0] == "mixtral_8x22b"]


def _jax_tiny(arch: str):
    return j_get_config(arch).replace(**J_SCALES["tiny"])


def _np_flat(tree) -> dict:
    return _flatten(jax.tree.map(np.asarray, unbox(tree)))


def jax_launcher_run(arch: str, shape, expert_parallel: bool) -> dict:
    """``repro/launch/train.py``'s loop on an Auto-typed mesh of the first
    ``prod(shape)`` devices, its rules completed as the dry run completes
    them (``launch/dryrun.py:110-115``)."""
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import FedConfig
    from repro.data import make_lm_federated
    from repro.federated import make_round_step
    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set

    cfg = _jax_tiny(arch)
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])
    mdl = shape[1]
    rules = dict(j_make_rules("train", expert_parallel=expert_parallel),
                 heads_act=("model",) if cfg.num_heads % mdl == 0 else None,
                 kv_act=("model",) if (cfg.num_kv_heads % mdl == 0
                                       and cfg.num_heads % mdl == 0) else None)
    j_set(mesh, rules)
    try:
        api = j_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        run = ranks.RUN
        ds = make_lm_federated(num_clients=run["clients"], vocab=cfg.vocab_size,
                               seq_len=run["seq"], samples_per_client=4)
        fed = FedConfig(num_clients=ds.num_clients, clients_per_round=run["cohort"],
                        lr=run["lr"], algorithm=run["algorithm"])
        step = jax.jit(make_round_step(api.loss, params, fed, mode="fedsgd", correct=True))
        heat = jnp.asarray(ds.heat.counts, jnp.float32)
        rng = np.random.default_rng(0)
        out = {"losses": []}
        with jax.set_mesh(mesh):
            for _ in range(run["rounds"]):
                ids = rng.choice(ds.num_clients, size=run["cohort"], replace=False)
                sample = rng.integers(0, ds.client_data["tokens"].shape[1], run["cohort"])
                toks = ds.client_data["tokens"][ids, sample]
                params, metrics = step(params, {"tokens": jnp.asarray(toks),
                                                "heat_vocab": heat})
                out["losses"].append(float(metrics["loss"]))
        out["params"] = _np_flat(params)
    finally:
        j_clear()
    return out


#: the JAX cases of each subprocess: two run side by side (a compile takes
#: ~8 s on one core)
JAX_SPLIT = (("qwen_m2", "mixtral_tp"), ("qwen_m4", "mixtral_ep"))


def jax_tp_main(out_path: str, names: str) -> None:
    """Subprocess body: the JAX cases named (comma-separated), pickled to
    ``out_path``."""
    assert len(jax.devices()) == 4, jax.devices()
    res = {name: jax_launcher_run(*JAX_CASES[name]) for name in names.split(",")}
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the runs: two JAX subprocesses beside one spawn of 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "--jax-tp", str(d / f"jax{i}.pkl"),
                               ",".join(names)], env=env, cwd=str(ROOT),
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


def _leaders(runs, case):
    """The first rank of each mesh laid over the world for ``case``."""
    return sorted({runs.ranks[r][case]["mesh_ranks"][0] for r in range(ranks.WORLD)})


def _assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_sharded_round_matches_single_device(runs, case):
    for r in _leaders(runs, case):
        res = runs.ranks[r][case]
        np.testing.assert_allclose(res["losses"], res["single_losses"], **TOL)
        _assert_params_close(res["params"], res["single_params"])


@pytest.mark.parametrize("case", JAX_COMPARED)
def test_sharded_round_matches_jax_sharded_step(runs, case):
    want = runs.jax[ranks.CASES[case][3]]
    for r in _leaders(runs, case):
        res = runs.ranks[r][case]
        np.testing.assert_allclose(res["losses"], want["losses"], **TOL)
        _assert_params_close(res["params"], unstack_layers(want["params"]))


@pytest.mark.parametrize("case", CASES)
def test_whole_leaves_are_bit_identical_on_every_rank(runs, case):
    """After each round, every leaf the rules leave whole (norms, the TP
    router, KV projections and QK norms on whole KV heads) has the same
    bits on every rank of the mesh; a split leaf the same on the ranks of
    its model coordinate."""
    by_rank = [runs.ranks[r][case] for r in range(ranks.WORLD)]
    for r, res in enumerate(by_rank):
        lead = by_rank[res["mesh_ranks"][0]]
        assert res["replicated"] and len(res["replicated"]) == ranks.ROUNDS
        for rnd, leaves in enumerate(res["replicated"]):
            assert set(leaves) == set(lead["replicated"][rnd])
            for name, t in leaves.items():
                assert torch.equal(t, lead["replicated"][rnd][name]), (r, rnd, name)
        for other in by_rank:
            if other["mesh_ranks"] == res["mesh_ranks"] and other["coords"][1] == res["coords"][1]:
                for name in res["split_leaves"]:
                    assert torch.equal(other["local"][name], res["local"][name]), (r, name)


@pytest.mark.parametrize("case", CASES)
def test_counters_equal_tp_collective_budget(runs, case):
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        assert len(res["counters"]) == ranks.ROUNDS
        for counted in res["counters"]:
            assert counted == res["budget"], (r, counted, res["budget"])
        if ranks.CASES[case][1][1] > 1:
            assert res["budget"]["model"], "a model split with no model-axis collective"


@pytest.mark.parametrize("case", CASES)
def test_shard_then_unshard_gives_the_input_back(runs, case):
    assert all(runs.ranks[r][case]["round_trip"] for r in range(ranks.WORLD))
    lead = runs.ranks[0][case]
    arch, shape, _, _ = ranks.CASES[case]
    assert lead["split_leaves"], "nothing split"
    assert "embedding" in lead["split_leaves"] and "lm_head" in lead["split_leaves"]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routing_is_the_single_device_routing(runs, case):
    """Every rank routes and drops as one device does: the rank's tokens'
    expert ids and kept assignments are the single-device run's, call for
    call (remat's recompute included)."""
    shape = ranks.CASES[case][1]
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        assert len(res["routes"]) == len(res["single_routes"]) > 0
        d = res["coords"][0]
        for (ids, keep), (sids, skeep) in zip(res["routes"], res["single_routes"]):
            n = len(ids)
            assert n * shape[0] == len(sids)
            assert ids == sids[d * n:(d + 1) * n]
            k = len(ids[0])
            assert keep == skeep[d * n * k:(d + 1) * n * k]


def test_gathered_checkpoint_loads_into_the_jax_package(runs):
    case = ranks.CKPT_CASE
    cfg = _jax_tiny(ranks.CASES[case][0])
    template = j_build_model(cfg).init(jax.random.PRNGKey(1))
    back = unstack_layers(_np_flat(j_load(str(runs.dir / case), template)))
    want = runs.ranks[0][case]["params"]
    assert set(back) == set(want)
    for name, w in want.items():
        assert np.array_equal(np.asarray(back[name]), w.numpy()), name


# ---------------------------------------------------------------------------
# rules, specs and layouts against the JAX package
# ---------------------------------------------------------------------------


RULE_KINDS = [(kind, multi_pod, ep, seq) for kind in ("train", "decode", "prefill")
              for multi_pod in (False, True) for ep in (False, True) for seq in (True, False)]


@pytest.mark.parametrize("kind,multi_pod,ep,seq", RULE_KINDS)
def test_make_rules_matches_jax(kind, multi_pod, ep, seq):
    assert (make_rules(kind, multi_pod=multi_pod, expert_parallel=ep, seq_shard_decode=seq)
            == j_make_rules(kind, multi_pod=multi_pod, expert_parallel=ep,
                            seq_shard_decode=seq))


def test_rule_constants_match_jax():
    assert TRAIN_RULES == J_TRAIN_RULES and DECODE_RULES == J_DECODE_RULES


@functools.lru_cache(maxsize=1)
def _every_axes():
    """Every logical-axes tuple of every registered transformer's leaves,
    and the reference's activation and cache axes."""
    seen = {("batch", None, "heads_act", None), ("batch", None, "kv_act", None),
            ("batch", None, None), ("batch", None, "vocab"), ("batch", "vocab"),
            ("layers", "batch", "kv_heads", "kv_seq", None), ("batch", "kv_seq", None, None)}
    for name in ARCH_IDS:
        cfg = get_config(name)
        if cfg.family in ("dense", "moe", "vlm"):
            model = build_model(cfg.replace(num_layers=1)).abstract_params()
            seen.update(tuple(ax) for ax in model.axes.values())
    return sorted(seen, key=repr)


@pytest.mark.parametrize("kind,multi_pod,ep", [(k, m, e) for k in ("train", "decode")
                                               for m in (False, True) for e in (False, True)])
def test_spec_for_axes_matches_jax(kind, multi_pod, ep):
    rules = make_rules(kind, multi_pod=multi_pod, expert_parallel=ep)
    jrules = j_make_rules(kind, multi_pod=multi_pod, expert_parallel=ep)
    for axes in _every_axes():
        assert spec_for_axes(axes, rules) == tuple(j_spec_for_axes(axes, jrules)), axes


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (16, 16), (2, 16, 16)])
def test_fit_spec_matches_jax(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    specs = [("model", None), (None, "model"), ("data", "model"), (("pod", "data"), None)]
    shapes = [(51866, 1280), (2048, 128), (8, 64), (1, 1500), (128, 512), (3, 16)]
    for spec in specs:
        if any(n not in names for p in spec for n in ((p,) if isinstance(p, str) else p or ())):
            continue
        for dims in shapes:
            want = tuple(j_fit_spec(mesh, jax.sharding.PartitionSpec(*spec), dims))
            assert _fit_spec(mesh, spec, dims) == want, (spec, dims)


@pytest.mark.parametrize("batch_axes", ["data", ("pod", "data"), None])
def test_batch_spec_for_matches_jax(batch_axes):
    for key in ("tokens", "labels", "mask", "frames", "patch_embeds", "mrope_pos",
                "heat_vocab", "heat_expert"):
        for ndim in (1, 2, 3):
            assert (batch_spec_for(key, ndim, batch_axes)
                    == tuple(j_batch_spec_for(key, ndim, batch_axes))), (key, ndim)


@pytest.mark.parametrize("model_size", [1, 2, 4, 16])
def test_complete_rules_sets_head_axes_as_the_dry_run(model_size):
    for name in ARCH_IDS:
        cfg = get_config(name)
        rules = complete_rules(cfg, make_rules("train"), model_size)
        heads = cfg.num_heads % model_size == 0
        assert rules["heads_act"] == (("model",) if heads else None), name
        assert rules["kv_act"] == (("model",) if heads and cfg.num_kv_heads % model_size == 0
                                   else None), name
        prules = param_rules(rules)
        assert prules["heads"] == rules["heads_act"] and prules["kv"] == rules["kv_act"]


# ---------------------------------------------------------------------------
# the mesh, the split and the budget without ranks
# ---------------------------------------------------------------------------


def _stand_in_mesh(shape, rank: int = 0) -> DeviceMesh:
    """A DeviceMesh whose axes have no process group (for what reads only
    the layout)."""
    names = ("data", "model")
    mesh = DeviceMesh(names, tuple(shape), tuple(range(math.prod(shape))), rank,
                      torch.device("cpu"))
    coords = dict(zip(names, mesh.coords))
    mesh.axes = {n: CohortMesh(rank=coords[n], size=s, device=torch.device("cpu"), axis=n)
                 for n, s in zip(names, shape)}
    return mesh


def test_device_mesh_lays_ranks_out_row_major():
    assert [_stand_in_mesh((2, 2), r).coords for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                                    (1, 1)]
    x = torch.arange(8 * 6).reshape(8, 6)
    parts = [local_part(x, _stand_in_mesh((2, 2), r), ("data", "model")) for r in range(4)]
    assert torch.equal(torch.cat([torch.cat(parts[:2], 1), torch.cat(parts[2:], 1)], 0), x)


def test_model_split_keeps_whole_heads():
    """At 4 model ranks the tiny config's 4 query heads split and its 2 KV
    heads stay whole; at 2 both split. Off the mesh nothing splits."""
    cfg = get_config("qwen2_5_14b").replace(**ranks.SCALES["tiny"])
    assert model_split(cfg) == transformer.NO_SPLIT
    for m, kv_split in ((2, True), (4, False)):
        mesh = _stand_in_mesh((1, m))
        set_rules(mesh, complete_rules(cfg, make_rules("train"), m))
        try:
            split = model_split(cfg)
        finally:
            clear_rules()
        assert split.heads is not None and split.ffn is not None and split.vocab is not None
        assert (split.kv is not None) == kv_split and split.experts is None


def test_budget_counts_forward_collectives_twice_under_remat():
    cfg = get_config("mixtral_8x22b").replace(**ranks.SCALES["tiny"])
    mesh = _stand_in_mesh((2, 2))
    rules = complete_rules(cfg, make_rules("train", expert_parallel=True), 2)
    batch = {"tokens": torch.zeros(8, 64)}
    on = tp_collective_budget(cfg, mesh, batch, rules=rules)["axes"]
    off = tp_collective_budget(cfg, mesh, batch, rules=rules, remat=False)["axes"]
    for tag in ("attn_out", "moe_out", "router_logits"):
        assert on["model"][tag]["bytes"] == 2 * off["model"][tag]["bytes"], tag
    for tag in ("attn_in", "moe_in", "moe_gates", "router_in", "embed", "xent_sum"):
        assert on["model"][tag] == off["model"][tag], tag
    assert on["data"]["moe_counts"]["bytes"] == 2 * off["data"]["moe_counts"]["bytes"]
    t = 8 // 2 * 64
    assert off["model"]["attn_out"]["bytes"] == cfg.num_layers * t * cfg.d_model * 4


def test_constrain_checks_the_local_layout():
    x = torch.zeros(4, 64, 2, 32)
    assert constrain(x, ("batch", None, "heads_act", None), (None, 64, 4, 32)) is x
    set_rules(_stand_in_mesh((2, 2)), dict(make_rules("train"), heads_act=("model",)))
    try:
        assert constrain(x, ("batch", None, "heads_act", None), (8, 64, 4, 32)) is x
        with pytest.raises(ValueError, match="dim 2"):
            constrain(x, ("batch", None, "heads_act", None), (8, 64, 8, 32))
    finally:
        clear_rules()
    # a dim the axis does not divide stays whole: Whisper's vocabulary at 4
    set_rules(_stand_in_mesh((1, 4)), make_rules("train"))
    try:
        y = torch.zeros(51866)
        assert constrain(y, ("vocab",), (51866,)) is y
        with pytest.raises(ValueError, match="dim 0"):
            constrain(torch.zeros(8192), ("vocab",), (16384,))
    finally:
        clear_rules()


def test_param_shardings_split_whole_heads_under_installed_rules():
    cfg = get_config("qwen2_5_14b").replace(**ranks.SCALES["tiny"])
    model = build_model(cfg).abstract_params()
    with pytest.raises(RuntimeError, match="no mesh"):
        param_shardings(model.axes)
    assert sharding_for_axes(("batch", None)) is None
    rules = complete_rules(cfg, make_rules("train"), 4)
    set_rules(_stand_in_mesh((1, 4)), rules)
    try:
        specs = param_shardings(model.axes)
        assert sharding_for_axes(("batch", "vocab")) == ("data", "model")
    finally:
        clear_rules()
    assert specs["layers.0.attn.wq.w"] == (None, "model")
    assert specs["layers.0.attn.wk.w"] == (None, None)        # 2 KV heads at 4 ranks
    assert specs["embedding"] == ("model", None) and specs["lm_head"] == (None, "model")
    assert specs["layers.0.attn.norm.scale"] == (None,)


def test_boxed_like_checks_names_and_ranks():
    params, axes = transformer.train_params(
        build_model(get_config("qwen2_5_14b").replace(**ranks.SCALES["tiny"])).abstract_params())
    assert boxed_like(params, axes)[1] == axes == axes_tree(
        build_model(get_config("qwen2_5_14b").replace(**ranks.SCALES["tiny"])).abstract_params())
    with pytest.raises(ValueError, match="names differ"):
        boxed_like({k: v for k, v in params.items() if k != "embedding"}, axes)
    with pytest.raises(ValueError, match="dims"):
        boxed_like(dict(params, embedding=params["embedding"][0]), axes)
    assert port_unbox(params) == params


def test_production_mesh_needs_its_world(monkeypatch):
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("flags", [dict(topk=4), dict(int8=True)])
@pytest.mark.parametrize("arch", ["whisper_large_v3", "zamba2_1_2b", "xlstm_350m"])
def test_train_refuses_the_other_families_on_the_sparse_transport(arch, flags):
    """``train(mesh=...)`` takes Whisper, Zamba2 and xLSTM on the row-sparse
    transport (``tests/test_torch_family_tp.py``) but, as for every family,
    refuses top-k and int8 rows on a mesh, as the reference's sharded step
    does, before it draws the model: the stand-in mesh has no process group,
    so a collective would raise otherwise."""
    from repro_torch.launch.train import train
    with pytest.raises(ValueError, match="int8" if flags.get("int8") else "top-k"):
        train(get_config(arch).replace(**ranks.SCALES["tiny"]), rounds=1, device="cpu",
              mesh=_stand_in_mesh((1, 2)), **flags)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-tp"]:
        sys.path.insert(0, str(ROOT / "tests"))
        jax_tp_main(sys.argv[2], sys.argv[3])
