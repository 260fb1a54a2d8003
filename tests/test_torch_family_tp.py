"""Port parity, Whisper, Zamba2 and xLSTM trained and served on a ``(data,
model)`` mesh of ``torch.distributed`` ranks: their mixers split over
``model`` (Mamba2 by SSM heads, the mLSTM by its heads, the sLSTM's
projections by their columns), K3 and its backward on each rank's heads,
K4's log-sum-exp instance on each rank's slice of the caches.

One spawn of 4 gloo ranks on the host (``tests/torch_family_tp_ranks.py``)
serves the tiny models of ``repro_torch.launch.serve.SCALES`` through
``serve(..., mesh=...)`` on ``(1, 2)`` and ``(1, 4)`` (a prefill and 4
greedy steps), and trains them for two rounds through ``train(...,
mesh=...)`` on ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` meshes laid over one
world, on the dense and the row-sparse transports; Whisper also with a
2,046-row vocabulary, which 4 model ranks do not divide (the table whole).
Zamba2 runs at ``attn_every`` 2 (at the tiny scale's 2 layers, 6 gives it
no attention site) and xLSTM with one block of each kind (its gradients
through the tiny scale's 24 blocks move ~2e-3 under a 1e-7 change of the
parameters). Beside the spawn, three JAX subprocesses (one per family,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) run the reference
launcher's FedSGD step under ``make_rules("train")`` on an Auto-typed
``(2, 2)`` mesh and its ``prefill``/``decode_step`` under
``make_rules("decode")`` on ``(1, 2)``. The second round of every Zamba2
and xLSTM training run, the port's on a mesh and on one device alike,
starts from the JAX package's parameters after its first round (their
gradients move far more than a round's float noise under a last-ulp
change), so each round is held from a common start:

- to the JAX package: losses and every parameter after each round within
  1e-5, every step's logits within 1e-5 and the greedy tokens identical;
- to the port on one device the same way, on every mesh and transport;
- to each other: every leaf the rules leave whole is bit-identical on every
  rank of its mesh after each round;
- to the budgets: each rank's counters equal ``tp_collective_budget`` in
  every round and ``serve_collective_budget`` in the prefill and every step;
- to the layouts: each rank's cache after the prefill and after every step
  is ``local_cache`` of the one-device cache, ``unshard_params`` gives the
  split parameters back, and a gathered checkpoint loads into the JAX
  package.

Run as a script (``--jax MODEL DIR``) this file is one of those
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

import torch_family_tp_ranks as ranks
from repro_torch.configs.base import get_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.launch.mesh import CohortMesh, DeviceMesh, spawn_ranks
from repro_torch.launch.serve import prompt_tokens, serve_rules
from repro_torch.launch.shardings import cache_specs
from repro_torch.launch.train import mesh_rules
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.transformer import model_split
from repro_torch.sharding import clear_rules, set_rules

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT_S = 300.0
TRAIN = list(ranks.TRAIN_CASES)
SERVE = list(ranks.SERVE_CASES)
JAX_TRAIN = [f"{m}_2x2_dense" for m in ranks.JAX_MODELS]
JAX_SERVE = [f"{m}_1x2" for m in ranks.JAX_MODELS]


def _jax_tiny(model: str):
    arch, over = ranks.MODELS[model]
    cfg = j_get_config(arch)
    scale = dict(J_SCALES["tiny"])
    if cfg.family == "ssm":
        scale.pop("d_ff", None)
    return cfg.replace(**scale).replace(**over)


def _np_flat(tree) -> dict:
    return _flatten(jax.tree.map(np.asarray, unbox(tree)))


def _auto_mesh(shape):
    from jax.sharding import AxisType

    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])


def _completed(cfg, kind: str, shape) -> dict:
    """``make_rules(kind)`` completed as ``launch/dryrun.py:110-115``."""
    from repro.sharding.rules import make_rules as j_make_rules

    mdl = shape[1]
    return dict(j_make_rules(kind),
                heads_act=("model",) if cfg.num_heads % mdl == 0 else None,
                kv_act=("model",) if (cfg.num_kv_heads % mdl == 0
                                      and cfg.num_heads % mdl == 0) else None)


def _dump(path: Path, obj) -> None:
    """Written whole, then renamed: a rank polling for the file never
    reads half of it."""
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(obj, fh)
    os.replace(tmp, path)


def jax_train_run(model: str) -> dict:
    """``repro/launch/train.py``'s loop (FedSGD, ``correct=True``) on an
    Auto-typed ``(2, 2)`` mesh, with the frames of the serving launcher for
    an audio model: each round's loss and parameters."""
    import jax.numpy as jnp

    from repro.configs import FedConfig
    from repro.data import make_lm_federated
    from repro.federated import make_round_step
    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set

    cfg = _jax_tiny(model)
    mesh = _auto_mesh((2, 2))
    j_set(mesh, _completed(cfg, "train", (2, 2)))
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
        out = {"losses": [], "params": []}
        with jax.set_mesh(mesh):
            for _ in range(run["rounds"]):
                ids = rng.choice(ds.num_clients, size=run["cohort"], replace=False)
                sample = rng.integers(0, ds.client_data["tokens"].shape[1], run["cohort"])
                batch = {"tokens": jnp.asarray(ds.client_data["tokens"][ids, sample]),
                         "heat_vocab": heat}
                if cfg.frontend == "audio_frames":
                    batch["frames"] = jnp.full((run["cohort"], cfg.encoder_seq, cfg.d_model),
                                               0.02, jnp.float32)
                params, metrics = step(params, batch)
                out["losses"].append(float(metrics["loss"]))
                out["params"].append(_np_flat(params))
    finally:
        j_clear()
    return out


def jax_serve_run(model: str, in_dir: Path) -> dict:
    """``repro/launch/serve.py``'s loop on an Auto-typed ``(1, 2)`` mesh:
    ``prefill`` then ``GEN`` greedy ``decode_step``s."""
    import jax.numpy as jnp

    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set

    cfg = _jax_tiny(model)
    mesh = _auto_mesh((1, 2))
    j_set(mesh, _completed(cfg, "decode", (1, 2)))
    try:
        api = j_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(np.load(in_dir / f"{model}_tokens.npy"))}
        if cfg.frontend == "audio_frames":
            batch["frames"] = jnp.full((ranks.BATCH, cfg.encoder_seq, cfg.d_model), 0.02,
                                       jnp.float32)
        with jax.set_mesh(mesh):
            cache = api.init_cache(ranks.BATCH, ranks.PROMPT + ranks.GEN)
            logits, cache = jax.jit(api.prefill)(params, batch, cache)
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


#: the initial parameters each JAX subprocess writes, by the model it runs
INITS = {"zamba": ("zamba",), "xlstm": ("xlstm",), "whisper": ("whisper", "whisper_v2046")}


def jax_main(model: str, out_dir: str) -> None:
    """Subprocess body: the initial parameters the ranks start from, the
    model's training (written next: the ranks wait for its first round),
    then its serving."""
    assert len(jax.devices()) == 4, jax.devices()
    d = Path(out_dir)
    for name in INITS[model]:
        params = j_build_model(_jax_tiny(name)).init(jax.random.PRNGKey(0))
        tmp = d / f"{name}.tmp.npz"
        np.savez(tmp, **_np_flat(params))
        os.replace(tmp, d / f"{name}.npz")
    _dump(d / f"jax_train_{model}.pkl", jax_train_run(model))
    _dump(d / f"jax_serve_{model}.pkl", jax_serve_run(model, d))


# ---------------------------------------------------------------------------
# the runs: three JAX subprocesses beside one spawn of 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("family_tp")
    for model in ranks.MODELS:
        np.save(d / f"{model}_tokens.npy",
                prompt_tokens(ranks.tiny_config(model), ranks.BATCH, ranks.PROMPT).numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "--jax", model, str(d)], env=env,
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for model in ranks.JAX_MODELS]
    try:
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
    for model, p, log in zip(ranks.JAX_MODELS, procs, logs):
        assert p.returncode == 0, log[-4000:]
        for kind in ("train", "serve"):
            with open(d / f"jax_{kind}_{model}.pkl", "rb") as fh:
                jres[(kind, model)] = pickle.load(fh)
    return SimpleNamespace(ranks=out, jax=jres, dir=d)


def _leaders(runs, kind, case):
    """The first rank of each mesh laid over the world for ``case``."""
    return sorted({runs.ranks[r][kind][case]["mesh_ranks"][0] for r in range(ranks.WORLD)})


def _port_params(model: str, flat_np: dict) -> dict:
    return params_from_jax(flat_np, device="cpu", cfg=ranks.tiny_config(model), flat=True)[0]


def _assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", TRAIN)
def test_sharded_round_matches_single_device(runs, case):
    for r in _leaders(runs, "train", case):
        res = runs.ranks[r]["train"][case]
        np.testing.assert_allclose(res["losses"], res["single_losses"], **TOL)
        assert len(res["params"]) == ranks.ROUNDS
        for got, want in zip(res["params"], res["single_params"]):
            _assert_params_close(got, want)


@pytest.mark.parametrize("case", JAX_TRAIN)
def test_sharded_round_matches_jax_sharded_step(runs, case):
    model = ranks.TRAIN_CASES[case][0]
    want = runs.jax[("train", model)]
    for r in _leaders(runs, "train", case):
        res = runs.ranks[r]["train"][case]
        np.testing.assert_allclose(res["losses"], want["losses"], **TOL)
        for got, w in zip(res["params"], want["params"]):
            _assert_params_close(got, _port_params(model, w))


@pytest.mark.parametrize("case", TRAIN)
def test_whole_leaves_are_bit_identical_on_every_rank(runs, case):
    """After each round, every leaf the rules leave whole (norms, Mamba2's
    f32 leaves, the mLSTM's gate biases, the sLSTM's recurrence, KV
    projections on whole KV heads, a vocabulary 4 ranks do not divide) has
    the same bits on every rank of the mesh; a split leaf the same on the
    ranks of its model coordinate."""
    by_rank = [runs.ranks[r]["train"][case] for r in range(ranks.WORLD)]
    for r, res in enumerate(by_rank):
        lead = by_rank[res["mesh_ranks"][0]]
        assert len(res["replicated"]) == ranks.ROUNDS and res["replicated"][0]
        for rnd, leaves in enumerate(res["replicated"]):
            assert set(leaves) == set(lead["replicated"][rnd])
            for name, t in leaves.items():
                assert torch.equal(t, lead["replicated"][rnd][name]), (r, rnd, name)
        for other in by_rank:
            if other["mesh_ranks"] == res["mesh_ranks"] and other["coords"][1] == res["coords"][1]:
                for name in res["split_leaves"]:
                    assert torch.equal(other["local"][name], res["local"][name]), (r, name)


@pytest.mark.parametrize("case", TRAIN)
def test_counters_equal_tp_collective_budget(runs, case):
    for r in range(ranks.WORLD):
        res = runs.ranks[r]["train"][case]
        assert len(res["counters"]) == ranks.ROUNDS
        for counted in res["counters"]:
            assert counted == res["budget"], (r, counted, res["budget"])
    assert runs.ranks[0]["train"][case]["budget"]["model"], "no model-axis collective"


@pytest.mark.parametrize("model", list(ranks.MODELS))
def test_shard_then_unshard_gives_the_input_back(runs, model):
    cases = [c for c, (m, _, _) in ranks.TRAIN_CASES.items() if m == model]
    for case in cases:
        assert all(runs.ranks[r]["train"][case]["round_trip"] for r in range(ranks.WORLD))
    split = set(runs.ranks[0]["train"][cases[-1]]["split_leaves"])
    mixer = {"zamba": "mamba.0.in_proj", "xlstm": "runs.0.m.0.up_x",
             "whisper": "encoder.0.attn.wq.w", "whisper_v2046": "decoder.0.ffn.wi"}[model]
    assert mixer in split
    assert ("lm_head" in split) == (model != "whisper_v2046")


@pytest.mark.parametrize("case", sorted(ranks.CKPT_CASES))
def test_gathered_checkpoint_loads_into_the_jax_package(runs, case):
    model = ranks.TRAIN_CASES[case][0]
    template = j_build_model(_jax_tiny(model)).abstract_params()
    back = _port_params(model, _np_flat(j_load(str(runs.dir / case), template)))
    want = runs.ranks[0]["train"][case]["params"][-1]
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _rows(res, b_local):
    d = res["coords"][0]
    return slice(d * b_local, (d + 1) * b_local)


@pytest.mark.parametrize("case", SERVE)
def test_sharded_serving_matches_single_device(runs, case):
    for r in range(ranks.WORLD):
        res = runs.ranks[r]["serve"][case]
        rows = _rows(res, res["tokens"].shape[0])
        assert len(res["logits"]) == ranks.GEN + 1
        for got, want in zip(res["logits"], res["single_logits"]):
            np.testing.assert_allclose(got.numpy(), want[rows].numpy(), **TOL)
        assert torch.equal(res["tokens"], res["single_tokens"][rows])
        assert res["cache_pos"] == ranks.PROMPT + ranks.GEN


@pytest.mark.parametrize("case", JAX_SERVE)
def test_sharded_serving_matches_jax_sharded_run(runs, case):
    want = runs.jax[("serve", ranks.SERVE_CASES[case][0])]
    for r in range(ranks.WORLD):
        res = runs.ranks[r]["serve"][case]
        rows = _rows(res, res["tokens"].shape[0])
        for got, w in zip(res["logits"], want["logits"]):
            np.testing.assert_allclose(got.numpy(), w[rows], **TOL)
        np.testing.assert_array_equal(res["tokens"].numpy(), want["tokens"][rows])


def _assert_cache_close(got, want, where):
    if isinstance(want, torch.Tensor):
        assert got.shape == want.shape, where
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=str(where), **TOL)
    elif isinstance(want, tuple):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_cache_close(g, w, where + (i,))
    else:
        assert got == want, where


def _bytes(cache) -> int:
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return sum(_bytes(c) for c in cache) if isinstance(cache, tuple) else 0


@pytest.mark.parametrize("case", SERVE)
def test_each_rank_holds_its_part_of_the_cache(runs, case):
    """After the prefill and after every step each rank's cache is
    ``local_cache`` of the one-device cache (its slots, ``slots`` and
    ``start`` too), and its bytes those of that part: the whole cache's
    over the model ranks but for xLSTM's stabilisers, which are whole."""
    for r in range(ranks.WORLD):
        res = runs.ranks[r]["serve"][case]
        assert len(res["caches"]) == len(res["want_caches"]) == ranks.GEN + 1
        for i, (got, want) in enumerate(zip(res["caches"], res["want_caches"])):
            _assert_cache_close(got, want, (r, i))
        assert res["cache_bytes"] == _bytes(res["want_caches"][0])
        model, (_, m) = ranks.SERVE_CASES[case]
        if model != "xlstm":          # xLSTM's stabilisers m are whole on every rank
            assert res["cache_bytes"] * m == res["single_cache_bytes"]


@pytest.mark.parametrize("case", SERVE)
def test_counters_equal_serve_collective_budget(runs, case):
    for r in range(ranks.WORLD):
        res = runs.ranks[r]["serve"][case]
        assert res["counters_prefill"] == res["budget"]["prefill"], r
        assert len(res["counters_steps"]) == ranks.GEN
        for counted in res["counters_steps"]:
            assert counted == res["budget"]["step"], (r, counted, res["budget"]["step"])
    step = runs.ranks[0]["serve"][case]["budget"]["step"]["model"]
    kv_merge = ranks.SERVE_CASES[case][0] != "xlstm"
    assert ("decode_merge" in step) == kv_merge
    assert ("mlstm_merge" in step) == (not kv_merge)


# ---------------------------------------------------------------------------
# the split and the rules without ranks
# ---------------------------------------------------------------------------


def _stand_in_mesh(shape, rank: int = 0) -> DeviceMesh:
    names = ("data", "model")
    mesh = DeviceMesh(names, tuple(shape), tuple(range(math.prod(shape))), rank,
                      torch.device("cpu"))
    coords = dict(zip(names, mesh.coords))
    mesh.axes = {n: CohortMesh(rank=coords[n], size=s, device=torch.device("cpu"), axis=n)
                 for n, s in zip(names, shape)}
    return mesh


def _split_at(cfg, shape, kind="train"):
    mesh = _stand_in_mesh(shape)
    rules = mesh_rules(cfg, mesh) if kind == "train" else serve_rules(cfg, mesh)
    set_rules(mesh, rules)
    try:
        return model_split(cfg)
    finally:
        clear_rules()


@pytest.mark.parametrize("arch", ["whisper_large_v3", "zamba2_1_2b", "xlstm_350m"])
@pytest.mark.parametrize("m", [2, 4])
def test_model_split_of_the_families_at_full_width(arch, m):
    """At the published widths every fused dim of the mixers divides 2 and
    4 model ranks; Whisper's 51,866-row vocabulary divides 2 only."""
    cfg = get_config(arch)
    split = _split_at(cfg, (1, m))
    if cfg.family == "audio":
        assert split.heads is not None and split.kv is not None and split.ffn is not None
        assert (split.vocab is not None) == (m == 2)
    elif cfg.family == "hybrid":
        assert split.ssm is not None and split.heads is not None and split.ffn is not None
    else:
        assert split.mlstm is not None and split.slstm is not None
        assert split.heads is None and split.ffn is None
    assert model_split(cfg) == transformer.NO_SPLIT


def test_model_split_refuses_a_partial_mixer_split():
    """SSM heads that the model axis does not divide, with the fused dims
    that it does: refused rather than split off the heads."""
    cfg = get_config("zamba2_1_2b").replace(ssm_heads=6, d_model=1536)
    with pytest.raises(NotImplementedError, match="Mamba2"):
        _split_at(cfg, (1, 4))


@pytest.mark.parametrize("arch", ["whisper_large_v3", "zamba2_1_2b", "xlstm_350m"])
def test_serve_rules_split_the_caches_by_their_specs(arch):
    cfg = ranks.tiny_config({"whisper_large_v3": "whisper", "zamba2_1_2b": "zamba",
                             "xlstm_350m": "xlstm"}[arch])
    mesh = _stand_in_mesh((1, 2))
    specs = cache_specs(mesh, serve_rules(cfg, mesh),
                        build_model(cfg).init_cache(4, 20, device="meta"))
    if cfg.family == "ssm":
        assert specs.m_states[0].c == (None, "data", None, "model", None)
        assert specs.s_states[0].h == (None, "data", "model")
    else:
        assert specs.k == (None, "data", None, "model", None)


def test_serve_budget_prices_a_mamba2_step_in_f32():
    """A Mamba2 step's SSM output is f32 in any model dtype (the reference
    promotes), so ``ssm_out`` in a bf16 step costs what it does in f32,
    while the prefill's and the attention's halve."""
    cfg = ranks.tiny_config("zamba")
    mesh = _stand_in_mesh((1, 2))
    got = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        got[dtype] = plan_budget(c, mesh)
    f32, bf16 = got["float32"], got["bfloat16"]
    assert bf16["step"]["model"]["ssm_out"] == f32["step"]["model"]["ssm_out"]
    for phase, tag in (("prefill", "ssm_out"), ("step", "attn_out"), ("step", "ssm_proj")):
        assert 2 * bf16[phase]["model"][tag]["bytes"] == f32[phase]["model"][tag]["bytes"]


def plan_budget(cfg, mesh):
    from repro_torch.federated.plan import serve_collective_budget
    return serve_collective_budget(cfg, mesh, 4, 16, 4, rules=serve_rules(cfg, mesh))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        sys.path.insert(0, str(ROOT / "tests"))
        jax_main(sys.argv[2], sys.argv[3])
