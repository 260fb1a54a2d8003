"""Port parity, the transformer served on a ``(data, model)`` mesh of
``torch.distributed`` ranks under ``make_rules("decode")``: the KV cache split
by sequence over ``model`` and K4's per-rank partials merged by their
log-sum-exp.

One spawn of 4 gloo ranks on the host (``tests/torch_serve_tp_ranks.py``)
serves the tiny models of ``repro_torch.launch.serve.SCALES`` through
``serve(..., mesh=...)``, a prefill and 6 greedy steps, on ``(1, 2)``,
``(2, 2)`` and ``(1, 4)`` meshes laid over one world: Qwen2.5's dense layers,
Mixtral's MoE in its tensor-parallel baseline and expert parallel with a
prompt past its 32-slot window (the ring split over the ranks), Qwen3's QK
norms, Qwen2-VL's patches and M-RoPE, a capacity the model axis does not
divide (the cache whole on every model rank) and 6 query heads on 4 ranks
(whole heads, the sequence still split). The ranks' results are held to:

- the JAX package's ``prefill`` and ``decode_step`` under
  ``make_rules("decode")`` completed as the dry run completes it, on an
  Auto-typed ``(data, model)`` mesh of 4 virtual CPU devices, from two
  subprocesses (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
  every step's logits within 1e-5, the greedy tokens identical;
- the port's single-device serving of the same prompts, the same way;
- ``serve_collective_budget``: each rank's counters of the prefill and of
  every step, per axis and tag;
- the cache's bytes on each rank: the whole cache's over the ranks that
  split it.

Plus K4's log-sum-exp form against float64 (empty slices and rows with no
valid slot included), the in-process merge of 2 and 4 slices against
whole-cache K4, a slice's cache writes, and ``cache_specs`` for the four
cache families against ``shard_cache_sds``'s specs.

Run as a script (``--jax-serve OUT CASES``) this file is one of those
subprocesses (two run side by side, each on some of the cases).
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

import torch_serve_tp_ranks as ranks
from repro_torch.configs.base import get_config
from repro_torch.convert import _flatten
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_torch
from repro_torch.launch.mesh import CohortMesh, DeviceMesh, spawn_ranks
from repro_torch.launch.serve import SCALES
from repro_torch.launch.shardings import cache_specs, local_cache, shard_cache
from repro_torch.models import layers
from repro_torch.models.api import build_model
from repro_torch.sharding import complete_rules, make_rules
from repro_torch.sharding.parallel import merge_decode_slices

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT_S = 240.0
CASES = list(ranks.CASES)
#: the JAX cases of each subprocess: two run side by side
JAX_SPLIT = (("qwen_1x2", "qwen_2x2", "mixtral_tp_2x2", "vlm_1x2", "heads6_1x4"),
             ("qwen_1x4", "mixtral_ep_1x2", "qwen3_1x4", "whole_cache_1x2"))
#: cache_specs' cases: family -> arch; meshes; (batch, max_seq)
SPEC_ARCHS = {"transformer": "mixtral_8x22b", "whisper": "whisper_large_v3",
              "zamba": "zamba2_1_2b", "xlstm": "xlstm_350m"}
SPEC_MESHES = ((1, 2), (2, 2), (1, 4))
SPEC_SIZES = ((4, 24), (1, 19))


def _jax_tiny(arch: str, **over):
    cfg = j_get_config(arch)
    scale = dict(J_SCALES["tiny"])
    if cfg.family == "ssm":
        scale.pop("d_ff", None)
    return cfg.replace(**scale).replace(**over)


def _port_tiny(arch: str):
    cfg = get_config(arch)
    scale = dict(SCALES["tiny"])
    if cfg.family == "ssm":
        scale.pop("d_ff", None)
    return cfg.replace(**scale)


def _auto_mesh(shape):
    from jax.sharding import AxisType

    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])


def _decode_rules(cfg, shape, expert_parallel=False) -> dict:
    """``make_rules("decode")`` completed as ``launch/dryrun.py:110-115``."""
    from repro.sharding.rules import make_rules as j_make_rules

    mdl = shape[1]
    return dict(j_make_rules("decode", expert_parallel=expert_parallel),
                heads_act=("model",) if cfg.num_heads % mdl == 0 else None,
                kv_act=("model",) if (cfg.num_kv_heads % mdl == 0
                                      and cfg.num_heads % mdl == 0) else None)


def jax_serve_run(case: str, in_dir: Path) -> dict:
    """The reference's serving loop (``repro/launch/serve.py``) on an
    Auto-typed mesh: ``prefill`` then ``GEN`` greedy ``decode_step``s."""
    import jax.numpy as jnp

    from repro.sharding.context import clear_rules as j_clear, set_rules as j_set

    arch, shape, ep, over, prompt = ranks.CASES[case]
    cfg = _jax_tiny(arch, **over)
    mesh = _auto_mesh(shape)
    j_set(mesh, _decode_rules(cfg, shape, ep))
    inputs = dict(np.load(in_dir / f"{case}_inputs.npz"))
    try:
        api = j_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(inputs["tokens"])}
        for key in ("patch_embeds", "mrope_pos"):
            if key in inputs:
                batch[key] = jnp.asarray(inputs[key])
        with jax.set_mesh(mesh):
            cache = api.init_cache(ranks.BATCH, prompt + ranks.GEN)
            logits, cache = jax.jit(api.prefill)(params, batch, cache)
            decode = jax.jit(api.decode_step)
            out, toks = [np.asarray(logits)], []
            for i in range(ranks.GEN):
                nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                step = {"tokens": nxt}
                if "steps_pos" in inputs:
                    step["mrope_pos"] = jnp.asarray(inputs["steps_pos"][i])
                logits, cache = decode(params, cache, step)
                out.append(np.asarray(logits))
                toks.append(np.asarray(nxt))
    finally:
        j_clear()
    return {"logits": out, "tokens": np.stack(toks, 1)}


def jax_cache_specs() -> dict:
    """``shard_cache_sds``'s spec of every leaf of each family's cache, per
    mesh and size, under the completed decode rules."""
    from repro.launch.shardings import shard_cache_sds

    out = {}
    for family, arch in SPEC_ARCHS.items():
        cfg = _jax_tiny(arch)
        api = j_build_model(cfg)
        for shape in SPEC_MESHES:
            mesh = _auto_mesh(shape)
            for b, s in SPEC_SIZES:
                sds = shard_cache_sds(mesh, _decode_rules(cfg, shape),
                                      api.init_cache(b, s, abstract=True))
                out[(family, shape, b, s)] = [tuple(x.sharding.spec)
                                              for x in jax.tree.leaves(sds)]
    return out


def jax_serve_main(out_path: str, names: str, in_dir: str) -> None:
    """Subprocess body: the JAX cases named (comma-separated), and the cache
    specs with the first group, pickled to ``out_path``."""
    assert len(jax.devices()) == 4, jax.devices()
    res = {name: jax_serve_run(name, Path(in_dir)) for name in names.split(",")}
    if names.split(",")[0] == JAX_SPLIT[0][0]:
        res["cache_specs"] = jax_cache_specs()
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the runs: two JAX subprocesses beside one spawn of 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_tp")
    for case in CASES:
        np.savez(d / f"{case}_inputs.npz", **ranks.case_inputs(case))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "--jax-serve", str(d / f"jax{i}.pkl"),
                               ",".join(names), str(d)], env=env, cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, names in enumerate(JAX_SPLIT)]
    try:
        done = set()
        for case in CASES:
            key = ranks.init_key(case)
            if key not in done:
                arch, _, _, over, _ = ranks.CASES[case]
                over = {k: v for k, v in over.items() if k == "num_heads"}
                params = j_build_model(_jax_tiny(arch, **over)).init(jax.random.PRNGKey(0))
                np.savez(d / f"{key}.npz", **_flatten(jax.tree.map(np.asarray, unbox(params))))
                done.add(key)
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


def _rows(res, b_local):
    d = res["coords"][0]
    return slice(d * b_local, (d + 1) * b_local)


@pytest.mark.parametrize("case", CASES)
def test_sharded_serving_matches_single_device(runs, case):
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        rows = _rows(res, res["tokens"].shape[0])
        assert len(res["logits"]) == ranks.GEN + 1
        for got, want in zip(res["logits"], res["single_logits"]):
            np.testing.assert_allclose(got.numpy(), want[rows].numpy(), **TOL)
        assert torch.equal(res["tokens"], res["single_tokens"][rows])
        assert res["cache_pos"] == ranks.CASES[case][4] + ranks.GEN


@pytest.mark.parametrize("case", CASES)
def test_sharded_serving_matches_jax_sharded_run(runs, case):
    want = runs.jax[case]
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        rows = _rows(res, res["tokens"].shape[0])
        for got, w in zip(res["logits"], want["logits"]):
            np.testing.assert_allclose(got.numpy(), w[rows], **TOL)
        np.testing.assert_array_equal(res["tokens"].numpy(), want["tokens"][rows])


@pytest.mark.parametrize("case", CASES)
def test_counters_equal_serve_collective_budget(runs, case):
    shape = ranks.CASES[case][1]
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        assert res["counters_prefill"] == res["budget"]["prefill"], r
        assert len(res["counters_steps"]) == ranks.GEN
        for counted in res["counters_steps"]:
            assert counted == res["budget"]["step"], (r, counted, res["budget"]["step"])
    step = runs.ranks[0][case]["budget"]["step"]["model"]
    if shape[1] > 1:
        assert step, "a model split with no model-axis collective"
    assert ("decode_merge" in step) == (case != "whole_cache_1x2")


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_part_of_the_cache(runs, case):
    _, (data, model), _, over, prompt = ranks.CASES[case]
    cap = prompt + ranks.GEN
    if "sliding_window" in over:
        cap = min(cap, over["sliding_window"])
    parts = (data if ranks.BATCH % data == 0 else 1) * (model if cap % model == 0 else 1)
    for r in range(ranks.WORLD):
        res = runs.ranks[r][case]
        assert res["cache_bytes"] * parts == res["single_cache_bytes"]


# ---------------------------------------------------------------------------
# the cache's layout against the JAX package's
# ---------------------------------------------------------------------------


def _stand_in_mesh(shape, rank: int = 0) -> DeviceMesh:
    names = ("data", "model")
    mesh = DeviceMesh(names, tuple(shape), tuple(range(math.prod(shape))), rank,
                      torch.device("cpu"))
    coords = dict(zip(names, mesh.coords))
    mesh.axes = {n: CohortMesh(rank=coords[n], size=s, device=torch.device("cpu"), axis=n)
                 for n, s in zip(names, shape)}
    return mesh


def _spec_leaves(specs) -> list:
    """The specs of ``cache_specs`` in ``jax.tree.leaves``' order (a KV
    cache's host ints, ``slots`` and ``start``, are not leaves there)."""
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return [x for field in specs for x in _spec_leaves(field)]
    if isinstance(specs, tuple) and specs and isinstance(specs[0], tuple) \
            and hasattr(specs[0], "_fields"):
        return [x for st in specs for x in _spec_leaves(st)]
    return [specs] if isinstance(specs, tuple) else []


@pytest.mark.parametrize("family", list(SPEC_ARCHS))
def test_cache_specs_match_shard_cache_sds(runs, family):
    cfg = _port_tiny(SPEC_ARCHS[family])
    api = build_model(cfg)
    for shape in SPEC_MESHES:
        rules = complete_rules(cfg, make_rules("decode"), shape[1])
        for b, s in SPEC_SIZES:
            got = _spec_leaves(cache_specs(_stand_in_mesh(shape), rules,
                                           api.init_cache(b, s, device="meta")))
            want = runs.jax["cache_specs"][(family, shape, b, s)]
            assert [tuple(g) for g in got] == [tuple(w) for w in want], (shape, b, s)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_local_cache_is_the_rank_slice_of_the_whole(shape):
    cfg = _port_tiny("mixtral_8x22b").replace(sliding_window=32)
    api = build_model(cfg)
    rules = complete_rules(cfg, make_rules("decode"), shape[1])
    whole = api.init_cache(4, 40, device="cpu")
    whole = whole._replace(k=torch.randn(whole.k.shape), v=torch.randn(whole.v.shape))
    width = 32 // shape[1]
    for rank in range(math.prod(shape)):
        mesh = _stand_in_mesh(shape, rank)
        d, m = mesh.coords
        part = local_cache(whole, mesh, rules)
        made = shard_cache(api.init_cache, 4, 40, mesh, rules, device="cpu")
        b = 4 // shape[0]
        assert part.k.shape == made.k.shape == (cfg.num_layers, b, cfg.num_kv_heads, width,
                                                cfg.head_dim)
        assert (part.slots, part.start) == (made.slots, made.start) == (32, m * width)
        assert part.capacity == 32
        assert torch.equal(part.k, whole.k[:, d * b:(d + 1) * b, :, m * width:(m + 1) * width])


def test_cache_write_reaches_only_the_owner_of_the_slot():
    cap, width = 8, 4
    whole = torch.zeros(2, 3, cap, 5)
    parts = [torch.zeros(2, 3, width, 5) for _ in range(2)]
    for pos in range(11):
        new = torch.full((2, 3, 5), float(pos + 1))
        layers.cache_write(whole, whole.clone(), pos, new, new, True)
        for r, part in enumerate(parts):
            layers.cache_write(part, part.clone(), pos, new, new, True, cap, r * width)
        assert torch.equal(torch.cat(parts, dim=2), whole), pos


def test_registry_launches_the_log_sum_exp_merge_at_a_rank_slice():
    """The audit registry's K4 entry holds the merge's log-sum-exp instance
    at the ranks' slices (Qwen2.5-14B's at hd 128, Whisper's and Zamba2's
    at hd 64): ``flash_decode_instance`` index 16 + 4 * bf16 + the head
    dim's, and its cost model prices the f32 o and the lse."""
    from repro_torch.analysis.kernel_audit import cost_model, plan_coverage
    from repro_torch.kernels import introspect

    k4 = introspect.entry("flash_decode")
    slices = [a for a in k4.shapes if a.shape.get("lse")]
    assert [(a.shape["S"], a.shape["hd"]) for a in slices] == [(2064, 128), (1032, 128),
                                                               (750, 64), (66, 64)]
    for a in slices:
        split, merge = introspect.launches(k4, a.shape)
        hd = a.shape["hd"]
        assert (merge.index, merge.label) == (
            {128: 23, 64: 22}[hd], f"merge_kernel<__nv_bfloat16, {hd}, true>")
        assert plan_coverage(k4, a.shape, (split, merge)) == []
    base = dict(b=4, h=40, kv=8, hd=128, n_valid=2064, slots=2064, dtype="bf16")
    extra = cost_model("flash_decode", lse=True, **base).bytes - cost_model(
        "flash_decode", **base).bytes
    assert extra == 4 * 40 * (128 * 4 + 4) - 4 * 40 * 128 * 2


# ---------------------------------------------------------------------------
# K4's log-sum-exp form and the merge of its slices
# ---------------------------------------------------------------------------


def _decode_inputs(seed, b=2, h=8, kv=2, s=48, hd=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h, hd, generator=g), torch.randn(b, kv, s, hd, generator=g),
            torch.randn(b, kv, s, hd, generator=g))


def _f64_lse(q, k, v, kpos, qpos, window):
    b, h, hd = q.shape
    kvh = k.shape[1]
    s = torch.einsum("bkgd,bksd->bkgs", q.double().reshape(b, kvh, h // kvh, hd),
                     k.double()) / math.sqrt(hd)
    valid = (kpos >= 0) & (kpos <= qpos)
    if window > 0:
        valid &= kpos > qpos - window
    if not bool(valid.any()):
        o = v.double().mean(dim=2, keepdim=True).expand(b, kvh, h // kvh, hd)
        return o.reshape(b, h, hd), torch.full((b, h), -math.inf, dtype=torch.float64)
    s = torch.where(valid, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", torch.exp(s - lse[..., None]), v.double())
    return o.reshape(b, h, hd), lse.reshape(b, h)


#: (name, written, ring, window): slot positions over 48 slots
LSE_CASES = [("full", 48, False, 0), ("partial", 20, False, 0), ("ring", 100, True, 0),
             ("window", 100, True, 20), ("empty", 0, False, 0)]


@pytest.mark.parametrize("name,written,ring,window", LSE_CASES)
def test_flash_decode_lse_against_float64(name, written, ring, window):
    q, k, v = _decode_inputs(1)
    kpos = layers.cache_slot_positions(written, 48, ring)
    qpos = max(written - 1, 0)
    o, lse = flash_decode_torch(q, k, v, kpos, qpos, window=window, return_lse=True)
    assert o.dtype == lse.dtype == torch.float32
    want_o, want_lse = _f64_lse(q, k, v, kpos, qpos, window)
    np.testing.assert_allclose(o.double().numpy(), want_o.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.double().numpy(), want_lse.numpy(), rtol=1e-6, atol=1e-6)
    # the wrapper takes the plain version on the host
    o2, lse2 = flash_decode(q, k, v, kpos, qpos, window=window, return_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("nslices", [2, 4])
@pytest.mark.parametrize("name,written,ring,window", LSE_CASES)
def test_merged_slices_equal_whole_cache_decode(nslices, name, written, ring, window):
    """The in-process merge of K4's per-slice partials against K4 on the
    whole cache: slices with no valid slot weigh nothing, and a row with none
    on any slice is the mean of V over every slot."""
    q, k, v = _decode_inputs(2)
    kpos = layers.cache_slot_positions(written, 48, ring)
    qpos = max(written - 1, 0)
    width = 48 // nslices
    parts = [flash_decode_torch(q, k[:, :, i * width:(i + 1) * width].contiguous(),
                                v[:, :, i * width:(i + 1) * width].contiguous(),
                                kpos[i * width:(i + 1) * width].contiguous(), qpos,
                                window=window, return_lse=True) for i in range(nslices)]
    if name == "partial":
        assert any(torch.isinf(lse).all() for _, lse in parts), "no empty slice"
    got = merge_decode_slices([o for o, _ in parts], [lse for _, lse in parts], torch.float32)
    want = flash_decode_torch(q, k, v, kpos, qpos, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-serve"]:
        sys.path.insert(0, str(ROOT / "tests"))
        jax_serve_main(sys.argv[2], sys.argv[3], sys.argv[4])
