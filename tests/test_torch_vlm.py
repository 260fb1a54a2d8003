"""Port parity, the VLM slice: Qwen2-VL 7B (M-RoPE, patch embeddings) and
Llama 4 Maverick (early-fusion patches, a top-1 MoE). ``layers.apply_mrope``
against the reference's in f32 and bf16, with three distinct streams (where
plain RoPE differs) and with equal ones (where it is RoPE);
``embed_tokens`` with patches; both smoke configurations through
``repro_torch`` against ``repro.models.build_model`` on the weights of
``PRNGKey(0)`` (carried across by ``convert.params_from_jax``) with patch
embeddings and image-grid streams: forward, ``loss_fn`` and every
gradient, prefill logits and cache, 4 greedy decode steps, Llama 4's
``expert_tokens`` exact; the microbatch split keyed on the leaf's name
(``mrope_pos`` on its axis 1) in ``_microbatches`` and in the flat shard's
per-rank slice; the launchers on both smoke configurations; the factory's
sliced draw. f32 within 1e-5, bf16 within 2e-2."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.federated import make_round_step as j_make_round_step
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig, get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.federated import plan as plan_mod
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import layers, transformer
from repro_torch.models.api import build_model

QWEN, LLAMA = "qwen2_vl_7b", "llama4_maverick_400b_a17b"
ARCHS = (QWEN, LLAMA)
TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16: both round every activation to 8 bits of mantissa, at places that
#: differ (XLA fuses, eager PyTorch rounds after each op). Held in relative
#: norm at 2e-2, and elementwise at ``tests/test_torch_serve.py``'s 0.1:
#: after two layers a few elements of magnitude 2-4 sit two bf16 ulps
#: (0.016 each) apart
BF16_REL = 2e-2
BF16_TOL = dict(rtol=0.1, atol=0.1)
#: the smoke configs' 8 patches as a 2 x 4 image grid
GRID = (2, 4)


# ---------------------------------------------------------------------------
# apply_mrope and embed_tokens
# ---------------------------------------------------------------------------


def _streams(b, s, seed):
    """Three distinct position streams (3, B, S)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 4, (b, s)), rng.integers(0, 64, (b, s)),
                     rng.integers(0, 512, (b, s))]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 4, 32)).astype(np.float32)
    pos3 = _streams(2, 24, 1)
    sections = (4, 6, 6)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(transformer.DTYPES[dtype])
    want = j_layers.apply_mrope(jx, jnp.asarray(pos3), 1e6, sections)
    got = layers.apply_mrope(tx, torch.from_numpy(pos3), 1e6, sections)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    # the reference's one-hot product summed over the streams, in torch: it
    # adds two exact zeros to each angle, so the index selection is bit-exact
    freqs = layers.rope_freqs(32, 1e6)
    angles_all = torch.from_numpy(pos3)[..., None].float() * freqs
    sel = torch.nn.functional.one_hot(torch.tensor(layers.mrope_streams(32, sections)), 3)
    angles = (angles_all * sel.T.float().reshape(3, 1, 1, 16)).sum(0)
    x1, x2 = tx.float().chunk(2, dim=-1)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    one_hot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(tx.dtype)
    assert torch.equal(got, one_hot)
    # each stream reaches its own slots: RoPE on any one stream is another function
    for stream in range(3):
        rope = layers.apply_rope(tx, torch.from_numpy(pos3[stream]), 1e6)
        assert float((rope.float() - got.float()).abs().max()) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_with_equal_streams_is_rope(dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 16, 2, 64)).astype(np.float32)).to(
        transformer.DTYPES[dtype])
    pos = torch.from_numpy(rng.integers(0, 1000, (3, 16)).astype(np.int32))
    got = layers.apply_mrope(x, pos.expand(3, 3, 16), 1e4, (8, 12, 12))
    assert torch.equal(got, layers.apply_rope(x, pos, 1e4))


@pytest.mark.parametrize("sections", [(16, 24, 24), (4, 6, 6), (2, 2, 2), (8, 12, 12)])
def test_mrope_streams_follow_repeat_with_total_length(sections):
    """Sections that overrun head_dim / 2 are cut and short ones padded
    with the last stream, as ``jnp.repeat(..., total_repeat_length=)``."""
    for hd in (16, 32, 64, 128):
        want = np.asarray(jnp.repeat(jnp.arange(3), jnp.array(sections),
                                     total_repeat_length=hd // 2))
        assert layers.mrope_streams(hd, sections) == want.tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_tokens_with_patches(arch):
    jcfg = j_get_smoke_config(arch).replace(dtype="float32")
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(tcfg.vocab_size, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (2, 20)).astype(np.int32)
    patches = rng.normal(size=(2, tcfg.num_patches, tcfg.d_model)).astype(np.float32)
    want = j_transformer.embed_tokens(jcfg, {"embedding": jnp.asarray(emb)}, jnp.asarray(toks),
                                      jnp.asarray(patches))
    got = transformer.embed_tokens(tcfg, {"embedding": torch.from_numpy(emb)},
                                   torch.from_numpy(toks), torch.from_numpy(patches))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the patches replace the first positions, unscaled; the rest are scaled tokens
    np.testing.assert_array_equal(got[:, :tcfg.num_patches].numpy(), patches)
    no_patch = transformer.embed_tokens(tcfg.replace(num_patches=0),
                                        {"embedding": torch.from_numpy(emb)},
                                        torch.from_numpy(toks), torch.from_numpy(patches))
    np.testing.assert_array_equal(no_patch[:, tcfg.num_patches:].numpy(),
                                  got[:, tcfg.num_patches:].numpy())


def test_image_grid_positions():
    pos = serve_mod.image_grid_positions(2, 12, *GRID).numpy()
    assert pos.shape == (3, 2, 12) and pos.dtype == np.int32
    np.testing.assert_array_equal(pos[:, 0, :8], [[0] * 8, [0, 0, 0, 0, 1, 1, 1, 1],
                                                  [0, 1, 2, 3, 0, 1, 2, 3]])
    np.testing.assert_array_equal(pos[:, 1, 8:], [[4, 5, 6, 7]] * 3)
    np.testing.assert_array_equal(serve_mod.decode_mrope_pos(torch.from_numpy(pos), 3)[2, :, :, 0],
                                  [[10, 10]] * 3)


# ---------------------------------------------------------------------------
# the smoke configurations against the JAX package
# ---------------------------------------------------------------------------


def _pair(arch, dtype="float32", flat=False, **over):
    """(JAX cfg, JAX api, JAX params, port api, port params, axes)."""
    jcfg = j_get_smoke_config(arch).replace(dtype=dtype, **over)
    tcfg = get_smoke_config(arch).replace(dtype=dtype, **over)
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu",
                                   cfg=tcfg, flat=flat)
    return jcfg, japi, jp, tapi, params, axes


def _inputs(cfg, b, s, seed):
    """Tokens, random patch embeddings and (M-RoPE) image-grid streams."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "patch_embeds": rng.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    if cfg.mrope:
        out["mrope_pos"] = serve_mod.image_grid_positions(b, s, *GRID).numpy()
    return out


def _jax(batch, dtype="float32"):
    return {k: jnp.asarray(v, jnp.dtype(dtype)) if k == "patch_embeds" else jnp.asarray(v)
            for k, v in batch.items()}


def _torch(batch, dtype="float32"):
    return {k: torch.from_numpy(v).to(transformer.DTYPES[dtype]) if k == "patch_embeds"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, dtype, name=""):
    """``got`` (torch) against ``want`` (JAX): 1e-5 in f32; in bf16 2e-2 in
    relative norm and ``BF16_TOL`` elementwise."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32)) if hasattr(want, "astype") else want
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        return
    np.testing.assert_allclose(got, want, err_msg=name, **BF16_TOL)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= BF16_REL, (name, rel)


def _stacked(flat_port):
    out, by_layer = {}, {}
    for name, t in flat_port.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            by_layer.setdefault(f"layers.{rest}", {})[int(i)] = t.detach().float().numpy()
        else:
            out[name] = t.detach().float().numpy()
    for name, d in by_layer.items():
        out[name] = np.stack([d[i] for i in range(len(d))])
    return out


@contextlib.contextmanager
def record_expert_tokens(jax_out: list, port_out: list, moe: bool = True):
    """Each side's ``moe`` calls' ``expert_tokens``, the JAX side run
    eagerly (``jax.disable_jit``: ``lax.scan`` runs its body per layer);
    nothing for a dense model, which runs jitted."""
    if not moe:
        yield
        return
    j_inner, t_inner = j_layers.moe, layers.moe

    def j_moe(p, x, **kw):
        out, stats = j_inner(p, x, **kw)
        jax_out.append(np.asarray(stats.expert_tokens))
        return out, stats

    def t_moe(p, x, **kw):
        out, stats = t_inner(p, x, **kw)
        port_out.append(stats.expert_tokens.numpy())
        return out, stats

    j_layers.moe, layers.moe = j_moe, t_moe
    try:
        with jax.disable_jit():
            yield
    finally:
        j_layers.moe, layers.moe = j_inner, t_inner


def test_trees_carry_across():
    """``params_from_jax`` on both trees: Qwen2-VL's QKV biases, Llama 4's
    experts (E, d, ff) per layer, every leaf equal."""
    for arch in ARCHS:
        _, japi, jp, _, params, axes = _pair(arch, flat=True)
        cfg = japi.cfg
        want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
        got = _stacked(params)
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        if cfg.qkv_bias:
            assert params["layers.0.attn.wk.b"].shape == (cfg.num_kv_heads * cfg.head_dim,)
        if cfg.is_moe:
            assert params["layers.1.ffn.wi"].shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
            assert axes["layers.1.ffn.wi"] == ("experts", "embed", "ffn")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dtype):
    jcfg, _, jp, tapi, model, _ = _pair(arch, dtype)
    b = _inputs(jcfg, 3, 64, 1)
    jb, tb = _jax(b, dtype), _torch(b, dtype)
    j_rec, t_rec = [], []
    with record_expert_tokens(j_rec, t_rec, jcfg.is_moe):
        jout = j_transformer.forward(jcfg, jp, jb["tokens"], patch_embeds=jb["patch_embeds"],
                                     mrope_pos=jb.get("mrope_pos"), remat=False)
        with torch.no_grad():
            tout = transformer.forward(tapi.cfg, model, tb["tokens"],
                                       patch_embeds=tb["patch_embeds"],
                                       mrope_pos=tb.get("mrope_pos"))
    _close(tout.hidden, jout.hidden, dtype, "hidden")
    _close(tout.aux_loss, jout.aux_loss, dtype, "aux")
    assert len(j_rec) == len(t_rec) == (jcfg.num_layers if jcfg.is_moe else 0)
    for j, t in zip(j_rec, t_rec):
        np.testing.assert_array_equal(t, j)
    if dtype == "float32" and jcfg.mrope:
        # the streams matter: plain RoPE over the same tokens is another model
        with torch.no_grad():
            rope = transformer.forward(tapi.cfg, model, tb["tokens"],
                                       patch_embeds=tb["patch_embeds"])
        assert float((rope.hidden - tout.hidden).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, japi, jp, tapi, params, _ = _pair(arch, flat=True)
    b = _inputs(jcfg, 3, 64, 2)
    b["mask"] = (np.random.default_rng(3).random((3, 64)) < 0.8).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jp, _jax(b))
    tg, tl = torch.func.grad_and_value(tapi.loss)(params, _torch(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = _stacked(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)
    assert np.abs(got["layers.attn.wq.w"]).max() > 0


def _serve_both(arch, dtype, prompt_len=24, gen=4):
    """Prefill with patches (and grid streams), then ``gen`` greedy steps
    whose M-RoPE streams continue from the prompt's largest position."""
    jcfg, japi, jp, tapi, model, _ = _pair(arch, dtype)
    b = _inputs(jcfg, 2, prompt_len, 4)
    prompt = {k: v for k, v in b.items()}
    cap = prompt_len + gen
    j_rec, t_rec = [], []
    steps = []
    moe = jcfg.is_moe
    prefill, decode = ((japi.prefill, japi.decode_step) if moe
                       else (jax.jit(japi.prefill), jax.jit(japi.decode_step)))
    with record_expert_tokens(j_rec, t_rec, moe):
        jcache = japi.init_cache(2, cap)
        jl, jcache = prefill(jp, _jax(prompt, dtype), jcache)
        tl, tcache = tapi.prefill(model, _torch(prompt, dtype), tapi.init_cache(2, cap, "cpu"))
        snap = lambda c: c._replace(k=c.k.clone(), v=c.v.clone())    # noqa: E731
        steps.append((jl, tl, jcache, snap(tcache)))
        dec = (serve_mod.decode_mrope_pos(torch.from_numpy(b["mrope_pos"]), gen)
               if jcfg.mrope else None)
        for i in range(gen):
            jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
            tn = torch.argmax(tl, dim=-1).to(torch.int32)
            np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
            jstep, tstep = {"tokens": jn}, {"tokens": tn}
            if dec is not None:
                jstep["mrope_pos"], tstep["mrope_pos"] = jnp.asarray(dec[i].numpy()), dec[i]
            jl, jcache = decode(jp, jcache, jstep)
            tl, tcache = tapi.decode_step(model, tcache, tstep)
            steps.append((jl, tl, jcache, snap(tcache)))
    return jcfg, steps, j_rec, t_rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, steps, j_rec, t_rec = _serve_both(arch, dtype)
    for i, (jl, tl, jcache, tcache) in enumerate(steps):
        _close(tl, jl, dtype, f"logits {i}")
        _close(tcache.k, jcache.k, dtype, f"k {i}")
        _close(tcache.v, jcache.v, dtype, f"v {i}")
    assert steps[-1][3].pos == int(steps[-1][2].pos) == 28
    # prefill and 4 decode steps, one MoE call per layer each
    assert len(j_rec) == len(t_rec) == (5 * jcfg.num_layers if jcfg.is_moe else 0)
    for j, t in zip(j_rec, t_rec):
        # in bf16, XLA on the CPU skips the bf16 rounding of the router
        # product and a decode step's top-1 can flip: the count holds there
        if dtype == "float32":
            np.testing.assert_array_equal(t, j)
        assert t.sum() == j.sum()


# ---------------------------------------------------------------------------
# the batch split keyed on the leaf's name
# ---------------------------------------------------------------------------


def test_microbatches_split_mrope_pos_on_its_batch_axis():
    data = {"tokens": torch.arange(24).reshape(4, 6),
            "mrope_pos": torch.arange(72).reshape(3, 4, 6),
            "scale": torch.tensor(2.0)}
    parts = plan_mod._microbatches(data, 2)
    for i, mb in enumerate(parts):
        assert torch.equal(mb["tokens"], data["tokens"][2 * i:2 * i + 2])
        assert torch.equal(mb["mrope_pos"], data["mrope_pos"][:, 2 * i:2 * i + 2])
        assert mb["scale"] is data["scale"]
    assert plan_mod.batch_axis("mrope_pos") == 1 and plan_mod.batch_axis("x") == 0
    with pytest.raises(ValueError, match="mrope_pos"):
        plan_mod._microbatches({"mrope_pos": torch.zeros(3, 5, 2)}, 2)


def test_microbatch_split_keys_on_name_not_shape():
    """``tests/test_federated.py::test_microbatch_split_keys_on_name_not_shape``
    on the port: a batch of 3 with ndim 3 splits on axis 0 (S = 5 does not
    divide into 3, so a split on axis 1 would raise)."""
    params = {"w": torch.eye(4)}

    def loss_fn(p, batch):
        return torch.mean(torch.einsum("bsd,de->bse", batch["x"], p["w"]) ** 2)

    batch = {"x": torch.from_numpy(np.random.default_rng(0).normal(size=(3, 5, 4))
                                   .astype(np.float32)),
             "heat_vocab": torch.ones(4)}
    out = {}
    for nmb in (1, 3):
        fed = FedConfig(num_clients=4, lr=0.1, microbatches=nmb)
        step = make_round_step(loss_fn, params, {"w": (None, None)}, fed, mode="fedsgd",
                               correct=False)
        out[nmb] = step({k: v.clone() for k, v in params.items()}, batch)
    np.testing.assert_allclose(float(out[3][1]["loss"]), float(out[1][1]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(out[3][0]["w"].numpy(), out[1][0]["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_microbatch_mrope_still_splits_on_batch_axis():
    """``tests/test_federated.py::test_microbatch_mrope_still_splits_on_batch_axis``
    on the port (rtol 2e-4, atol 2e-5 between 1 and 2 microbatches), with
    image-grid streams in place of the reference's equal ones, and each
    side held to the JAX package's step within 1e-5."""
    jcfg, japi, jp, tapi, params, axes = _pair(QWEN, flat=True)
    b, s = 4, 16
    batch = {"tokens": np.random.default_rng(2).integers(0, jcfg.vocab_size, (b, s))
             .astype(np.int32),
             "labels": np.ones((b, s), np.int32), "mask": np.ones((b, s), np.float32),
             "mrope_pos": serve_mod.image_grid_positions(b, s, *GRID).numpy(),
             "patch_embeds": np.full((b, jcfg.num_patches, jcfg.d_model), 0.01, np.float32),
             "heat_vocab": np.ones((jcfg.vocab_size,), np.float32)}
    got = {}
    for nmb in (1, 2):
        kw = dict(num_clients=10, lr=0.1, algorithm="fedsubavg", microbatches=nmb)
        step = make_round_step(tapi.loss, params, axes, FedConfig(**kw), mode="fedsgd")
        got[nmb], m = step({k: v.clone() for k, v in params.items()}, _torch(batch))
        jnew, jm = jax.jit(j_make_round_step(japi.loss, jp, JFedConfig(**kw), "fedsgd"))(
            jp, _jax(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        want = _flatten(jax.tree.map(np.asarray, unbox(jnew)))
        for name, w in want.items():
            np.testing.assert_allclose(_stacked(got[nmb])[name], w, err_msg=name, **TOL)
    for name in got[1]:
        np.testing.assert_allclose(got[2][name].numpy(), got[1][name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_flat_shard_slices_mrope_pos_on_its_batch_axis(tmp_path):
    """Two gloo ranks run the sharded FedSgdLocal step (whole and in 2
    microbatches) on the Qwen2-VL smoke model with grid streams: each rank
    takes ``mrope_pos[:, r*b:(r+1)*b]`` and the round equals the unsharded
    one within 1e-5."""
    import torch_sharding_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    spawn_ranks(ranks.mrope_flat_rank, 2, args=(2, str(tmp_path / "store"), str(tmp_path)),
                timeout_s=240.0)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    cfg, params, axes, batch = ranks.mrope_case()
    for nmb in (1, 2):
        fed = FedConfig(num_clients=10, lr=0.1, algorithm="fedsubavg", microbatches=nmb)
        step = make_round_step(build_model(cfg).loss, params, axes, fed, mode="fedsgd")
        want, m = step({k: v.clone() for k, v in params.items()}, batch)
        for r in range(2):
            got = res[r][nmb]
            assert got["mrope_shapes"] == [(3, 2 // nmb, 16)] * nmb
            np.testing.assert_allclose(got["loss"], float(m["loss"]), **TOL)
            for name, w in want.items():
                np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                           err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# launchers and the factory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_on_the_smoke_configs(arch):
    """``launch.serve.serve`` with the launcher's own inputs and with the
    caller's (grid streams, random patches), and ``launch.train.train`` with
    patches and streams in every cohort batch, remat on and off: finite
    numbers, the cache at prompt + gen, the same losses either way."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    res = serve_mod.serve(cfg, batch=2, prompt=16, gen=3, device="cpu")
    assert res.tokens.shape == (2, 3) and res.cache_pos == 19
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    own = _inputs(cfg, 2, 16, 5)
    mine = serve_mod.serve(cfg, batch=2, prompt=16, gen=3, device="cpu",
                           patch_embeds=torch.from_numpy(own["patch_embeds"]),
                           mrope_pos=(torch.from_numpy(own["mrope_pos"]) if cfg.mrope
                                      else None))
    assert not torch.equal(mine.logits[0], res.logits[0])
    inputs = {"patch_embeds": torch.from_numpy(_inputs(cfg, 4, 32, 6)["patch_embeds"])}
    if cfg.mrope:
        inputs["mrope_pos"] = serve_mod.image_grid_positions(4, 32, *GRID)
    runs = [train_mod.train(cfg, rounds=2, clients=16, cohort=4, seq=32, device="cpu",
                            log_every=0, remat=remat, inputs=inputs) for remat in (True, False)]
    assert all(np.isfinite(runs[0].losses)) and runs[0].losses == runs[1].losses
    out = train_mod.main(["--arch", arch, "--scale", "tiny", "--device", "cpu", "--rounds", "1",
                          "--clients", "16", "--cohort", "4", "--seq", "32"])
    assert len(out.losses) == 1 and np.isfinite(out.losses[0])


def test_factory_draws_large_tensors_in_slices():
    """Up to ``DRAW_WHOLE_MAX`` elements a tensor is one f32 draw, cast;
    above it, consecutive f32 draws of at most ``DRAW_SLICE`` elements
    along axis 0, each cast into place. Every tensor of the configurations
    served before is below the cut (their draws stay as they were); Llama
    4's expert stacks are above it."""
    from repro_torch.configs.base import get_config
    std = 0.05
    for shape, sliced in (((6, 5, 7), False), ((40, 3, 5), True)):
        fac = transformer._Factory(torch.bfloat16, torch.device("cpu"),
                                   torch.Generator().manual_seed(3), None)
        cut = (transformer.DRAW_WHOLE_MAX, transformer.DRAW_SLICE)
        if sliced:
            transformer.DRAW_WHOLE_MAX, transformer.DRAW_SLICE = 100, 45
        try:
            got = fac._draw(shape, std, torch.bfloat16)
        finally:
            transformer.DRAW_WHOLE_MAX, transformer.DRAW_SLICE = cut
        gen = torch.Generator().manual_seed(3)
        rows = 3 if sliced else shape[0]
        want = torch.cat([torch.randn((min(rows, shape[0] - i),) + shape[1:], generator=gen)
                          .mul_(std).to(torch.bfloat16) for i in range(0, shape[0], rows)])
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for arch in ("mixtral_8x22b", "mistral_large_123b", "qwen3_32b", "qwen2_5_14b",
                 "deepseek_67b", QWEN):
        model = build_model(get_config(arch)).abstract_params()
        assert max(p.numel() for p in model.parameters()) <= transformer.DRAW_WHOLE_MAX, arch
    llama = build_model(get_config(LLAMA).replace(num_layers=1)).abstract_params()
    assert llama.layers[0].ffn.wi.numel() > transformer.DRAW_WHOLE_MAX
    assert llama.embedding.numel() <= transformer.DRAW_WHOLE_MAX
