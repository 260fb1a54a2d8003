"""Port parity, Whisper: ``repro_torch.models.whisper`` against
``repro.models.whisper`` on the same numpy inputs. The sinusoidal table at
(64, 128) and at Whisper's (1,500, 1,280); the smoke model on the weights of
``PRNGKey(0)`` (``convert.params_from_jax``): the encoder's output, the
loss and every gradient against ``jax.grad`` with remat on and off, with
and without labels and a mask, the encoder's gradient through
cross-attention (and none without it), prefill and 8 greedy decode steps
in f32 (1e-5) and the prefill in bf16 (2e-2), ``make_round_step`` with
``frames`` under FedSubAvg and FedAvg, the parameter layout and
checkpoints both ways, and the launchers on the host. The reference's
attention here is ``mea_attention``, plain JAX."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.sharding.logical import unbox

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer, whisper
from repro_torch.models.api import build_model

from torch_recurrent_parity import F32_TOL, close, round_steps_match, stacked_numpy

ARCH = "whisper_large_v3"
#: the smoke model's frames and vocabulary
ENC_SEQ, D, VOCAB = 64, 128, 512
#: sin and cos of the port's table against the reference's at (1,500,
#: 1,280): the angles agree bit for bit, sin and cos by 5.96e-8 at most
#: (half an ulp of 1), measured
SINUSOID_TOL = 1.2e-7


@pytest.fixture(scope="module")
def pair():
    """(JAX api, JAX params, port api, port model, flat dict, axes), f32."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, unbox(jp))
    model, axes = params_from_jax(tree, device="cpu", cfg=tcfg)
    flat, flat_axes = params_from_jax(tree, device="cpu", cfg=tcfg, flat=True)
    assert flat_axes == axes
    return japi, jp, tapi, model, flat, axes


@pytest.fixture(scope="module")
def jax_loss_grad(pair):
    """``jax.value_and_grad`` of the reference's loss (remat on, its
    default) on unboxed parameters, jitted once."""
    japi = pair[0]
    return jax.jit(jax.value_and_grad(japi.loss))


def _frames(rng, b: int = 2) -> np.ndarray:
    return rng.standard_normal((b, ENC_SEQ, D)).astype(np.float32)


def _batch(seed: int, labels: bool, b: int = 2, s: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, VOCAB, (b, s)).astype(np.int32), "frames": _frames(rng, b)}
    if labels:
        out["labels"] = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
        out["mask"] = (rng.random((b, s)) < 0.8).astype(np.float32)
    return out


def _grads_match(tg, jg, names=None) -> dict:
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = stacked_numpy(tg)
    if names is None:
        assert got.keys() == want.keys()
    for name in names or want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **F32_TOL)
    return got


# ---------------------------------------------------------------------------
# per function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d,tol", [(64, 128, 1e-6), (1500, 1280, SINUSOID_TOL)])
def test_sinusoidal_positions_match_jax(seq, d, tol):
    got = L.sinusoidal_positions(seq, d)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JL.sinusoidal_positions(seq, d)),
                               rtol=0, atol=tol)
    # built once per (seq, d, device): every caller reads the same tensor
    assert L.sinusoidal_positions(seq, d, "cpu") is got


def test_encode_matches_jax(pair):
    japi, jp, tapi, model, _, _ = pair
    frames = _frames(np.random.default_rng(0))
    want = jax.jit(lambda p, f: JW.encode(japi.cfg, p, f))(jp, jnp.asarray(frames))
    with torch.no_grad():
        got = whisper.encode(tapi.cfg, model, torch.from_numpy(frames))
    assert got.shape == (2, ENC_SEQ, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads(jax_loss_grad, pair):
    """The reference's loss and gradient on a batch with labels and a mask
    and on one without them (frames and tokens only)."""
    jp = unbox(pair[1])
    out = {}
    for labels in (True, False):
        b = _batch(1 + labels, labels)
        out[labels] = (b, jax_loss_grad(jp, {k: jnp.asarray(v) for k, v in b.items()}))
    return out


@pytest.mark.parametrize("labels", [True, False], ids=["labels-mask", "frames-only"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_and_every_gradient_match_jax(pair, jax_grads, remat, labels):
    _, _, tapi, _, flat, _ = pair
    b, (jl, jg) = jax_grads[labels]
    tg, tl = torch.func.grad_and_value(lambda p: tapi.loss(p, {
        k: torch.from_numpy(v) for k, v in b.items()}, remat=remat))(flat)
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    got = _grads_match(tg, jg)
    for name in ("encoder.attn.wq.w", "decoder.cross_attn.wk.w", "decoder.self_attn.wv.b",
                 "embedding", "lm_head"):
        assert np.abs(got[name]).max() > 0, name


def test_encoder_gradient_reaches_it_through_cross_attention(pair, jax_loss_grad):
    """The encoder's output enters the decoder only as cross-attention's K
    and V: each decoder layer's ``_Remat`` takes it as a tensor and returns
    its gradient, summed over the layers. With remat, the encoder's
    gradient equals the reference's and is not zero; with cross-attention's
    ``wk`` and ``wv`` at zero (its biases too) it is exactly zero in both
    packages."""
    _, jp, tapi, _, flat, _ = pair
    b = _batch(3, labels=False)
    enc = [n for n in flat if n.startswith("encoder")]

    def port_grad(params):
        return torch.func.grad(lambda p: tapi.loss(p, {k: torch.from_numpy(v)
                                                        for k, v in b.items()},
                                                    remat=True))(params)

    _, jg = jax_loss_grad(unbox(jp), {k: jnp.asarray(v) for k, v in b.items()})
    got = _grads_match(port_grad(flat), jg,
                       names=[n for n in _flatten(jax.tree.map(np.asarray, unbox(jg)))
                              if n.startswith("encoder")])
    assert all(np.abs(got[n]).max() > 0 for n in got if n.startswith("encoder.attn.w")
               or n.startswith("encoder.ffn.")), "an encoder weight got no gradient"

    cut = {n: (torch.zeros_like(v) if ".cross_attn.wk." in n or ".cross_attn.wv." in n else v)
           for n, v in flat.items()}
    g = port_grad(cut)
    assert all(float(g[n].abs().max()) == 0.0 for n in enc)
    jcut = jax.tree.map(lambda x: x, unbox(jp))
    for key in ("wk", "wv"):
        jcut["decoder"]["cross_attn"][key] = jax.tree.map(
            jnp.zeros_like, jcut["decoder"]["cross_attn"][key])
    _, jg0 = jax_loss_grad(jcut, {k: jnp.asarray(v) for k, v in b.items()})
    assert all(float(jnp.abs(x).max()) == 0.0
               for x in jax.tree.leaves(unbox(jg0)["encoder"]))


def test_remat_on_against_off(pair):
    """The decoder's remat changes no bit of the loss or of any decoder,
    embedding or head gradient. The encoder (always rematted, as the
    reference's) differs in the last bits only: its output's gradient is
    the same terms summed in another order, each layer's K and V terms
    first with remat, one by one without."""
    _, _, tapi, _, flat, _ = pair
    b = {k: torch.from_numpy(v) for k, v in _batch(5, labels=True).items()}
    g_on, l_on = torch.func.grad_and_value(lambda p: tapi.loss(p, b, remat=True))(flat)
    g_off, l_off = torch.func.grad_and_value(lambda p: tapi.loss(p, b, remat=False))(flat)
    assert torch.equal(l_on, l_off)
    for name in g_off:
        if name.startswith("encoder"):
            torch.testing.assert_close(g_on[name], g_off[name], rtol=0,
                                       atol=1e-6 * float(g_off[name].abs().max()))
        else:
            assert torch.equal(g_on[name], g_off[name]), name


def _frames_leaf(rng) -> dict:
    return {"frames": _frames(rng, 4)}


@pytest.fixture(scope="module")
def one_round(pair):
    """One ``fedsgd`` round with frames under each algorithm from the same
    parameters and batch; the port's parameters after it."""
    japi, jp, tapi, _, _, _ = pair
    return {alg: round_steps_match(japi, jp, tapi, tapi.cfg, "fedsgd", steps=1,
                                   algorithm=alg, extra=_frames_leaf)
            for alg in ("fedsubavg", "fedavg")}


@pytest.mark.parametrize("algorithm", ["fedsubavg", "fedavg"])
def test_round_step_matches_jax(pair, one_round, algorithm):
    """``make_round_step`` against the JAX package's on a cohort batch with
    ``frames``: loss, metrics and every parameter within 1e-5
    (``round_steps_match`` holds them in ``one_round``)."""
    jp = pair[1]
    assert one_round[algorithm].keys() == set(_flatten(jax.tree.map(np.asarray, unbox(jp))))


def test_vocabulary_correction_reaches_embedding_and_lm_head(one_round):
    """FedSubAvg's heat correction scales the vocabulary rows of
    ``embedding`` (axis 0) and ``lm_head`` (axis 1) and nothing else: one
    round from the same parameters on the same batch moves every other leaf
    as FedAvg does."""
    sub, avg = one_round["fedsubavg"], one_round["fedavg"]
    for name in sub:
        if name in ("embedding", "lm_head"):
            assert not np.array_equal(sub[name], avg[name]), name
        else:
            np.testing.assert_array_equal(sub[name], avg[name], err_msg=name)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(pair):
    japi, jp, tapi, model, _, _ = pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, VOCAB, (2, 24)).astype(np.int32)
    frames = _frames(rng)
    jcache = japi.init_cache(2, 32)
    jl, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(prompt),
                                            "frames": jnp.asarray(frames)}, jcache)
    tcache = tapi.init_cache(2, 32, "cpu")
    tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt),
                                      "frames": torch.from_numpy(frames)}, tcache)
    close(tl, jl, "float32", "prefill logits")
    decode = jax.jit(japi.decode_step)
    for _ in range(8):
        jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tn = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        jl, jcache = decode(jp, jcache, {"tokens": jn})
        tl, tcache = tapi.decode_step(model, tcache, {"tokens": tn})
        close(tl, jl, "float32", "decode logits")
    assert tcache.pos == int(jcache.pos) == 32
    for name in ("k", "v", "ck", "cv"):
        close(getattr(tcache, name), getattr(jcache, name), "float32", name)


def test_prefill_matches_jax_bf16():
    jcfg = j_get_smoke_config(ARCH)
    tcfg = get_smoke_config(ARCH)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    model, _ = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu", cfg=tcfg)
    assert model.decoder[0].cross_attn.norm.scale.dtype == torch.float32
    assert model.decoder[0].cross_attn.wq.w.dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    frames = _frames(rng)
    jl, _ = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(prompt),
                                       "frames": jnp.asarray(frames, jnp.bfloat16)},
                                  japi.init_cache(2, 24))
    tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt),
                                      "frames": torch.from_numpy(frames).bfloat16()},
                              tapi.init_cache(2, 24, "cpu"))
    assert tl.dtype == torch.float32 and tcache.ck.dtype == torch.bfloat16
    close(tl, jl, "bfloat16", "bf16 prefill logits")


def test_prefill_refuses_frames_that_do_not_fit_the_cache(pair):
    _, _, tapi, model, _, _ = pair
    with pytest.raises(ValueError, match="frames"):
        tapi.prefill(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                             "frames": torch.zeros((1, ENC_SEQ - 1, D))},
                     tapi.init_cache(1, 8, "cpu"))


# ---------------------------------------------------------------------------
# parameters, checkpoints, launchers
# ---------------------------------------------------------------------------


def test_parameter_layout_and_checkpoints_both_ways(pair, tmp_path):
    """The module's leaves and their axes, the stacked layout against the
    reference's tree, and checkpoints written by each package read by the
    other."""
    _, jp, _, model, flat, axes = pair
    names = list(flat)
    assert names == list(model.state_dict()) and set(names) == set(axes)
    assert "encoder.1.attn.wq.b" in flat and "decoder.1.cross_attn.wo.b" in flat
    assert not any(".wk.b" in n for n in names)
    assert axes["embedding"] == ("vocab", "embed") and axes["lm_head"] == ("embed", "vocab")
    assert axes["decoder.0.cross_attn.wv.b"] == ("kv",) and axes["encoder_norm.scale"] == (
        "embed",)
    stacked, stacked_axes = transformer.stack_layers(flat, axes)
    want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
    assert stacked.keys() == want.keys()
    assert stacked_axes["decoder.cross_attn.wq.w"] == ("layers", "embed", "heads")
    assert stacked_axes["encoder_norm.scale"] == ("embed",)
    assert list(transformer.unstack_layers(stacked)) == names

    doubled = {k: v * 2 + 1 for k, v in flat.items()}
    path = str(tmp_path / "port")
    doubled_stacked, doubled_axes = transformer.stack_layers(doubled, axes)
    save_checkpoint(path, doubled_stacked, step=4, axes=doubled_axes)
    back = _flatten(jax.tree.map(np.asarray, unbox(j_load(path, jp))))
    got = stacked_numpy(doubled)
    for name, w in back.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    j_save(str(tmp_path / "jax"), jp, step=4)
    assert (json.load(open(path + ".meta.json"))
            == json.load(open(str(tmp_path / "jax") + ".meta.json")))
    read = transformer.unstack_layers(load_checkpoint(str(tmp_path / "jax"),
                                                      transformer.stack_layers(flat)[0]))
    assert list(read) == names
    for k in flat:
        assert torch.equal(read[k], flat[k]), k


def test_abstract_params_at_full_size():
    """Whisper large-v3 whole on ``meta``: 2,020,789,760 parameters, the
    reference's abstract tree leaf for leaf; ``param_counts`` leaves out
    the decoder's cross-attention, the biases and the cross-attention
    norms (1,810,662,400)."""
    cfg = get_config(ARCH)
    flat, axes = transformer.train_params(build_model(cfg).abstract_params())
    assert all(t.device.type == "meta" for t in flat.values())
    n = sum(t.numel() for t in flat.values())
    assert n == 2_020_789_760
    assert cfg.param_counts()["total"] == 1_810_662_400
    tree = unbox(j_build_model(j_get_config(ARCH)).abstract_params())
    want = {".".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in jax.tree_util.tree_leaves_with_path(tree)}
    got, _ = transformer.stack_layers(flat, axes)
    assert got.keys() == want.keys()
    assert sum(int(np.prod(s.shape)) for s in want.values()) == n
    assert got["decoder.cross_attn.wk.w"].shape == (32, 1280, 1280)
    assert got["encoder.ffn_norm.scale"].dtype == torch.float32
    assert got["lm_head"].dtype == torch.bfloat16


def test_launchers_serve_and_train_on_the_host(tmp_path):
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    res = serve_mod.main(["--arch", ARCH, "--scale", "tiny", "--device", "cpu", "--batch", "2",
                          "--prompt", "16", "--gen", "3"])
    assert res.tokens.shape == (2, 3) and res.cache_pos == 19
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    path = str(tmp_path / "ckpt")
    out = train_mod.main(["--arch", ARCH, "--smoke", "--rounds", "2", "--device", "cpu",
                          "--ckpt", path])
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
    cfg_j = j_get_config(ARCH).replace(**train_mod.SMOKE)
    back = j_load(path, j_build_model(cfg_j).init(jax.random.PRNGKey(1)))
    want = _flatten(jax.tree.map(np.asarray, unbox(back)))
    got = stacked_numpy(out.params)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_serve_takes_the_callers_frames():
    """``serve`` feeds the caller's frames (else the reference launcher's
    0.02): other frames give other logits, the default equals 0.02."""
    from repro_torch.launch import serve as serve_mod
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    kw = dict(batch=1, prompt=8, gen=2, device="cpu", params=params)
    base = serve_mod.serve(cfg, **kw)
    same = serve_mod.serve(cfg, frames=torch.full((1, ENC_SEQ, D), 0.02), **kw)
    other = serve_mod.serve(cfg, frames=torch.ones((1, ENC_SEQ, D)), **kw)
    assert torch.equal(base.logits[0], same.logits[0])
    assert not torch.equal(base.logits[0], other.logits[0])
    assert base.launches_prefill == {"flash_attention": 0, "flash_decode": 0, "flash_decode_lse": 0}
