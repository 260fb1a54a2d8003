"""Port parity, Mamba2 and Zamba2: ``repro_torch.models.ssm`` and
``repro_torch.models.zamba`` against ``repro.models.ssm`` and
``repro.models.zamba`` on the same numpy inputs. Per function:
``ssd_chunked`` (S a multiple of the chunk and not), ``_causal_conv`` with
and without a state, ``mamba2_block`` chunked and single-step, in f32
(1e-5) and bf16 (2e-2, and 1e-2 in relative norm). The Zamba2 smoke model
on the weights of ``PRNGKey(0)`` (``convert.params_from_jax``): forward,
loss and every gradient against ``jax.grad`` (the shared block's summed
over its sites), prefill and 4 decode steps, decode after a prefill against
a longer prefill (the reference test's 2e-3), remat on against off bit for
bit, ``make_round_step`` in the ``fedsgd`` and ``sparse`` modes, the
parameter layout and checkpoints both ways, and the launchers on the host.
The reference's attention here is ``mea_attention``, plain JAX."""
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
from repro.models import ssm as JS
from repro.models import zamba as JZ
from repro.sharding.logical import unbox

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.models import ssm as S
from repro_torch.models import transformer, zamba
from repro_torch.models.api import build_model

from torch_recurrent_parity import DTYPES, F32_TOL, both, close, round_steps_match, stacked_numpy

ARCH = "zamba2_1_2b"


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


def layer0(pair, dtype: str):
    """Layer 0's Mamba2 parameters in both packages, in ``dtype``."""
    _, jp, _, model, _, _ = pair
    jd, td = DTYPES[dtype]
    jm = jax.tree.map(lambda a: a[0], unbox(jp)["mamba"])
    jm = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and a.ndim == 1 else a.astype(jd),
                      jm)
    tm = model.mamba[0]
    out = {k: (v if v.dtype == torch.float32 and v.ndim == 1 else v.to(td))
           for k, v in tm.state_dict().items()}
    return jm, transformer.FlatParams(out)


# ---------------------------------------------------------------------------
# per function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 50], ids=["multiple", "padded"])
def test_ssd_chunked_matches_jax(s, dtype):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.3
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jx, tx = both(x, dtype)
    for start in (None, init):
        jy, js = jax.jit(JS.ssd_chunked, static_argnums=4)(
            jx, jnp.asarray(a), jnp.asarray(bm), jnp.asarray(cm), 16,
            None if start is None else jnp.asarray(start))
        ty, ts = S.ssd_chunked(tx, torch.from_numpy(a), torch.from_numpy(bm),
                               torch.from_numpy(cm), 16,
                               None if start is None else torch.from_numpy(start))
        assert ty.dtype == DTYPES[dtype][1] and ts.dtype == torch.float32
        close(ty, jy, dtype, "y")
        close(ts, js, "float32" if dtype == "float32" else dtype, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.5
    bias = rng.standard_normal(12).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb), (js, ts) = (both(a, dtype) for a in (xbc, w, bias, st))
    for jstate, tstate in ((None, None), (js, ts)):
        jo, jn = JS._causal_conv(jx, jw, jb, jstate)
        to, tn = S._causal_conv(tx, tw, tb, tstate)
        close(to, jo, dtype, "out")
        close(tn, jn, dtype, "new state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_jax(pair, dtype):
    jcfg = j_get_smoke_config(ARCH).replace(dtype=dtype)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jm, tm = layer0(pair, dtype)
    rng = np.random.default_rng(4)
    jx, tx = both(rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32), dtype)
    jo, jst = jax.jit(lambda m, x: JS.mamba2_block(jcfg, m, x, chunk=16))(jm, jx)
    to, tst = S.mamba2_block(tcfg, tm, tx, chunk=16)
    assert to.dtype == DTYPES[dtype][1]
    close(to, jo, dtype, "chunked out")
    close(tst.state, jst.state, dtype, "chunked state")
    close(tst.conv, jst.conv, dtype, "chunked conv")
    # single-step decode from the chunked state: y stays f32 and promotes the
    # rest, as JAX does, before the output rounds back
    jx1, tx1 = both(rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32), dtype)
    jo1, jst1 = jax.jit(lambda m, x, st: JS.mamba2_block(jcfg, m, x, state=st,
                                                         single_step=True))(jm, jx1, jst)
    to1, tst1 = S.mamba2_block(tcfg, tm, tx1, state=tst, single_step=True)
    assert to1.dtype == DTYPES[dtype][1]
    close(to1, jo1, dtype, "step out")
    close(tst1.state, jst1.state, dtype, "step state")
    close(tst1.conv, jst1.conv, dtype, "step conv")


# ---------------------------------------------------------------------------
# the Zamba2 smoke model
# ---------------------------------------------------------------------------


def _batch(seed: int, b: int = 3, s: int = 64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}


def test_forward_loss_and_every_gradient_match_jax(pair):
    japi, jp, tapi, model, flat, _ = pair
    b = _batch(1)
    jh, _ = jax.jit(lambda p, t: JZ.forward(japi.cfg, p, t, remat=False))(
        jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        th = zamba.forward(tapi.cfg, model, torch.from_numpy(b["tokens"]), remat=False).hidden
    close(th, jh, "float32", "hidden", scaled=True)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tl = torch.func.grad_and_value(tapi.loss)(flat, {k: torch.from_numpy(v)
                                                        for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = stacked_numpy(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    # the shared block's gradient is one sum over its sites, and every site
    # adds to it: the model has two, and without the second its gradient moves
    sites = zamba.num_attn_sites(tapi.cfg)
    assert sites == 2 and np.abs(got["shared_attn.wq.w"]).max() > 0


def test_prefill_and_decode_match_jax(pair):
    japi, jp, tapi, model, _, _ = pair
    prompt = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    jcache = japi.init_cache(2, 32)
    jl, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tapi.init_cache(2, 32, "cpu")
    tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt)}, tcache)
    close(tl, jl, "float32", "prefill logits", scaled=True)
    decode = jax.jit(japi.decode_step)
    for _ in range(4):
        jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tn = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        jl, jcache = decode(jp, jcache, {"tokens": jn})
        tl, tcache = tapi.decode_step(model, tcache, {"tokens": tn})
        close(tl, jl, "float32", "decode logits", scaled=True)
    assert tcache.pos == int(jcache.pos) == 28
    for name in ("ssm_state", "conv_state", "k", "v"):
        close(getattr(tcache, name), getattr(jcache, name), "float32", name, scaled=True)


def test_decode_matches_a_longer_prefill():
    """``tests/test_models_smoke.py::test_decode_matches_prefill`` on the
    port: decoding token t after a prefill of t tokens gives the logits of a
    prefill of t + 1."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), "cpu")
    b, s = 1, 17
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    _, cache = api.prefill(params, {"tokens": toks[:, :s]}, api.init_cache(b, 64, "cpu"))
    l_dec, _ = api.decode_step(params, cache, {"tokens": toks[:, s]})
    l_full, _ = api.prefill(params, {"tokens": toks}, api.init_cache(b, 64, "cpu"))
    np.testing.assert_allclose(l_dec.numpy(), l_full.numpy(), rtol=2e-3, atol=2e-3)


def test_remat_on_equals_off_bit_for_bit(pair):
    _, _, tapi, _, flat, _ = pair
    b = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    g_on, l_on = torch.func.grad_and_value(lambda p: tapi.loss(p, b, remat=True))(flat)
    g_off, l_off = torch.func.grad_and_value(lambda p: tapi.loss(p, b, remat=False))(flat)
    assert torch.equal(l_on, l_off)
    for name in g_off:
        assert torch.equal(g_on[name], g_off[name]), name


@pytest.mark.parametrize("mode", ["fedsgd", "sparse"])
def test_round_step_matches_jax(pair, mode):
    japi, jp, tapi, _, _, _ = pair
    round_steps_match(japi, jp, tapi, tapi.cfg, mode)


def test_parameter_layout_and_checkpoints_both_ways(pair, tmp_path):
    """The module's leaves, their axes, the stacked layout against the
    reference's tree, and checkpoints written by each package read by the
    other."""
    _, jp, tapi, model, flat, axes = pair
    names = list(flat)
    assert names == list(model.state_dict()) and set(names) == set(axes)
    assert "mamba.3.in_proj" in flat and "shared_attn.ffn.wi" in flat
    assert axes["mamba.0.conv_w"] == ("conv", "ffn") and axes["lm_head"] == ("embed", "vocab")
    assert model.mamba[0].a_log.dtype == torch.float32
    stacked, stacked_axes = transformer.stack_layers(flat, axes)
    want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
    assert stacked.keys() == want.keys()
    assert stacked_axes["mamba.in_proj"] == ("layers", "embed", "ffn")
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


def test_ssm_a_init_and_fan_in():
    """The factory's draws: A_log = log U[1, 16] in f32, conv_w's fan-in
    the conv width (shape[-2] of the unstacked (W, conv_dim))."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    a = torch.stack([m.a_log for m in model.mamba])
    assert a.dtype == torch.float32 and model.mamba[0].in_proj.dtype == torch.bfloat16
    assert float(a.min()) >= 0.0 and float(a.max()) <= float(np.log(16.0))
    w = torch.stack([m.conv_w.float() for m in model.mamba])
    assert abs(float(w.std()) - 0.5) < 0.05


def test_launchers_serve_and_train_on_the_host(tmp_path):
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    res = serve_mod.main(["--arch", ARCH, "--scale", "tiny", "--device", "cpu", "--batch", "2",
                          "--prompt", "16", "--gen", "3", "--layers", "6"])
    assert res.tokens.shape == (2, 3) and res.cache_pos == 19
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    path = str(tmp_path / "ckpt")
    out = train_mod.main(["--arch", ARCH, "--smoke", "--rounds", "2", "--device", "cpu",
                          "--sparse", "--ckpt", path])
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
    cfg_j = j_get_config(ARCH).replace(**train_mod.SMOKE)
    back = j_load(path, j_build_model(cfg_j).init(jax.random.PRNGKey(1)))
    want = _flatten(jax.tree.map(np.asarray, unbox(back)))
    got = stacked_numpy(out.params)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
