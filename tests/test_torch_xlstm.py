"""Port parity, xLSTM: ``repro_torch.models.xlstm`` and
``repro_torch.models.xlstm_model`` against ``repro.models.xlstm`` and
``repro.models.xlstm_model`` on the same numpy inputs. Per function:
``mlstm_cell_chunked`` (from the zero state and from a given one),
``mlstm_cell_step``, ``slstm_scan`` from the zero state and from a given
one, and both blocks chunked and single-step, in f32 (1e-5) and bf16 (2e-2
of the output's scale, and 1e-2 in relative norm; ``torch_recurrent_parity.close``).
The smoke model on the weights of ``PRNGKey(0)``: forward, loss and every
gradient against ``jax.grad``, prefill and 4 decode steps, decode after a
prefill against a longer prefill, remat on against off bit for bit,
``make_round_step`` in the ``fedsgd`` and ``sparse`` modes, the chunk rule
raising, the parameter layout and checkpoints both ways, the launchers."""
import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.models import xlstm as JX
from repro.models import xlstm_model as JXM
from repro.sharding.logical import unbox

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.models import transformer
from repro_torch.models import xlstm as X
from repro_torch.models import xlstm_model as XM
from repro_torch.models.api import build_model

from torch_recurrent_parity import DTYPES, F32_TOL, both, close, round_steps_match, stacked_numpy

ARCH = "xlstm_350m"


@pytest.fixture(scope="module")
def pair():
    """(JAX api, JAX params, port api, port model, flat dict, axes), f32."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, unbox(jp))
    model, axes = params_from_jax(tree, device="cpu", cfg=tcfg)
    flat, _ = params_from_jax(tree, device="cpu", cfg=tcfg, flat=True)
    return japi, jp, tapi, model, flat, axes


def run_layer(pair, r: int, kind: str, dtype: str):
    """Layer 0 of run ``r`` (``kind``) in both packages, in ``dtype`` (the
    f32 vectors stay f32)."""
    _, jp, _, model, _, _ = pair
    jd, td = DTYPES[dtype]
    jl = jax.tree.map(lambda a: a[0], unbox(jp)["runs"][r][kind])
    jl = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and a.ndim == 1 else a.astype(jd),
                      jl)
    tl = {k: (v if v.dtype == torch.float32 and v.ndim == 1 else v.to(td))
          for k, v in model.runs[r][kind][0].state_dict().items()}
    return jl, transformer.FlatParams(tl)


def _cell_inputs(rng, b, s, h, hd):
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3))
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-(rng.standard_normal((b, s, h)) + 2)))).astype(np.float32)
    return q, k, v, log_i, log_f


def _mstate(rng, b, h, hd):
    return (rng.standard_normal((b, h, hd, hd)).astype(np.float32),
            rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


# ---------------------------------------------------------------------------
# per function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_cells_match_jax(dtype):
    """``mlstm_cell_chunked`` over 3 chunks from the zero state and from a
    given one, then ``mlstm_cell_step`` from its final state."""
    rng = np.random.default_rng(1)
    b, s, h, hd = 2, 48, 2, 8
    q, k, v, li, lf = _cell_inputs(rng, b, s, h, hd)
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    jli, jlf = jnp.asarray(li), jnp.asarray(lf)
    tli, tlf = torch.from_numpy(li), torch.from_numpy(lf)
    given = _mstate(rng, b, h, hd)
    for start in (None, given):
        jst = None if start is None else JX.MLSTMState(*map(jnp.asarray, start))
        tst = None if start is None else X.MLSTMState(*map(torch.from_numpy, start))
        jh, jnew = jax.jit(JX.mlstm_cell_chunked, static_argnums=5)(jq, jk, jv, jli, jlf, 16,
                                                                   jst)
        th, tnew = X.mlstm_cell_chunked(tq, tk, tv, tli, tlf, 16, tst)
        assert th.dtype == DTYPES[dtype][1]
        close(th, jh, dtype, "h")
        for name, t, j in zip(("c", "n", "m"), tnew, jnew):
            close(t, j, dtype, name, scaled=True)
    q1, k1, v1, li1, lf1 = (a[:, 0] for a in _cell_inputs(rng, b, 1, h, hd))
    (jq1, tq1), (jk1, tk1), (jv1, tv1) = both(q1, dtype), both(k1, dtype), both(v1, dtype)
    jh, jstep = jax.jit(JX.mlstm_cell_step)(jq1, jk1, jv1, jnp.asarray(li1), jnp.asarray(lf1),
                                            jnew)
    th, tstep = X.mlstm_cell_step(tq1, tk1, tv1, torch.from_numpy(li1), torch.from_numpy(lf1),
                                  tnew)
    close(th, jh, dtype, "step h")
    for name, t, j in zip(("c", "n", "m"), tstep, jstep):
        close(t, j, dtype, "step " + name, scaled=True)


def test_mlstm_chunk_rule_raises():
    """The reference asserts S % chunk == 0 once S > chunk; the port raises
    a ValueError naming the rule, through the model's loss too."""
    rng = np.random.default_rng(2)
    q, k, v, li, lf = (torch.from_numpy(a) for a in _cell_inputs(rng, 1, 48, 2, 8))
    with pytest.raises(ValueError, match="multiple of the chunk 32"):
        X.mlstm_cell_chunked(q, k, v, li, lf, 32)
    with pytest.raises(AssertionError):
        JX.mlstm_cell_chunked(*(jnp.asarray(t.numpy()) for t in (q, k, v, li, lf)), 32)
    api = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    with pytest.raises(ValueError, match="S % chunk == 0"):
        api.loss(api.init(device="cpu"), {"tokens": torch.zeros((1, 48), dtype=torch.int32)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_matches_jax(pair, dtype):
    cfg_j = j_get_smoke_config(ARCH).replace(dtype=dtype)
    cfg_t = get_smoke_config(ARCH).replace(dtype=dtype)
    jl, tl = run_layer(pair, 1, "s", dtype)
    rng = np.random.default_rng(3)
    jx, tx = both(rng.standard_normal((2, 12, cfg_t.d_model)).astype(np.float32), dtype)
    given = [rng.standard_normal((2, cfg_t.d_model)).astype(np.float32) for _ in range(4)]
    given[1] = np.abs(given[1]) + 0.5                     # a normaliser
    for start in (None, given):
        jst = None if start is None else JX.SLSTMState(*map(jnp.asarray, start))
        tst = None if start is None else X.SLSTMState(*map(torch.from_numpy, start))
        jh, jnew = jax.jit(lambda p, x, st: JX.slstm_scan(cfg_j, p, x, st))(jl, jx, jst)
        th, tnew = X.slstm_scan(cfg_t, tl, tx, tst)
        assert th.dtype == DTYPES[dtype][1]
        close(th, jh, dtype, "hs")
        for name, t, j in zip(("c", "n", "h", "m"), tnew, jnew):
            close(t, j, dtype, name, scaled=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["m", "s"])
def test_blocks_match_jax(pair, kind, dtype):
    """Each block over a prompt, then one single step from its state."""
    cfg_j = j_get_smoke_config(ARCH).replace(dtype=dtype)
    cfg_t = get_smoke_config(ARCH).replace(dtype=dtype)
    jl, tl = run_layer(pair, 0 if kind == "m" else 1, kind, dtype)
    rng = np.random.default_rng(4)
    jx, tx = both(rng.standard_normal((2, 32, cfg_t.d_model)).astype(np.float32), dtype)
    jx1, tx1 = both(rng.standard_normal((2, 1, cfg_t.d_model)).astype(np.float32), dtype)
    jblock, tblock = ((partial(JX.mlstm_block, chunk=16), partial(X.mlstm_block, chunk=16))
                      if kind == "m" else (JX.slstm_block, X.slstm_block))
    jo, jst = jax.jit(lambda p, x: jblock(cfg_j, p, x))(jl, jx)
    to, tst = tblock(cfg_t, tl, tx)
    jo1, jst1 = jax.jit(lambda p, x, st: jblock(cfg_j, p, x, state=st, single_step=True))(
        jl, jx1, jst)
    to1, tst1 = tblock(cfg_t, tl, tx1, state=tst, single_step=True)
    for got, want, name in ((to, jo, "out"), (to1, jo1, "step out")):
        assert got.dtype == DTYPES[dtype][1]
        close(got, want, dtype, name)
    for got, want in ((tst, jst), (tst1, jst1)):
        for t, j in zip(got, want):
            close(t, j, dtype, "state", scaled=True)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert np.abs(np.asarray(jax.nn.gelu(jnp.asarray(x)))
                  - torch.nn.functional.gelu(torch.from_numpy(x)).numpy()).max() > 1e-4


# ---------------------------------------------------------------------------
# the xLSTM smoke model
# ---------------------------------------------------------------------------


def test_forward_loss_and_every_gradient_match_jax(pair):
    japi, jp, tapi, model, flat, _ = pair
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, 512, (3, 64)).astype(np.int32),
         "mask": (rng.random((3, 64)) < 0.8).astype(np.float32)}
    jh, _ = jax.jit(lambda p, t: JXM.forward(japi.cfg, p, t, remat=False))(
        jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        th, _ = XM.forward(tapi.cfg, model, torch.from_numpy(b["tokens"]), remat=False)
    close(th, jh, "float32", "hidden", scaled=True)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tl = torch.func.grad_and_value(tapi.loss)(flat, {k: torch.from_numpy(v)
                                                        for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = stacked_numpy(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name.endswith(".b_i"):
            continue
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    # the input gate's bias: the stabilised mLSTM is invariant to a per-head
    # shift of log_i (the stabiliser moves with it), so its exact gradient
    # is 0 and each package's is rounding noise (JAX's own eager and jitted
    # gradients differ by twice their size); both are held below 1e-4 of
    # the forget gate's bias gradient, the same leaf's sibling
    for name in (n for n in want if n.endswith(".b_i")):
        bound = 1e-4 * np.abs(want[name.replace(".b_i", ".b_f")]).max()
        assert np.abs(want[name]).max() < bound and np.abs(got[name]).max() < bound, name


def test_prefill_and_decode_match_jax(pair):
    """A prompt of 64 (two chunks of 32), then 4 greedy steps."""
    japi, jp, tapi, model, _, _ = pair
    prompt = np.random.default_rng(2).integers(0, 512, (2, 64)).astype(np.int32)
    jcache = japi.init_cache(2, 72)
    jl, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tapi.init_cache(2, 72, "cpu")
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
    assert tcache.pos == int(jcache.pos) == 68
    for got, want in zip(tcache.m_states + tcache.s_states, jcache.m_states + jcache.s_states):
        for t, j in zip(got, want):
            close(t, j, "float32", "state", scaled=True)


def test_decode_matches_a_longer_prefill():
    """``tests/test_models_smoke.py::test_decode_matches_prefill`` on the
    port, whose parametrisation includes xLSTM."""
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
    rng = np.random.default_rng(5)
    b = {"tokens": torch.from_numpy(rng.integers(0, 512, (2, 64)).astype(np.int32))}
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
    _, jp, tapi, model, flat, axes = pair
    names = list(flat)
    assert names == list(model.state_dict()) and set(names) == set(axes)
    assert [k for k in ("runs.0.m.0.up_z", "runs.1.s.0.r", "runs.2.m.1.w_f") if k in flat] == [
        "runs.0.m.0.up_z", "runs.1.s.0.r", "runs.2.m.1.w_f"]
    assert XM.pattern_runs(tapi.cfg.block_pattern) == JXM.pattern_runs(tapi.cfg.block_pattern)
    assert XM.pattern_runs(get_smoke_config(ARCH).replace(num_layers=24).block_pattern) == [
        ("m", 1), ("s", 1), ("m", 2)]
    stacked, stacked_axes = transformer.stack_layers(flat, axes)
    want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
    assert stacked.keys() == want.keys()
    assert stacked_axes["runs.1.s.r"] == ("layers", None, None, None)
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


def test_launchers_serve_and_train_on_the_host(tmp_path):
    """``--scale tiny`` keeps xLSTM's d_ff (0) and its 24-block pattern, as
    the reference's launcher does."""
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
    # the reference's stacked layout (each run's layers on a leading axis);
    # test_parameter_layout_and_checkpoints_both_ways reads it into JAX
    saved = np.load(path + ".npz")
    got = stacked_numpy(out.params)
    assert set(saved.files) == {k.replace(".", "/") for k in got}
    for name, w in got.items():
        np.testing.assert_array_equal(saved[name.replace(".", "/")], w, err_msg=name)
