"""Port parity, the serving path: Qwen2.5-14B's smoke configuration through
``repro_torch`` against ``repro.models.build_model`` on the same weights
(``PRNGKey(0)``, carried across by ``convert.params_from_jax``) and the same
numpy prompts: prefill logits and cache, then greedy decode steps, with and
without a sliding window, and ``launch.serve`` on the host."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.sharding.logical import unbox

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.models.transformer import make_params

ARCH = "qwen2_5_14b"
#: f32: the two packages differ only in sum order and last-ulp transcendentals
F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16: both round every activation to 8 bits of mantissa, at places that
#: differ (XLA fuses, eager PyTorch rounds after each op); logits are O(1)
BF16_TOL = dict(rtol=0.1, atol=0.1)


def _pair(dtype="float32", **over):
    """(JAX api, JAX params, port api, port model) on the smoke config."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype=dtype, **over)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype, **over)
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, unbox(jparams))
    model, axes = params_from_jax(tree, device="cpu", cfg=tcfg)
    assert set(axes) == set(model.state_dict())
    return japi, jparams, tapi, model


def _run_both(japi, jparams, tapi, model, prompt: np.ndarray, gen: int, cap: int):
    """Prefill then ``gen`` greedy steps in both packages; yields the pair
    of logits (and caches after prefill) step by step."""
    b = prompt.shape[0]
    jcache = japi.init_cache(b, cap)
    jl, jcache = jax.jit(japi.prefill)(jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tapi.init_cache(b, cap, "cpu")
    tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt)}, tcache)
    # the port writes its cache in place: keep a copy of each step's
    snap = lambda c: c._replace(k=c.k.clone(), v=c.v.clone())    # noqa: E731
    steps = [(jl, tl, jcache, snap(tcache))]
    decode = jax.jit(japi.decode_step)
    for _ in range(gen):
        jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tn = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())     # same greedy token
        jl, jcache = decode(jparams, jcache, {"tokens": jn})
        tl, tcache = tapi.decode_step(model, tcache, {"tokens": tn})
        steps.append((jl, tl, jcache, snap(tcache)))
    return steps


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


def test_configs_match_the_reference():
    for jc, tc in ((j_get_config(ARCH), get_config(ARCH)),
                   (j_get_smoke_config(ARCH), get_smoke_config(ARCH))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_counts() == tc.param_counts()
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("qwen2_5_15b")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_smoke_config(ARCH).replace(family="speech"))


def test_attention_is_mea_only(f32_pair):
    """The port's prefill attention is always ``mea_attention``; the
    reference's ``attn_impl="naive"`` raises rather than take another path."""
    _, _, _, model = f32_pair
    cfg = get_smoke_config(ARCH).replace(dtype="float32", attn_impl="naive")
    tapi = build_model(cfg)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attn_impl"):
        tapi.prefill(model, {"tokens": toks}, tapi.init_cache(1, 16, "cpu"))


def test_prefill_and_decode_match_f32(f32_pair):
    japi, jparams, tapi, model = f32_pair
    prompt = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    steps = _run_both(japi, jparams, tapi, model, prompt, gen=8, cap=40)
    jl, tl, jcache, tcache = steps[0]
    _close(tl, jl, F32_TOL)
    assert tcache.pos == int(jcache.pos) == 24
    _close(tcache.k, jcache.k, F32_TOL)
    _close(tcache.v, jcache.v, F32_TOL)
    for jl, tl, jcache, tcache in steps[1:]:
        _close(tl, jl, F32_TOL)
    assert tcache.pos == int(jcache.pos) == 32
    _close(tcache.k, jcache.k, F32_TOL)


def test_prefill_and_decode_match_sliding_window_ring():
    """Window 16 and a 24-token prompt: the cache holds 16 slots, prefill
    keeps the last 16 tokens rolled to their slots, decode wraps."""
    japi, jparams, tapi, model = _pair(sliding_window=16)
    prompt = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    steps = _run_both(japi, jparams, tapi, model, prompt, gen=8, cap=40)
    for jl, tl, jcache, tcache in steps:
        assert tcache.capacity == jcache.capacity == 16
        _close(tl, jl, F32_TOL)
        _close(tcache.k, jcache.k, F32_TOL)
        _close(tcache.v, jcache.v, F32_TOL)


def test_prefill_and_decode_match_bf16():
    japi, jparams, tapi, model = _pair(dtype="bfloat16")
    assert model.embedding.dtype == torch.bfloat16
    prompt = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(np.int32)
    jl, tl, _, _ = _run_both(japi, jparams, tapi, model, prompt, gen=0, cap=32)[0]
    _close(tl, jl, BF16_TOL)
    # after the prompt, both packages decode the same reference tokens
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    jcache = japi.init_cache(2, 32)
    _, jcache = jax.jit(japi.prefill)(jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    jd, _ = jax.jit(japi.decode_step)(jparams, jcache, {"tokens": tok})
    tcache = tapi.init_cache(2, 32, "cpu")
    _, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt)}, tcache)
    td, _ = tapi.decode_step(model, tcache, {"tokens": torch.from_numpy(np.array(tok))})
    _close(td, jd, BF16_TOL)


def test_embedding_scale_rounds_in_the_table_dtype():
    """sqrt(5120) = 71.55 scales bf16 embeddings as 71.5, as the reference's
    ``jnp.asarray(jnp.sqrt(d_model), emb.dtype)`` does."""
    from repro_torch.models.transformer import embed_tokens
    cfg = get_smoke_config(ARCH).replace(d_model=5120)
    emb = torch.ones((4, 5120), dtype=torch.bfloat16)
    x = embed_tokens(cfg, {"embedding": emb}, torch.tensor([[1]]))
    assert float(x[0, 0, 0]) == 71.5
    jx = jnp.ones((4, 5120), jnp.bfloat16)[jnp.asarray([[1]])] * jnp.asarray(
        jnp.sqrt(5120), jnp.bfloat16)
    assert float(jx[0, 0, 0]) == 71.5


def test_decode_after_prefill_matches_longer_prefill(f32_pair):
    """Decoding token t after prefill[0:t] gives prefill[0:t+1]'s logits
    (``tests/test_models_smoke.py::test_decode_matches_prefill``)."""
    _, _, tapi, model = f32_pair
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (1, 18))
                            .astype(np.int32))
    s = 17
    _, cache = tapi.prefill(model, {"tokens": toks[:, :s]}, tapi.init_cache(1, 64, "cpu"))
    dec, _ = tapi.decode_step(model, cache, {"tokens": toks[:, s]})
    full, _ = tapi.prefill(model, {"tokens": toks}, tapi.init_cache(1, 64, "cpu"))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **F32_TOL)


def test_serve_runs_on_the_host():
    res = serve.main(["--scale", "tiny", "--device", "cpu", "--batch", "2",
                      "--prompt", "16", "--gen", "4"])
    assert res.device == torch.device("cpu")
    assert res.tokens.shape == (2, 4) and len(res.logits) == 5
    assert all(lg.shape == (2, 2048) and bool(torch.isfinite(lg).all())
               for lg in res.logits)
    # the host takes the plain versions: no kernel was launched
    assert res.launches_prefill == {"flash_attention": 0, "flash_decode": 0, "flash_decode_lse": 0}
    assert res.launches_decode == {"flash_attention": 0, "flash_decode": 0, "flash_decode_lse": 0}
    again = serve.main(["--scale", "tiny", "--device", "cpu", "--batch", "2",
                        "--prompt", "16", "--gen", "4"])
    assert torch.equal(again.tokens, res.tokens)    # weights and prompt from the seed


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--scale", "tiny", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_params(get_smoke_config(ARCH))


def test_params_from_jax_needs_the_config(f32_pair):
    japi, jparams, _, _ = f32_pair
    tree = jax.tree.map(np.asarray, unbox(jparams))
    with pytest.raises(ValueError, match="cfg"):
        params_from_jax(tree, device="cpu")
    with pytest.raises(ValueError):
        params_from_jax(tree, device="cpu",
                        cfg=get_smoke_config(ARCH).replace(dtype="float32", num_layers=3))
