"""Port parity, the registry and the dense configurations: every registered
``CONFIG``, its smoke config and ``SHAPES`` equal to the JAX package's field
for field (``param_counts`` too); ``input_specs`` against the reference's
``ShapeDtypeStruct``s for every arch x shape; ``abstract_params`` on the
``meta`` device at full size against the reference's abstract tree
(Whisper's among them); an unknown name or family raising; and
Qwen3-32B's, DeepSeek-67B's
and Mistral Large 123B's smoke configs through ``repro_torch`` against
``repro.models.build_model`` on the weights of ``PRNGKey(0)`` (carried
across by ``convert.params_from_jax``): loss and every gradient, prefill
and greedy decode, within 1e-5 (f32)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_arch_ids as j_all_arch_ids
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.sharding.logical import unbox

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig, all_arch_ids,
                                      get_config, get_smoke_config)
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.models import transformer
from repro_torch.models.api import build_model

TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ("qwen3_32b", "deepseek_67b", "mistral_large_123b")
TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


def test_registry_is_the_reference_order_less_the_unported():
    """Every architecture of the reference is ported: the registry is the
    reference's, in its order, and leaves none out."""
    assert all_arch_ids() == ARCH_IDS == tuple(j_all_arch_ids())
    assert {get_config(a).family for a in ARCH_IDS} == {"moe", "audio", "dense", "hybrid",
                                                        "vlm", "ssm"}


def test_unknown_architecture_raises():
    """A name the registry does not hold raises from ``get_config`` and
    ``get_smoke_config``; a config of a family no module builds raises from
    ``build_model``."""
    for lookup in (get_config, get_smoke_config):
        with pytest.raises(ValueError, match="unknown architecture 'whisper_tiny'"):
            lookup("whisper_tiny")
    # the reference's Whisper smoke config, field for field, as the port's
    # type, with a family no module builds
    cfg = ModelConfig(**dataclasses.asdict(j_get_smoke_config("whisper_large_v3")))
    assert build_model(cfg).cfg == cfg
    with pytest.raises(ValueError, match="unknown family 'speech'"):
        build_model(cfg.replace(family="speech"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_the_reference(arch):
    for jc, tc in ((j_get_config(arch), get_config(arch)),
                   (j_get_smoke_config(arch), get_smoke_config(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.param_counts() == tc.param_counts()
        assert (jc.is_moe, jc.has_attention) == (tc.is_moe, tc.has_attention)
    # dashes are accepted, as the reference accepts them
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_shapes_match_the_reference():
    assert SHAPES.keys() == J_SHAPES.keys()
    for name, sc in J_SHAPES.items():
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(sc)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    japi, tapi = j_build_model(j_get_config(arch)), build_model(get_config(arch))
    for shape in J_SHAPES:
        want, got = japi.input_specs(shape), tapi.input_specs(shape)
        assert got.keys() == want.keys(), shape
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape), (shape, key)
            assert got[key].dtype == TORCH_DTYPES[str(spec.dtype)], (shape, key)
    if tapi.cfg.is_moe:
        assert tuple(tapi.input_specs("train_4k")["heat_expert"].shape) == (
            tapi.cfg.num_experts,)


def _uncounted(cfg) -> int:
    """The parameters ``param_counts`` leaves out of ``total``: the final
    norm, the QKV biases and the QK norms, and Whisper's cross-attention
    (the reference's analytic count omits them; its parameter tree holds
    them)."""
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    per_layer = (q + 2 * kv) * cfg.qkv_bias + 2 * cfg.head_dim * cfg.qk_norm
    if cfg.family == "audio":
        # Whisper: the decoder's cross-attention and its norm, the biases of
        # wq, wv and wo in every attention, the encoder's final norm
        d = cfg.d_model
        biases = q + kv + d
        per_layer = 2 * d * q + 2 * d * kv + d + 2 * biases
        return 2 * d + cfg.num_layers * per_layer + cfg.encoder_layers * biases
    return cfg.d_model + cfg.num_layers * per_layer


def _recurrent_total(cfg) -> int:
    """Zamba2's and xLSTM's parameter trees, counted leaf by leaf from the
    reference's ``make_params`` (its analytic ``param_counts`` describes
    neither: it counts Zamba2's shared attention at every layer and gives
    xLSTM's blocks Mamba2's widths)."""
    d, v = cfg.d_model, cfg.vocab_size
    di, h = cfg.ssm_expand * d, cfg.ssm_heads
    if cfg.family == "hybrid":
        n, conv = cfg.ssm_state, di + 2 * cfg.ssm_state
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        mamba = (d + d * (2 * di + 2 * n + h) + cfg.ssm_conv_width * conv + conv + 3 * h
                 + di + di * d)
        shared = 2 * d * q + 2 * d * kv + 3 * d * cfg.d_ff + 2 * d
        return cfg.num_layers * mamba + shared + 2 * v * d + d
    m = d + 2 * d * di + 3 * di * di + 2 * di * h + 2 * h + di + di * d
    s = d + 4 * d * d + 4 * d * (d // h) + 4 * d + d + 2 * d * d + d * d
    return sum(m if b == "m" else s for b in cfg.block_pattern) + 2 * v * d + d


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_at_full_size(arch):
    """The whole published model on ``meta``: no storage, every leaf's
    shape and dtype the reference's abstract tree's, and as many
    parameters as ``param_counts()["total"]`` plus the leaves that count
    omits (Zamba2 and xLSTM: as their trees hold, ``_recurrent_total``)."""
    cfg = get_config(arch)
    model = build_model(cfg).abstract_params()
    flat, axes = transformer.train_params(model)
    assert all(t.device.type == "meta" for t in flat.values())
    n = sum(t.numel() for t in flat.values())
    if cfg.family in ("hybrid", "ssm"):
        assert n == _recurrent_total(cfg)
    else:
        assert n == cfg.param_counts()["total"] + _uncounted(cfg)
    tree = unbox(j_build_model(j_get_config(arch)).abstract_params())
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): spec
            for path, spec in jax.tree_util.tree_leaves_with_path(tree)}
    got, _ = transformer.stack_layers(flat, axes)
    assert got.keys() == want.keys()
    for name, spec in want.items():
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert got[name].dtype == TORCH_DTYPES[str(spec.dtype)], name
    assert sum(int(np.prod(s.shape)) for s in want.values()) == n


# ---------------------------------------------------------------------------
# the dense smoke configs against the JAX package
# ---------------------------------------------------------------------------


def _pair(arch, flat):
    jcfg = j_get_smoke_config(arch).replace(dtype="float32")
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    params, _ = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu", cfg=tcfg,
                                flat=flat)
    return japi, jp, tapi, params


def _stacked(flat_port):
    out, by_layer = {}, {}
    for name, t in flat_port.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            by_layer.setdefault(f"layers.{rest}", {})[int(i)] = t.detach().numpy()
        else:
            out[name] = t.detach().numpy()
    for name, d in by_layer.items():
        out[name] = np.stack([d[i] for i in range(len(d))])
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_and_every_gradient_match_jax(arch):
    japi, jp, tapi, params = _pair(arch, flat=True)
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, 512, (3, 64)).astype(np.int32),
         "mask": (rng.random((3, 64)) < 0.8).astype(np.float32)}
    jl, jg = jax.value_and_grad(japi.loss)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tl = torch.func.grad_and_value(tapi.loss)(params, {k: torch.from_numpy(v)
                                                          for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = _stacked(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)
    if tapi.cfg.qk_norm:
        assert np.abs(got["layers.attn.q_norm"]).max() > 0


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match_jax(arch):
    japi, jp, tapi, model = _pair(arch, flat=False)
    prompt = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    jcache = japi.init_cache(2, 32)
    jl, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tapi.init_cache(2, 32, "cpu")
    tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt)}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    decode = jax.jit(japi.decode_step)
    for _ in range(6):
        jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tn = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        jl, jcache = decode(jp, jcache, {"tokens": jn})
        tl, tcache = tapi.decode_step(model, tcache, {"tokens": tn})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache.pos == int(jcache.pos) == 30
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_launchers_serve_and_train_on_the_host(arch):
    """The serving and training launchers at ``--scale tiny --device cpu``
    for each dense configuration: finite logits and losses, the cache at
    prompt + gen."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    res = serve_mod.main(["--arch", arch, "--scale", "tiny", "--device", "cpu", "--batch", "2",
                          "--prompt", "16", "--gen", "3"])
    assert res.tokens.shape == (2, 3) and res.cache_pos == 19
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    out = train_mod.main(["--arch", arch, "--scale", "tiny", "--device", "cpu", "--rounds", "2",
                          "--clients", "16", "--cohort", "4", "--seq", "32"])
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
