"""Port parity, LLM training pieces: ``make_lm_federated`` bit for bit,
``chunked_xent`` and ``loss_fn`` on Qwen2.5-14B's smoke configuration (f32)
and every leaf's gradient against ``jax.grad(api.loss)`` within 1e-5, and
K3's gradient (``flash_attention_bwd_torch``, ``FlashAttention`` under
``torch.autograd``, ``torch.func.grad`` and ``vmap``) against ``jax.grad`` of
``repro.models.layers.mea_attention`` within 2e-5. The same numpy inputs go
to both packages; the CUDA kernels run only on the card (``chip_smoke.py``)."""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import synthetic as j_synthetic
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.sharding.logical import unbox

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import (BWD_KERNELS, FlashAttention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_torch, kernel_symbol)
from repro_torch.models import transformer
from repro_torch.models.api import build_model

ARCH = "qwen2_5_14b"
#: f32, the two packages differ in sum order only
TOL = dict(rtol=1e-5, atol=1e-5)
#: the attention gradient: longer sums (every key of a row, every query of
#: a KV head's group) in another order than XLA's
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    """(JAX api, JAX params, port api, port flat params, axes) on the smoke
    config in f32, the weights of ``PRNGKey(0)``."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu",
                                   cfg=tcfg, flat=True)
    return japi, jp, tapi, params, axes


def _batch(seed, b=3, s=64, vocab=512, labels=False, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _stacked(flat_port):
    """The port's flat dict as the JAX package's flat names, layers stacked."""
    out, layers = {}, {}
    for name, t in flat_port.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(f"layers.{rest}", {})[int(i)] = t.detach().numpy()
        else:
            out[name] = t.detach().numpy()
    for name, by_layer in layers.items():
        out[name] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(num_clients=20, vocab=3000, seq_len=16,
                                             samples_per_client=3, zipf_a=1.3, seed=5)])
def test_make_lm_federated_bit_identical(kw):
    ref, port = j_synthetic.make_lm_federated(**kw), synthetic.make_lm_federated(**kw)
    assert (port.name, port.task, port.feature_key) == (ref.name, ref.task, "tokens")
    assert (port.num_clients, port.num_features) == (ref.num_clients, ref.num_features)
    for name in ("client_data", "test_data"):
        got, want = getattr(port, name), getattr(ref, name)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(port.sample_counts, ref.sample_counts)
    np.testing.assert_array_equal(port.heat.counts, ref.heat.counts)
    assert port.heat.total == ref.heat.total
    assert port.stats() == ref.stats()


# ---------------------------------------------------------------------------
# chunked_xent, loss_fn and the gradient of every leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [64, 16])
@pytest.mark.parametrize("labels,mask", [(False, False), (True, True), (False, True)])
def test_chunked_xent_matches(models, chunk, labels, mask):
    japi, jp, tapi, params, _ = models
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(3, 64, japi.cfg.d_model)).astype(np.float32)
    b = _batch(2, labels=True, mask=mask)
    targets = b["labels"] if labels else np.pad(b["tokens"][:, 1:], ((0, 0), (0, 1)))
    m = b["mask"] if mask else np.ones((3, 64), np.float32)
    want = j_transformer.chunked_xent(japi.cfg, jp, jnp.asarray(hidden), jnp.asarray(targets),
                                      jnp.asarray(m), chunk=chunk)
    got = transformer.chunked_xent(tapi.cfg, params, torch.from_numpy(hidden),
                                   torch.from_numpy(targets), torch.from_numpy(m), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_chunked_xent_rejects_a_ragged_chunk(models):
    _, _, tapi, params, _ = models
    with pytest.raises(ValueError, match="multiple"):
        transformer.chunked_xent(tapi.cfg, params, torch.zeros(1, 24, 128),
                                 torch.zeros(1, 24, dtype=torch.int32), torch.ones(1, 24),
                                 chunk=16)


@pytest.mark.parametrize("labels,mask,s", [(False, False, 64), (True, False, 64),
                                           (True, True, 64), (False, True, 1024)])
def test_loss_and_every_gradient_match_jax(models, labels, mask, s):
    """At 1,024 tokens ``loss_fn``'s 512-token chunks are two."""
    japi, jp, tapi, params, _ = models
    jb, tb = _both(_batch(3, b=2 if s > 64 else 3, s=s, labels=labels, mask=mask))
    jl, jg = jax.value_and_grad(japi.loss)(jp, jb)
    tg, tl = torch.func.grad_and_value(tapi.loss)(params, tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = _stacked(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)


def test_module_and_flat_dict_give_one_forward(models):
    """Serving's module and the trainer's flat dict are one forward."""
    _, _, tapi, params, _ = models
    model = transformer.make_params(tapi.cfg, device="cpu", state=params)
    toks = torch.from_numpy(_batch(4)["tokens"])
    a = transformer.forward(tapi.cfg, model, toks).hidden
    b = transformer.forward(tapi.cfg, params, toks).hidden
    assert torch.equal(a, b)
    assert torch.equal(tapi.loss(model, {"tokens": toks}), tapi.loss(params, {"tokens": toks}))
    flat, axes = transformer.train_params(model)
    assert flat.keys() == axes.keys() == params.keys()
    assert axes["lm_head"] == ("embed", "vocab") and axes["embedding"] == ("vocab", "embed")
    assert flat["lm_head"].data_ptr() == model.lm_head.data_ptr()


# ---------------------------------------------------------------------------
# K3's gradient
# ---------------------------------------------------------------------------


#: (B, Sq, Sk, H, KV, hd, window, q_offset, chunk): GQA; a window; Sq != Sk
#: with chunk padding on both sides (a continuation at q_offset = Sk - Sq)
ATTN_CASES = {
    "gqa": (2, 64, 64, 8, 2, 32, 0, 0, 32),
    "window": (2, 80, 80, 4, 2, 16, 24, 0, 32),
    "ragged continuation": (1, 37, 90, 6, 3, 32, 0, 53, 32),
}


def _attn_inputs(case, seed=0, clients=None):
    b, sq, sk, h, kv, hd, window, off, chunk = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    lead = () if clients is None else (clients,)
    q, k, v = (rng.normal(size=lead + shape).astype(np.float32)
               for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    w = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    return q, k, v, w, dict(causal=True, window=window, q_offset=off, query_chunk=chunk,
                            kv_chunk=chunk)


def _jax_grads(q, k, v, w, kw):
    def f(q, k, v):
        return (j_layers.mea_attention(q, k, v, **kw) * w).sum()

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_bwd_matches_jax(case):
    q, k, v, w, kw = _attn_inputs(case)
    want = _jax_grads(q, k, v, w, kw)
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    opts = dict(causal=True, window=kw["window"], q_offset=kw["q_offset"])
    out = flash_attention_torch(tq, tk, tv, **kw)
    plain = flash_attention_bwd_torch(tq, tk, tv, out, tw, **opts)
    assert flash_attention_bwd(tq, tk, tv, out, tw, **opts)[0].equal(plain[0])
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fused = torch.autograd.grad((FlashAttention.apply(*leaves, True, kw["window"],
                                                      kw["q_offset"], kw["query_chunk"],
                                                      kw["kv_chunk"]) * tw).sum(), leaves)
    autograd = torch.autograd.grad((flash_attention_torch(*leaves, **kw) * tw).sum(), leaves)
    for name, p, f, a, j in zip("qkv", plain, fused, autograd, want):
        np.testing.assert_allclose(p.numpy(), j, err_msg=f"d{name}", **ATTN_TOL)
        np.testing.assert_allclose(f.numpy(), j, err_msg=f"d{name}", **ATTN_TOL)
        np.testing.assert_allclose(a.numpy(), j, err_msg=f"d{name}", **ATTN_TOL)


@pytest.mark.parametrize("case", ["gqa", "ragged continuation"])
def test_flash_attention_grad_under_vmap_matches_jax(case):
    """``vmap(grad)`` over a client axis, as the replicated plans run it;
    K and V shared by the clients (unbatched) take the expand path."""
    clients = 3
    q, k, v, w, kw = _attn_inputs(case, seed=1, clients=clients)
    tw = torch.from_numpy(w)
    loss = lambda q, k, v: (FlashAttention.apply(q, k, v, True, kw["window"],  # noqa: E731
                                                 kw["q_offset"], kw["query_chunk"],
                                                 kw["kv_chunk"]) * tw).sum()
    got = vmap(grad(loss, argnums=(0, 1, 2)))(*(torch.from_numpy(x) for x in (q, k, v)))
    shared = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=(0, None, None))(
        torch.from_numpy(q), torch.from_numpy(k[0]), torch.from_numpy(v[0]))
    for c in range(clients):
        want = _jax_grads(q[c], k[c], v[c], w, kw)
        for name, g, j in zip("qkv", got, want):
            np.testing.assert_allclose(g[c].numpy(), j, err_msg=f"client {c} d{name}",
                                       **ATTN_TOL)
        want = _jax_grads(q[c], k[0], v[0], w, kw)
        for name, g, j in zip("qkv", shared, want):
            np.testing.assert_allclose(g[c].numpy(), j, err_msg=f"shared {c} d{name}",
                                       **ATTN_TOL)


def test_flash_attention_bwd_raises_off_the_host_without_a_card():
    """A tensor off the CPU launches the gradient's kernel or raises; it
    checks its inputs first and never falls back to the plain version."""
    assert kernel_symbol(torch.float32, BWD_KERNELS) == "flash_attention_bwd_f32_launch"
    assert kernel_symbol(torch.bfloat16, BWD_KERNELS) == "flash_attention_bwd_bf16_launch"
    q = torch.empty((1, 64, 4, 32), device="meta")
    k = torch.empty((1, 64, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, k, q, q)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, k, k, q, q[:, :32])
    with pytest.raises(TypeError, match="f32 or bf16"):
        flash_attention_bwd(q, k, k, q, q.to(torch.bfloat16))
    bad = torch.empty((1, 64, 4, 48), device="meta")
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_bwd(bad, bad[:, :, :2], bad[:, :, :2], bad, bad)
