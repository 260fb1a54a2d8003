"""Port parity, K3's gradient as it runs on the card: K3's log-sum-exp
(``flash_attention_torch(return_lse=True)``) against a float64 numpy one of
the masked scores within 1e-5, ``flash_attention_bwd_torch`` on that
log-sum-exp against its own recomputation within 1e-6, ``FlashAttention``
(which carries the log-sum-exp from its forward to its backward) under
``torch.autograd``, ``torch.func.grad`` and ``vmap(grad)`` against
``jax.grad`` of ``repro.models.layers.mea_attention`` within 2e-5, with
and without grad mode (serving asks K3 for no log-sum-exp, and ``vmap``
folds its clients either way), the plain gradient in f64, and the cluster
size ``bwd_cluster`` gives the dK/dV launch. The kernels themselves run only
on the card (``chip_smoke.py`` [34] and [38])."""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import jax
import jax.numpy as jnp

from repro.models import layers as j_layers

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (FlashAttention, bwd_cluster,
                                                 flash_attention, flash_attention_bwd_torch,
                                                 flash_attention_torch)
from repro_torch.models import layers

#: the attention gradient against XLA's: long sums in another order
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)

#: (B, Sq, Sk, H, KV, hd, causal, window, q_offset, chunk): GQA; a window;
#: a continuation (Sq != Sk, q_offset = Sk - Sq, chunk padding); non-causal
#: with a window; rows with no valid key (non-causal, window, Sk < Sq)
CASES = {
    "gqa": (2, 64, 64, 8, 2, 32, True, 0, 0, 32),
    "window": (2, 80, 80, 4, 2, 16, True, 24, 0, 32),
    "continuation": (1, 37, 90, 6, 3, 32, True, 0, 53, 32),
    "non-causal": (1, 48, 70, 4, 4, 16, False, 0, 0, 32),
    "empty rows": (1, 64, 24, 4, 2, 16, False, 10, 0, 32),
}


def _inputs(case, seed=0, clients=None):
    b, sq, sk, h, kv, hd, causal, window, off, chunk = CASES[case]
    rng = np.random.default_rng(seed)
    lead = () if clients is None else (clients,)
    q, k, v = (rng.normal(size=lead + shape).astype(np.float32)
               for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    w = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    return q, k, v, w, dict(causal=causal, window=window, q_offset=off, query_chunk=chunk,
                            kv_chunk=chunk)


def _numpy_lse(q, k, kw):
    """(B, H, Sq) log-sum-exp of the scaled scores over each row's valid keys
    in float64; +inf on a row with none."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kh = np.repeat(k.astype(np.float64), h // kvh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kh) * fa._scale(hd)
    qpos = kw["q_offset"] + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), dtype=bool)
    if kw["causal"]:
        valid &= kpos <= qpos
    if kw["window"] > 0:
        valid &= kpos > qpos - kw["window"]
    s = np.where(valid, s, -np.inf)
    m = s.max(axis=-1)
    finite = np.isfinite(m)
    m_safe = np.where(finite, m, 0.0)
    with np.errstate(divide="ignore"):
        lse = m_safe + np.log(np.exp(s - m_safe[..., None]).sum(axis=-1))
    return np.where(finite, lse, np.inf)


def _jax_grads(q, k, v, w, kw):
    def f(q, k, v):
        return (j_layers.mea_attention(q, k, v, **kw) * w).sum()

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _bwd_opts(kw):
    return dict(causal=kw["causal"], window=kw["window"], q_offset=kw["q_offset"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_float64(case):
    q, k, v, _, kw = _inputs(case)
    out, lse = flash_attention_torch(*(torch.from_numpy(x) for x in (q, k, v)), **kw,
                                     return_lse=True)
    want = _numpy_lse(q, k, kw)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    got = lse.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert (got[np.isinf(got)] > 0).all()
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], **LSE_TOL)
    # the output is the one without return_lse, bit for bit
    assert out.equal(flash_attention_torch(*(torch.from_numpy(x) for x in (q, k, v)), **kw))
    if case == "empty rows":
        assert np.isinf(want).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_on_lse_matches_recomputed(case):
    q, k, v, w, kw = _inputs(case, seed=2)
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out, lse = flash_attention(tq, tk, tv, **kw, return_lse=True)
    with_lse = flash_attention_bwd_torch(tq, tk, tv, out, tw, **_bwd_opts(kw), lse=lse)
    recomputed = flash_attention_bwd_torch(tq, tk, tv, out, tw, **_bwd_opts(kw))
    for name, a, r in zip("qkv", with_lse, recomputed):
        assert torch.isfinite(a).all(), f"d{name}"
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6, msg=f"d{name}")


#: a row with no valid key: the reference's output there is the mean of V
#: over its masked keys, whose gradient the port does not give (P = 0, no
#: gradient flows through such a row; ``flash_attention_bwd_torch``)
JAX_CASES = sorted(set(CASES) - {"empty rows"})


@pytest.mark.parametrize("case", JAX_CASES)
def test_flash_attention_grad_carries_lse_and_matches_jax(case):
    q, k, v, w, kw = _inputs(case, seed=3)
    want = _jax_grads(q, k, v, w, kw)
    tw = torch.from_numpy(w)
    opts = (kw["causal"], kw["window"], kw["q_offset"], kw["query_chunk"], kw["kv_chunk"])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = FlashAttention.apply(*leaves, *opts)
    assert not lse.requires_grad
    torch.testing.assert_close(lse, flash_attention_torch(*leaves, **kw, return_lse=True)[1],
                               rtol=0, atol=0)
    fused = torch.autograd.grad((out * tw).sum(), leaves)
    loss = lambda q, k, v: (FlashAttention.apply(q, k, v, *opts)[0] * tw).sum()  # noqa: E731
    functional = grad(loss, argnums=(0, 1, 2))(*(torch.from_numpy(x) for x in (q, k, v)))
    for name, f, g, j in zip("qkv", fused, functional, want):
        np.testing.assert_allclose(f.numpy(), j, err_msg=f"d{name}", **ATTN_TOL)
        np.testing.assert_allclose(g.numpy(), j, err_msg=f"grad d{name}", **ATTN_TOL)


@pytest.mark.parametrize("case", ["gqa", "non-causal"])
def test_flash_attention_vmap_grad_folds_lse(case):
    """``vmap(grad)`` over a client axis: both ``vmap`` rules fold the
    log-sum-exp into the batch like the output."""
    clients = 3
    q, k, v, w, kw = _inputs(case, seed=4, clients=clients)
    tw = torch.from_numpy(w)
    opts = (kw["causal"], kw["window"], kw["q_offset"], kw["query_chunk"], kw["kv_chunk"])
    loss = lambda q, k, v: (FlashAttention.apply(q, k, v, *opts)[0] * tw).sum()  # noqa: E731
    got = vmap(grad(loss, argnums=(0, 1, 2)))(*(torch.from_numpy(x) for x in (q, k, v)))
    lse = vmap(lambda q, k, v: FlashAttention.apply(q, k, v, *opts)[1])(
        *(torch.from_numpy(x) for x in (q, k, v)))
    for c in range(clients):
        np.testing.assert_allclose(lse[c].numpy(), _numpy_lse(q[c], k[c], kw), **LSE_TOL)
        for name, g, j in zip("qkv", got, _jax_grads(q[c], k[c], v[c], w, kw)):
            np.testing.assert_allclose(g[c].numpy(), j, err_msg=f"client {c} d{name}",
                                       **ATTN_TOL)


def _spy_k3(monkeypatch):
    """Record, for each call of K3 through ``FlashAttention``, whether it was
    asked for the log-sum-exp and whether it was handed a vmapped tensor (a
    ctypes launch on the card cannot take one)."""
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw.get("return_lse", False), torch._C._functorch.is_batchedtensor(q)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    return calls


def test_serving_asks_for_no_lse(monkeypatch):
    """Without grad mode (serving) ``mea_attention`` asks K3 for no
    log-sum-exp; with it, for one. Both go through ``FlashAttention``."""
    q, k, v, _, kw = _inputs("gqa")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    calls = _spy_k3(monkeypatch)
    with torch.no_grad():
        served = layers.mea_attention(tq, tk, tv, **kw)
    assert calls == [(False, False)]
    trained = layers.mea_attention(tq, tk, tv, **kw)
    assert calls == [(False, False), (True, False)]
    assert served.equal(trained) and served.equal(flash_attention_torch(tq, tk, tv, **kw))


@pytest.mark.parametrize("case", ["gqa", "window"])
def test_vmap_without_grad_mode_folds_clients(monkeypatch, case):
    """``vmap`` of ``mea_attention`` under ``no_grad`` (per-client evaluation)
    goes through ``FlashAttention``'s ``vmap`` rule: K3 sees the clients
    folded into B, never a vmapped tensor, and no log-sum-exp is asked for."""
    clients = 3
    q, k, v, _, kw = _inputs(case, seed=5, clients=clients)
    calls = _spy_k3(monkeypatch)
    with torch.no_grad():
        got = vmap(lambda q, k, v: layers.mea_attention(q, k, v, **kw))(
            *(torch.from_numpy(x) for x in (q, k, v)))
    assert calls == [(False, False)]
    for c in range(clients):
        want = flash_attention_torch(*(torch.from_numpy(x[c]) for x in (q, k, v)), **kw)
        torch.testing.assert_close(got[c], want, rtol=0, atol=0)


def test_grad_without_lse_recomputes_it():
    """``FlashAttention`` asked for no log-sum-exp returns None for it, and
    its backward recomputes it: the same gradient as with it."""
    q, k, v, w, kw = _inputs("continuation", seed=6)
    tw = torch.from_numpy(w)
    opts = (kw["causal"], kw["window"], kw["q_offset"], kw["query_chunk"], kw["kv_chunk"])
    grads = []
    for need_lse in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out, lse = FlashAttention.apply(*leaves, *opts, need_lse)
        assert (lse is None) == (not need_lse)
        grads.append(torch.autograd.grad((out * tw).sum(), leaves))
    for name, a, b in zip("qkv", *grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=f"d{name}")


@pytest.mark.parametrize("case", ["gqa", "continuation"])
def test_plain_bwd_in_float64(case):
    """The plain gradient keeps f64 inputs in f64 (the exact reference
    ``chip_smoke.py`` [34] holds its sharp case to) and agrees with its f32
    run within the f32 tolerance."""
    q, k, v, w, kw = _inputs(case, seed=7)
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out = flash_attention(tq, tk, tv, **kw)
    f32 = flash_attention_bwd_torch(tq, tk, tv, out, tw, **_bwd_opts(kw))
    f64 = flash_attention_bwd_torch(*(x.double() for x in (tq, tk, tv, out, tw)),
                                    **_bwd_opts(kw))
    for name, a, b in zip("qkv", f32, f64):
        assert b.dtype == torch.float64
        torch.testing.assert_close(a.double(), b, msg=f"d{name}", **ATTN_TOL)


#: (H, KV): the training round's group of 5, groups of 1, 2, 4, 8, 10 (two
#: heads to a block), 11 (prime above 8: one block loops over the group),
#: 16 and 22
CLUSTER_GROUPS = [(40, 8), (4, 4), (8, 4), (8, 2), (16, 2), (20, 2), (22, 2), (16, 1),
                  (22, 1)]


@pytest.mark.parametrize("h,kvh", CLUSTER_GROUPS)
def test_bwd_cluster_divides_the_group(h, kvh):
    """The cluster is at most 8 blocks, divides the group (so every block
    takes as many of its heads), and is the largest such divisor: the whole
    group when it fits."""
    groups, c = h // kvh, bwd_cluster(h, kvh)
    assert 1 <= c <= fa.BWD_MAX_CLUSTER and groups % c == 0
    assert c == groups or groups > fa.BWD_MAX_CLUSTER
    assert not any(groups % d == 0 for d in range(c + 1, fa.BWD_MAX_CLUSTER + 1))


def test_bwd_cluster_at_the_training_shape():
    """Qwen2.5-14B's training round (H 40, KV 8): a cluster of 5, one head a
    block, 1,280 dK/dV blocks at B 16, S 128; group 11 takes one block."""
    assert bwd_cluster(40, 8) == 5
    assert bwd_cluster(11, 1) == 1 and bwd_cluster(22, 1) == 2
