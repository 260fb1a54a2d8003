"""Port parity, the MoE family: ``repro_torch.models.layers.moe`` against
``repro.models.layers.moe`` on numpy inputs (capacity that drops and that
does not, token chunks, a deterministic capacity, a zero router whose
probabilities all tie, bf16; gradients against ``jax.grad``; under
``torch.func.vmap``), then Mixtral 8x22B's smoke configuration through
``repro_torch`` against ``repro.models.build_model`` on the weights of
``PRNGKey(0)`` carried across by ``convert.params_from_jax``: forward, the
loss with its aux term and every gradient, prefill and greedy decode past
the window of 32 with the ring wrapped, decode against a longer prefill,
and ``make_round_step`` in its four modes with ``heat_expert`` (FedSubAvg
corrects per expert). f32 within 1e-5, bf16 within 2e-2; ``expert_tokens``
exact."""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.federated import make_round_step as j_make_round_step
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig, get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.federated.plan import heat_spec_from_axes
from repro_torch.federated.simulation import make_round_step
from repro_torch.models import layers, transformer
from repro_torch.models.api import build_model

ARCH = "mixtral_8x22b"
#: f32: the two packages differ in sum order and last-ulp transcendentals
TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16: both round every activation to 8 bits of mantissa, at places that
#: differ (XLA fuses, eager PyTorch rounds after each op)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D, FF, E, K = 32, 48, 4, 2


def _moe_params(seed, router="random"):
    """Experts' weights from ``seed``; the router random, all zeros, or
    skewed toward expert 0 (a column that leans on x's mean, see
    ``_moe_x``)."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
         "wi": rng.normal(size=(E, D, FF)) / np.sqrt(D),
         "wg": rng.normal(size=(E, D, FF)) / np.sqrt(D),
         "wo": rng.normal(size=(E, FF, D)) / np.sqrt(FF)}
    if router == "zero":
        p["router"] = np.zeros((D, E))
    elif router == "skewed":
        p["router"][:, 0] += 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


def _moe_x(seed, shape, router):
    x = np.random.default_rng(seed).normal(size=shape)
    return (x + 0.5 if router == "skewed" else x).astype(np.float32)


def _to_jax(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _to_torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


#: (name, moe keywords, x shape, router): capacity that drops (cf 1.25:
#: C = 30 against the 48 assignments a router skewed toward expert 0 sends
#: it) and that does not (cf 8), token chunks of 16, a deterministic
#: capacity of 3, and a zero router (every probability 1/E: the tie goes to
#: the lower expert index, as lax.top_k breaks it, so experts 0 and 1 take
#: every token and drop 18 each)
MOE_CASES = {
    "drops": (dict(capacity_factor=1.25), (2, 24, D), "skewed"),
    "no drops": (dict(capacity_factor=8.0), (2, 24, D), "skewed"),
    "random router": (dict(capacity_factor=1.25), (2, 24, D), "random"),
    "token chunk": (dict(capacity_factor=1.25, token_chunk=16), (2, 24, D), "skewed"),
    "deterministic capacity": (dict(capacity_factor=1.25, deterministic_capacity=3),
                               (2, 24, D), "random"),
    "zero router": (dict(capacity_factor=1.25), (2, 24, D), "zero"),
}


def _moe_both(case, dtype="f32", seed=0):
    kw, shape, router = MOE_CASES[case]
    p = _moe_params(seed, router)
    x = _moe_x(seed + 1, shape, router)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jo, js = j_layers.moe(_to_jax(p, jd), jnp.asarray(x).astype(jd), num_experts=E, top_k=K,
                          **kw)
    to, ts = layers.moe(_to_torch(p, td), torch.from_numpy(x).to(td), num_experts=E, top_k=K,
                        **kw)
    return (jo, js), (to, ts)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_jax_f32(case):
    (jo, js), (to, ts) = _moe_both(case)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ts.aux_loss), float(js.aux_loss), **TOL)
    assert ts.aux_loss.dtype == torch.float32
    assert ts.expert_tokens.dtype == torch.int32
    np.testing.assert_array_equal(ts.expert_tokens.numpy(), np.asarray(js.expert_tokens))


def test_moe_capacity_cases_drop_as_stated():
    """The cases do what their names say: cf 1.25 floors to C = 30 and the
    skewed router sends expert 0 more (it drops), cf 8 gives C = 192 (no
    drop), and the zero router sends every token to experts 0 and 1."""
    _, shape, _ = MOE_CASES["drops"]
    t = shape[0] * shape[1]
    assert int(max(1, 1.25 * K * t / E)) == 30 and int(max(1, 8.0 * K * t / E)) == 192
    _, (_, ts) = _moe_both("drops")
    assert int(ts.expert_tokens.max()) > 30
    _, (_, tz) = _moe_both("zero router")
    assert tz.expert_tokens.tolist() == [48, 48, 0, 0]


@pytest.mark.parametrize("case", ["drops", "no drops", "zero router"])
def test_moe_matches_jax_bf16(case):
    """bf16 is held here, on the layer's own inputs. Through a whole bf16
    model the two packages' hidden states part by bf16 roundings taken at
    different places, and XLA on the CPU also skips the bf16 rounding of
    the router product that the reference's code asks for (its logits come
    out unrounded); at the smoke config that moves router logits by up to
    0.019 and routes 2 of 48 tokens of layer 1 to another expert."""
    (jo, js), (to, ts) = _moe_both(case, dtype="bf16")
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(float(ts.aux_loss), float(js.aux_loss), **BF16_TOL)
    np.testing.assert_array_equal(ts.expert_tokens.numpy(), np.asarray(js.expert_tokens))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_gradients_match_jax(case):
    """The gradient of a weighted sum of the output plus 3 x aux, for x and
    every weight, against ``jax.grad``."""
    kw, shape, router = MOE_CASES[case]
    p = _moe_params(2, router)
    x = _moe_x(3, shape, router)
    w = np.random.default_rng(4).normal(size=shape).astype(np.float32)

    def jf(p, x):
        o, s = j_layers.moe(p, x, num_experts=E, top_k=K, **kw)
        return (o * w).sum() + 3.0 * s.aux_loss

    def tf(p, x):
        o, s = layers.moe(p, x, num_experts=E, top_k=K, **kw)
        return (o * torch.from_numpy(w)).sum() + 3.0 * s.aux_loss

    jg = jax.grad(jf, argnums=(0, 1))(_to_jax(p), jnp.asarray(x))
    tg = grad(tf, argnums=(0, 1))(_to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), err_msg="dx", **TOL)
    for name in p:
        np.testing.assert_allclose(tg[0][name].numpy(), np.asarray(jg[0][name]),
                                   err_msg=name, **TOL)


def test_moe_under_vmap_matches_each_call():
    """``torch.func.vmap`` over a client axis (the replicated plans vmap
    the loss) gives each client's own call, output, aux and counts, and
    its gradient each client's gradient."""
    p = _to_torch(_moe_params(5))
    xs = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 2, 24, D))
                          .astype(np.float32))
    kw = dict(num_experts=E, top_k=K, capacity_factor=1.25)
    vo, vs = vmap(lambda x: layers.moe(p, x, **kw))(xs)
    loss = lambda p, x: layers.moe(p, x, **kw)[0].square().sum()   # noqa: E731
    vg = vmap(grad(loss), in_dims=(None, 0))(p, xs)
    for i in range(3):
        o, s = layers.moe(p, xs[i], **kw)
        assert torch.equal(vo[i], o) and torch.equal(vs.aux_loss[i], s.aux_loss)
        assert torch.equal(vs.expert_tokens[i], s.expert_tokens)
        g = grad(loss)(p, xs[i])
        for name in p:
            torch.testing.assert_close(vg[name][i], g[name], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Mixtral's smoke configuration through the model
# ---------------------------------------------------------------------------


def _pair(dtype="float32", flat=False, **over):
    """(JAX api, JAX params, port api, port params) on the smoke config."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype=dtype, **over)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype, **over)
    japi, tapi = j_build_model(jcfg), build_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu",
                                   cfg=tcfg, flat=flat)
    return japi, jp, tapi, params, axes


@pytest.fixture(scope="module")
def flat_pair():
    return _pair(flat=True)


def _stacked(flat_port):
    """The port's flat dict as the JAX package's flat names, layers stacked."""
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


def test_moe_tree_carries_across(flat_pair):
    """``params_from_jax`` unstacks the router (L, d, E) and the experts
    (L, E, ., .) per layer, with the reference's logical axes; the heat
    spec keys the experts' axis 0 and the router's axis 1 by expert."""
    japi, jp, _, params, axes = flat_pair
    cfg = japi.cfg
    assert params["layers.0.ffn.router"].shape == (cfg.d_model, cfg.num_experts)
    assert params["layers.1.ffn.wo"].shape == (cfg.num_experts, cfg.d_ff, cfg.d_model)
    assert axes["layers.0.ffn.router"] == ("embed", "experts")
    assert axes["layers.0.ffn.wi"] == ("experts", "embed", "ffn")
    want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
    got = _stacked(params)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    spec = heat_spec_from_axes(axes)
    spaces = {s for s in spec.leaf_spaces.values() if s is not None}
    assert {s[0] for s in spaces} == {"vocab", "expert"}
    assert spec.leaf_spaces["layers.0.ffn.router"] == ("expert", 1)
    for w in ("wi", "wg", "wo"):
        assert spec.leaf_spaces[f"layers.1.ffn.{w}"] == ("expert", 0)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_forward_and_aux_match(flat_pair):
    japi, jp, tapi, params, _ = flat_pair
    from repro.models import transformer as j_transformer
    toks = _tokens(1, 3, 64)
    jout = j_transformer.forward(japi.cfg, jp, jnp.asarray(toks), remat=False)
    tout = transformer.forward(tapi.cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(tout.hidden.numpy(), np.asarray(jout.hidden), **TOL)
    np.testing.assert_allclose(float(tout.aux_loss), float(jout.aux_loss), **TOL)
    assert float(tout.aux_loss) > 0.5


@pytest.mark.parametrize("mask", [False, True])
def test_loss_with_aux_and_every_gradient_match_jax(flat_pair, mask):
    japi, jp, tapi, params, _ = flat_pair
    b = {"tokens": _tokens(2, 3, 64)}
    if mask:
        b["mask"] = (np.random.default_rng(3).random((3, 64)) < 0.7).astype(np.float32)
    jl, jg = jax.value_and_grad(japi.loss)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tl = torch.func.grad_and_value(tapi.loss)(params, {k: torch.from_numpy(v)
                                                          for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    # the aux term is in: without it the loss differs by 0.01 x aux
    ce = transformer.chunked_xent(tapi.cfg, params,
                                  transformer.forward(tapi.cfg, params,
                                                      torch.from_numpy(b["tokens"])).hidden,
                                  torch.nn.functional.pad(torch.from_numpy(b["tokens"])[:, 1:],
                                                          (0, 1)),
                                  torch.from_numpy(b["mask"]) if mask else torch.ones(3, 64))
    assert float(tl) - float(ce) > 0.005
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = _stacked(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)
    assert np.abs(got["layers.ffn.router"]).max() > 0


def _run_both(japi, jp, tapi, model, prompt, gen, cap):
    """Prefill then ``gen`` greedy steps in both packages; the logits and
    caches of each step."""
    b = prompt.shape[0]
    jcache = japi.init_cache(b, cap)
    jl, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tapi.init_cache(b, cap, "cpu")
    tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(prompt)}, tcache)
    snap = lambda c: c._replace(k=c.k.clone(), v=c.v.clone())    # noqa: E731
    steps = [(jl, tl, jcache, snap(tcache))]
    decode = jax.jit(japi.decode_step)
    for _ in range(gen):
        jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tn = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        jl, jcache = decode(jp, jcache, {"tokens": jn})
        tl, tcache = tapi.decode_step(model, tcache, {"tokens": tn})
        steps.append((jl, tl, jcache, snap(tcache)))
    return steps


def test_prefill_and_decode_past_the_window():
    """A 40-token prompt against the window of 32: the cache holds 32
    slots, prefill keeps the last 32 tokens rolled to their slots, and 12
    greedy steps wrap the ring again; logits and caches step by step."""
    japi, jp, tapi, model, _ = _pair()
    assert tapi.cfg.sliding_window == 32
    prompt = _tokens(4, 2, 40)
    steps = _run_both(japi, jp, tapi, model, prompt, gen=12, cap=64)
    for jl, tl, jcache, tcache in steps:
        assert tcache.capacity == jcache.capacity == 32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **TOL)
    assert steps[-1][3].pos == int(steps[-1][2].pos) == 52


def test_decode_matches_prefill():
    """``tests/test_models_smoke.py::test_decode_matches_prefill`` on the
    MoE: with cf 8.0 the prefill drops nothing, so decoding token t after
    prefill[0:t] gives prefill[0:t+1]'s logits."""
    _, _, tapi, model, _ = _pair(moe_capacity_factor=8.0)
    toks = torch.from_numpy(_tokens(6, 1, 18))
    _, cache = tapi.prefill(model, {"tokens": toks[:, :17]}, tapi.init_cache(1, 64, "cpu"))
    dec, _ = tapi.decode_step(model, cache, {"tokens": toks[:, 17]})
    full, _ = tapi.prefill(model, {"tokens": toks}, tapi.init_cache(1, 64, "cpu"))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)


# ---------------------------------------------------------------------------
# make_round_step with heat_expert
# ---------------------------------------------------------------------------


def _step_batch(seed, stacked, vocab=512, seq=32):
    rng = np.random.default_rng(seed)
    lead = (2, 2, 2) if stacked else (4,)
    return {"tokens": rng.integers(0, vocab, lead + (seq,)).astype(np.int32),
            "heat_vocab": rng.integers(0, 8, vocab).astype(np.float32),
            "heat_expert": rng.integers(1, 11, E).astype(np.float32)}


@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "replicated", "sparse_replicated"])
@pytest.mark.parametrize("correct", [True, False])
def test_round_step_with_heat_expert_matches_jax(mode, correct):
    japi, jp, tapi, params, axes = _pair(flat=True)
    fed = dict(num_clients=10, clients_per_round=2, local_iters=2, lr=0.05,
               algorithm="fedsubavg" if correct else "fedavg")
    jstep = jax.jit(j_make_round_step(japi.loss, jp, JFedConfig(**fed), mode=mode,
                                      correct=correct))
    step = make_round_step(tapi.loss, params, axes, FedConfig(**fed), mode=mode,
                           correct=correct)
    for r in range(2):
        b = _step_batch(100 + r, "replicated" in mode)
        jp, jm = jstep(jp, {k: jnp.asarray(x) for k, x in b.items()})
        params, tm = step(params, {k: torch.from_numpy(x) for k, x in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
    got = _stacked(params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)


def test_fedsubavg_corrects_per_expert():
    """FedSubAvg scales the experts' update by N / n_e on their axis 0 and
    the router's on its axis 1; FedAvg leaves both alone. One dense fedsgd
    step from the same weights: the ratio of the two updates is each
    expert's factor."""
    _, _, tapi, params, axes = _pair(flat=True)
    b = _step_batch(7, False)
    heat = np.array([1.0, 2.0, 5.0, 10.0], np.float32)
    b["heat_expert"] = heat
    batch = {k: torch.from_numpy(x) for k, x in b.items()}
    updates = {}
    for alg in ("fedsubavg", "fedavg"):
        fed = FedConfig(num_clients=10, clients_per_round=2, lr=0.05, algorithm=alg)
        step = make_round_step(tapi.loss, params, axes, fed, mode="fedsgd",
                               correct=alg == "fedsubavg")
        new, _ = step({k: v.clone() for k, v in params.items()}, batch)
        updates[alg] = {k: new[k] - params[k] for k in params}
    factor = torch.from_numpy(10.0 / heat)

    def close(name, shape):
        # each side rounds p + update to f32 before the update is read back:
        # half an ulp of |p| each, the FedAvg side's then scaled by N / n_e
        atol = float(factor.max() + 1) * torch.finfo(torch.float32).eps * float(
            params[name].abs().max())
        got, want = updates["fedsubavg"][name], updates["fedavg"][name] * factor.reshape(shape)
        assert float(want.abs().max()) > 100 * atol
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)

    for w in ("wi", "wg", "wo"):
        close(f"layers.0.ffn.{w}", (-1, 1, 1))
    close("layers.1.ffn.router", (1, -1))
    torch.testing.assert_close(updates["fedsubavg"]["layers.0.attn.wq.w"],
                               updates["fedavg"]["layers.0.attn.wq.w"])


def test_launchers_serve_and_train_mixtral_on_the_host():
    """``python -m repro_torch.launch.serve`` and ``.train`` with ``--arch
    mixtral_8x22b --scale tiny --device cpu`` (serving cut to 1 layer by
    ``--layers``): 8 experts of the published config at the tiny widths,
    every logit and loss finite."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    res = serve_mod.main(["--arch", "mixtral_8x22b", "--scale", "tiny", "--device", "cpu",
                          "--layers", "1", "--batch", "2", "--prompt", "16", "--gen", "3"])
    assert res.tokens.shape == (2, 3) and res.cache_pos == 19
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    out = train_mod.main(["--arch", "mixtral_8x22b", "--scale", "tiny", "--device", "cpu",
                          "--rounds", "2", "--clients", "16", "--cohort", "4", "--seq", "32",
                          "--sparse"])
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
    assert out.params["layers.0.ffn.wi"].shape == (8, 128, 256)
    assert len(out.bytes_up_sparse) == 2
