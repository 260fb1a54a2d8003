"""Remat in the port: ``transformer.forward``/``loss_fn(remat=True)`` keep
only each layer's (and, with ``cfg.remat_groups``, each group's) input for
the backward, through ``transformer._Remat``, a ``torch.autograd.Function``
that ``torch.func.grad`` and ``vmap`` reach through. On the host, remat on
equals remat off bit for bit under ``grad`` and ``vmap(grad)``, for the
dense and the MoE model, at one level and at two; the layers run as often
as the reference's ``jax.checkpoint`` makes them run; the loss and every
gradient equal ``jax.grad`` of the JAX package's ``loss_fn(remat=True)``
within 1e-5; the round step gives the same state either way.

Under ``vmap`` the embedding's gradient is summed across threads in an
order that varies from run to run (remat or not), so the comparisons
under ``vmap`` run on one thread."""
import contextlib

import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig, get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.federated.simulation import make_round_step
from repro_torch.launch.serve import image_grid_positions
from repro_torch.models import transformer
from repro_torch.models.api import build_model

QWEN, LLAMA = "qwen2_vl_7b", "llama4_maverick_400b_a17b"
TOL = dict(rtol=1e-5, atol=1e-5)
#: (arch, depth, remat_groups): one level, and two levels of 2 groups
CASES = [(QWEN, 2, 0), (LLAMA, 2, 0), (QWEN, 4, 2), (LLAMA, 4, 2)]
IDS = [f"{a.split('_')[0]}-L{n}-G{g}" for a, n, g in CASES]


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _model(arch, layers, groups):
    cfg = get_smoke_config(arch).replace(dtype="float32", num_layers=layers,
                                         remat_groups=groups)
    params, axes = transformer.train_params(
        transformer.make_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    return cfg, params, axes


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                      .astype(np.int32)),
           "patch_embeds": torch.from_numpy(rng.normal(size=(b, cfg.num_patches, cfg.d_model))
                                            .astype(np.float32)),
           "mask": torch.from_numpy((rng.random((b, s)) < 0.9).astype(np.float32))}
    if cfg.mrope:
        out["mrope_pos"] = image_grid_positions(b, s, 2, 4)
    return out


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch,layers,groups", CASES, ids=IDS)
def test_remat_equals_no_remat_under_grad(arch, layers, groups):
    cfg, params, _ = _model(arch, layers, groups)
    batch = _batch(cfg)
    got = {r: grad_and_value(lambda p, b: transformer.loss_fn(cfg, p, b, remat=r))(params, batch)
           for r in (True, False)}
    assert torch.equal(got[True][1], got[False][1])
    _equal(got[True][0], got[False][0])
    assert all(float(g.abs().max()) > 0 for k, g in got[True][0].items()
               if k.startswith("layers.") and k.endswith(".w"))


@pytest.mark.parametrize("arch,layers,groups", CASES, ids=IDS)
def test_remat_equals_no_remat_under_vmap_grad(arch, layers, groups):
    """Three clients' batches through ``vmap(grad)``, as the replicated
    locals run them: the params shared, the batch mapped."""
    cfg, params, _ = _model(arch, layers, groups)
    clients = [_batch(cfg, seed=s) for s in range(3)]
    stacked = {k: torch.stack([c[k] for c in clients]) for k in clients[0]}
    with one_thread():
        got = {r: vmap(grad(lambda p, b: transformer.loss_fn(cfg, p, b, remat=r)),
                       in_dims=(None, 0))(params, stacked) for r in (True, False)}
        _equal(got[True], got[False])
        # and each client's slice is its own gradient
        one = grad(lambda p, b: transformer.loss_fn(cfg, p, b, remat=True))(params, clients[1])
    for k, g in one.items():
        torch.testing.assert_close(got[True][k][1], g, **TOL)


def _count_layers(monkeypatch):
    calls = []
    inner = transformer.attention_block

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return inner(*args, **kw)

    monkeypatch.setattr(transformer, "attention_block", counted)
    return calls


@pytest.mark.parametrize("groups,want", [(0, 8), (2, 10), (4, 8), (3, 8)])
def test_layers_run_as_the_reference_recomputes_them(monkeypatch, groups, want):
    """Layer runs for one gradient of a 4-layer model. Remat: each layer
    twice (the forward, without grad, and the recompute). Two-level remat
    in 2 groups: the forward, each group's rerun without grad up to its
    last layer (whose output its backward does not need; the reference's
    reruns that one too, 12 in all), and each layer's recompute. Groups of
    one layer (4 of 4), or ``remat_groups`` not dividing the depth (3 of
    4), are one level; remat off runs each layer once. Only the recompute
    runs in grad mode: on the card it alone asks K3 for the log-sum-exp."""
    cfg, params, _ = _model(QWEN, 4, groups)
    batch = _batch(cfg)
    calls = _count_layers(monkeypatch)
    grad(lambda p, b: transformer.loss_fn(cfg, p, b, remat=True))(params, batch)
    assert len(calls) == want
    assert sum(calls) == cfg.num_layers
    calls.clear()
    grad(lambda p, b: transformer.loss_fn(cfg, p, b, remat=False))(params, batch)
    assert calls == [True] * cfg.num_layers


def test_remat_off_without_grad_and_when_collecting_kv(monkeypatch):
    """Remat changes nothing that needs no gradient: under ``no_grad`` and
    in the prefill (``collect_kv``) each layer runs once, outside
    ``_Remat``."""
    cfg, params, _ = _model(LLAMA, 2, 0)
    model = transformer.make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    applied = []
    inner = transformer._Remat.apply
    monkeypatch.setattr(transformer._Remat, "apply",
                        lambda *a: applied.append(1) or inner(*a))
    with torch.no_grad():
        transformer.forward(cfg, params, batch["tokens"], patch_embeds=batch["patch_embeds"])
    out = transformer.forward(cfg, params, batch["tokens"], patch_embeds=batch["patch_embeds"],
                              collect_kv=True)
    assert applied == [] and len(out.kv) == cfg.num_layers
    api = build_model(cfg)
    api.prefill(model, {"tokens": batch["tokens"], "patch_embeds": batch["patch_embeds"]},
                api.init_cache(2, 40, "cpu"))
    assert applied == []


def test_remat_does_not_use_torch_checkpoint(monkeypatch):
    import torch.utils.checkpoint as ckpt

    def refuse(*a, **kw):
        raise AssertionError("torch.utils.checkpoint was called")

    monkeypatch.setattr(ckpt, "checkpoint", refuse)
    cfg, params, _ = _model(QWEN, 4, 2)
    grad(lambda p, b: transformer.loss_fn(cfg, p, b))(params, _batch(cfg))


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


@pytest.mark.parametrize("arch,layers,groups", CASES, ids=IDS)
def test_remat_matches_jax_loss_fn_with_remat(arch, layers, groups):
    """``jax.grad`` of the reference's ``loss_fn(remat=True)`` (its
    ``jax.checkpoint`` per layer, and its two-level path with
    ``remat_groups``) on the same weights and inputs."""
    jcfg = j_get_smoke_config(arch).replace(dtype="float32", num_layers=layers,
                                            remat_groups=groups)
    tcfg = get_smoke_config(arch).replace(dtype="float32", num_layers=layers,
                                          remat_groups=groups)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params, _ = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu", cfg=tcfg,
                                flat=True)
    batch = _batch(tcfg, seed=4)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_transformer.loss_fn(jcfg, p, b, remat=True)))(jp, jb)
    tg, tl = grad_and_value(lambda p, b: transformer.loss_fn(tcfg, p, b, remat=True))(
        params, batch)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = _flatten(jax.tree.map(np.asarray, unbox(jg)))
    got = _stacked(tg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)


@pytest.mark.parametrize("mode", ["fedsgd", "replicated"])
def test_round_step_is_the_same_with_remat(mode):
    """``make_round_step`` on the Llama 4 smoke model with patches and
    ``heat_expert``: the api's ``loss(remat=True)`` (its default) and
    ``remat=False`` give the same state, bit for bit."""
    cfg, params, axes = _model(LLAMA, 2, 0)
    api = build_model(cfg)
    rng = np.random.default_rng(9)
    lead = (2, 2, 2) if mode == "replicated" else (4,)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, lead + (16,))
                                        .astype(np.int32)),
             "patch_embeds": torch.from_numpy(rng.normal(size=lead + (cfg.num_patches,
                                                                      cfg.d_model))
                                              .astype(np.float32)),
             "heat_vocab": torch.from_numpy(rng.integers(1, 8, cfg.vocab_size)
                                            .astype(np.float32)),
             "heat_expert": torch.from_numpy(rng.integers(1, 11, cfg.num_experts)
                                             .astype(np.float32))}
    fed = FedConfig(num_clients=10, clients_per_round=2, local_iters=2, lr=0.05)
    out = {}
    with one_thread():
        for remat in (True, False):
            step = make_round_step(lambda p, b, r=remat: api.loss(p, b, remat=r), params,
                                   axes, fed, mode=mode)
            out[remat] = step({k: v.clone() for k, v in params.items()}, batch)
    assert torch.equal(out[True][1]["loss"], out[False][1]["loss"])
    _equal(out[True][0], out[False][0])


def _grad_peak_bytes(cfg, params, batch, remat: bool) -> int:
    """The most bytes the host allocator held at once beyond what was live
    before, over one ``grad`` of the loss (torch.profiler's memory
    events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        grad(lambda p, b: transformer.loss_fn(cfg, p, b, remat=remat))(params, batch)
    events = sorted((e.time_range.start, e.self_cpu_memory_usage) for e in prof.events()
                    if e.self_cpu_memory_usage)
    live = peak = 0
    for _, delta in events:
        live += delta
        peak = max(peak, live)
    return peak


def test_remat_keeps_only_the_layer_inputs_under_grad():
    """``torch.func.grad`` differentiates with ``create_graph``, which would
    record ``_Remat``'s backward and keep every layer's recompute alive to
    the end; its gradients are detached, so the peak grows with the depth
    by each layer's parameter gradients only (equal to its weights), while
    without remat it grows by each layer's activations and their recorded
    backward (more than 8x the weights here)."""
    peaks = {}
    for layers in (1, 3):
        cfg, params, _ = _model(QWEN, layers, 0)
        cfg = cfg.replace(d_ff=1024)
        params, _ = transformer.train_params(
            transformer.make_params(cfg, torch.Generator().manual_seed(0), "cpu"))
        batch = _batch(cfg, b=2, s=128)
        for remat in (True, False):
            peaks[(layers, remat)] = _grad_peak_bytes(cfg, params, batch, remat)
    per_layer = {r: (peaks[(3, r)] - peaks[(1, r)]) / 2 for r in (True, False)}
    weights = sum(t.numel() * 4 for k, t in params.items() if k.startswith("layers.0."))
    assert per_layer[True] <= 1.5 * weights and per_layer[False] > 8 * weights, (
        per_layer, weights)
