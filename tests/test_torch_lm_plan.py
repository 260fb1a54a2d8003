"""Port parity, federated LLM training: ``make_round_step`` on Qwen2.5-14B's
smoke transformer (f32) against the JAX package's step in the four modes,
FedSubAvg and FedAvg (the analogues of ``tests/test_federated.py``'s LM
steps); the sparse ``FedSgdLocal`` step's next-token targets pinned to
vocabulary ids before the remap; the training launcher at
``examples/federated_llm.py``'s ``--smoke`` size against that example's
loop; and LLM checkpoints read across the two packages. The same numpy
inputs and the weights of ``PRNGKey(0)`` go to both; steps agree within
1e-5."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import FedConfig as JFedConfig
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import make_lm_federated as j_make_lm_federated
from repro.federated import make_round_step as j_make_round_step
from repro.federated import plan as jplan
from repro.models import build_model as j_build_model
from repro.sharding.logical import unbox

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import FedConfig, get_config, get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.core.algorithms import ServerState
from repro_torch.federated import ArrivalSim, BufferedAsyncServerUpdate, build_async_engine
from repro_torch.federated.plan import (RoundPlan, RowSparseTransport, ServerUpdate,
                                        SubmodelReplicatedLocal, build_round_step)
from repro_torch.federated.server import derive_sub_ids
from repro_torch.federated.simulation import make_round_step
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.union_segsum import union_segsum
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer
from repro_torch.models.api import build_model

ARCH = "qwen2_5_14b"
TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 2


def _pair(cfg_j, cfg_t):
    japi, tapi = j_build_model(cfg_j), build_model(cfg_t)
    jp = japi.init(jax.random.PRNGKey(0))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu",
                                   cfg=cfg_t, flat=True)
    return japi, jp, tapi, params, axes


def _smoke():
    return _pair(j_get_smoke_config(ARCH).replace(dtype="float32"),
                 get_smoke_config(ARCH).replace(dtype="float32"))


def _assert_params_close(got, want_jax, **tol):
    want = _flatten(jax.tree.map(np.asarray, unbox(want_jax)))
    stacked = {}
    for name, t in got.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault(f"layers.{rest}", {})[int(i)] = t.numpy()
        else:
            stacked[name] = t.numpy()
    for name, w in want.items():
        g = stacked[name]
        if isinstance(g, dict):
            g = np.stack([g[i] for i in range(len(g))])
        np.testing.assert_allclose(g, w, err_msg=name, **(tol or TOL))


def _batch(seed, stacked, vocab=512, seq=32):
    rng = np.random.default_rng(seed)
    lead = (2, 2, 2) if stacked else (4,)
    return {"tokens": rng.integers(0, vocab, lead + (seq,)).astype(np.int32),
            "heat_vocab": rng.integers(0, 8, vocab).astype(np.float32)}


def _run_both(mode, correct, steps=STEPS):
    japi, jp, tapi, params, axes = _smoke()
    fed = dict(num_clients=10, clients_per_round=2, local_iters=2, lr=0.05,
               algorithm="fedsubavg" if correct else "fedavg")
    jstep = jax.jit(j_make_round_step(japi.loss, jp, JFedConfig(**fed), mode=mode,
                                      correct=correct))
    step = make_round_step(tapi.loss, params, axes, FedConfig(**fed), mode=mode,
                           correct=correct)
    jl, tl = [], []
    for r in range(steps):
        b = _batch(100 + r, "replicated" in mode)
        jp, jm = jstep(jp, {k: jnp.asarray(x) for k, x in b.items()})
        params, tm = step(params, {k: torch.from_numpy(x) for k, x in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jl, tl, jm, tm, jp, params


@pytest.mark.parametrize("mode", ["fedsgd", "sparse", "replicated", "sparse_replicated"])
@pytest.mark.parametrize("correct", [True, False])
def test_lm_round_step_matches_jax(mode, correct):
    jl, tl, jm, tm, jp, params = _run_both(mode, correct)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert set(tm) == set(jm)
    for name in ("sub_rows", "density"):
        if name in jm:
            assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-6)
    _assert_params_close(params, jp)


def test_sparse_fedsgd_pins_next_token_labels():
    """The sparse ``FedSgdLocal`` step remaps the tokens to row slots of the
    gathered embedding; the targets must stay vocabulary ids for the dense
    ``lm_head``. So its loss equals the JAX package's and the dense step's
    (one gradient of one pooled batch), and its parameters the dense
    step's (the correction touches the same rows)."""
    jl, tl, _, _, jp, params = _run_both("sparse", True, steps=1)
    np.testing.assert_allclose(tl, jl, **TOL)
    _, dtl, _, _, _, dense = _run_both("fedsgd", True, steps=1)
    np.testing.assert_allclose(tl, dtl, **TOL)
    for name, p in dense.items():
        np.testing.assert_allclose(params[name].numpy(), p.numpy(), err_msg=name, **TOL)


def test_async_engine_pins_next_token_labels():
    """The buffered-async engine's submodel client deltas pin the targets
    too: one zero-delay wave with a full buffer is the synchronous submodel
    round (held to the JAX package above), parameter for parameter."""
    _, _, tapi, params, axes = _smoke()
    k, cap = 2, 64
    cfg = FedConfig(num_clients=10, clients_per_round=k, local_iters=2, lr=0.05,
                    algorithm="fedsubavg")
    b = _batch(7, stacked=True)
    tasks = {"tokens": torch.from_numpy(b["tokens"])}
    counts = {"vocab": torch.from_numpy(b["heat_vocab"])}
    sub_ids = derive_sub_ids(tasks["tokens"].reshape(k, -1), 512, cap)
    sync = build_round_step(RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                                      ServerUpdate("fedsubavg")),
                            tapi.loss, axes, params, cfg, heat_counts=counts, total=10.0)
    fresh = lambda: ServerState({n: v.clone() for n, v in params.items()}, (), 0)  # noqa: E731
    want, _ = sync(fresh(), tasks, sub_ids)
    eng = build_async_engine(RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                                       BufferedAsyncServerUpdate(buffer_size=k)),
                             tapi.loss, axes, params, cfg, heat_counts=counts, total=10.0)
    sch = ArrivalSim(num_rounds=1).compile(k, k)
    got, ys = eng.run(eng.init(fresh(), num_slots=sch.num_slots, capacity=cap),
                      sch.event_arrays(), tasks, sub_ids)
    assert int(ys["fired"].sum()) == 1
    for name, w in want.params.items():
        np.testing.assert_allclose(got.server.params[name].numpy(), w.numpy(),
                                   err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _jax_example_loop(cfg_j, jp, ds, sparse, alg, rounds):
    """``examples/federated_llm.py``'s loop, as it runs."""
    api = j_build_model(cfg_j)
    fed = JFedConfig(num_clients=ds.num_clients, clients_per_round=8, lr=0.05,
                     algorithm=alg)
    transport = jplan.RowSparseTransport() if sparse else jplan.DenseTransport()
    plan = jplan.RoundPlan(jplan.FedSgdLocal(), transport, jplan.ServerUpdate(alg))
    step = jax.jit(j_make_round_step(api.loss, jp, fed, mode=plan))
    heat = jnp.asarray(ds.heat.counts, jnp.float32)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(rounds):
        ids = rng.choice(ds.num_clients, size=fed.clients_per_round, replace=False)
        sample = rng.integers(0, ds.client_data["tokens"].shape[1],
                              size=fed.clients_per_round)
        toks = ds.client_data["tokens"][ids, sample]
        jp, metrics = step(jp, {"tokens": jnp.asarray(toks), "heat_vocab": heat})
        losses.append(float(metrics["loss"]))
    return losses, jp


@pytest.mark.parametrize("sparse,alg", [(False, "fedsubavg"), (True, "fedsubavg"),
                                        (False, "fedavg")])
def test_launcher_smoke_matches_the_example(sparse, alg):
    cfg_j = j_get_config(ARCH).replace(**train_mod.SMOKE)
    cfg_t = get_config(ARCH).replace(**train_mod.SMOKE)
    _, jp, _, params, axes = _pair(cfg_j, cfg_t)
    kw = dict(num_clients=32, vocab=cfg_t.vocab_size, seq_len=32, samples_per_client=4,
              zipf_a=1.3)
    ds = j_make_lm_federated(**kw)
    want, jp = _jax_example_loop(cfg_j, jp, ds, sparse, alg, rounds=2)
    counters = (flash_attention, flash_attention_bwd, union_segsum)
    before = [w.launches for w in counters]
    res = train_mod.train(cfg_t, rounds=2, clients=32, cohort=8, seq=32, lr=0.05,
                          algorithm=alg, sparse=sparse, zipf_a=1.3, device="cpu",
                          params=params, axes=axes, log_every=0)
    np.testing.assert_allclose(res.losses, want, **TOL)
    _assert_params_close(res.params, jp)
    assert [w.launches for w in counters] == before, "a host run launched a kernel"
    assert len(res.bytes_up_sparse) == (2 if sparse else 0)


def test_launcher_cli_smoke_run_and_checkpoint(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --rounds 2 --device cpu``;
    its checkpoint loads into the JAX package's smoke-sized tree."""
    path = str(tmp_path / "ckpt")
    res = train_mod.main(["--smoke", "--rounds", "2", "--device", "cpu", "--sparse",
                          "--ckpt", path])
    out = capsys.readouterr().out
    assert "FedSgdLocal -> RowSparseTransport -> ServerUpdate(fedsubavg)" in out
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    cfg_j = j_get_config(ARCH).replace(**train_mod.SMOKE)
    back = j_load(path, j_build_model(cfg_j).init(jax.random.PRNGKey(1)))
    _assert_params_close(res.params, back, rtol=0, atol=0)
    assert json.load(open(path + ".meta.json"))["step"] == 2


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def test_port_lm_checkpoint_loads_into_jax(tmp_path):
    japi, jp, _, params, axes = _smoke()
    params = {k: v * 2 + 1 for k, v in params.items()}
    path = str(tmp_path / "port")
    stacked, stacked_axes = transformer.stack_layers(params, axes)
    save_checkpoint(path, stacked, step=4, axes=stacked_axes)
    back = j_load(path, jp)
    _assert_params_close(params, back, rtol=0, atol=0)
    j_save(str(tmp_path / "jax"), jp, step=4)
    assert (json.load(open(path + ".meta.json"))
            == json.load(open(str(tmp_path / "jax") + ".meta.json")))


def test_jax_lm_checkpoint_loads_into_the_port(tmp_path):
    _, jp, tapi, want, _ = _smoke()
    path = str(tmp_path / "jax")
    j_save(path, jp, step=3)
    template, _ = transformer.train_params(tapi.init(device="cpu"))
    got = transformer.unstack_layers(
        load_checkpoint(path, transformer.stack_layers(template)[0]))
    assert list(got) == list(template)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    short = {k: v for k, v in template.items() if not k.startswith("layers.1.")}
    with pytest.raises(ValueError, match=r"has shape \(2, "):
        load_checkpoint(path, transformer.stack_layers(short)[0])
