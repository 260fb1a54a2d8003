"""Comparison helpers of the Zamba2 and xLSTM parity tests
(``test_torch_ssm.py``, ``test_torch_xlstm.py``): the f32 and bf16 bounds,
numpy inputs in both packages' dtypes, the port's flat dict in the
reference's stacked layout, and ``make_round_step`` against the JAX
package's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import FedConfig as JFedConfig
from repro.federated import make_round_step as j_make_round_step
from repro.sharding.logical import unbox

from repro_torch.configs.base import FedConfig
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.federated.simulation import make_round_step
from repro_torch.models import transformer

F32_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got: torch.Tensor, want, dtype: str, name: str = "", scaled: bool = False) -> None:
    """f32 within 1e-5 (``scaled``: of the tensor's scale, its largest
    magnitude when above 1). bf16: each element within 2e-2 of the output's
    scale, and the whole within 1e-2 in relative norm. XLA on the CPU skips
    bf16 roundings between fused ops (excess precision: JAX's own eager and
    jitted blocks differ by an ulp), eager PyTorch rounds after each; an ulp
    of the larger terms lands on small outputs after a cancellation, so the
    element bound is the output's scale's. ``scaled`` f32 serves the hidden
    states and caches after several layers: exp of a cumulative log decay
    (|cum| ~ 190 over a 32-step chunk at the smoke model's init, an f32 ulp
    of 1.5e-5 there) carries the two packages' summation orders into them."""
    got, want = got.detach().float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=name, rtol=1e-5,
                                   atol=1e-5 * (scale if scaled else 1.0))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale, err_msg=name)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-2, (name, rel)


def both(arr: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(np.asarray(arr, np.float32)).to(td)


def stacked_numpy(flat) -> dict:
    got, _ = transformer.stack_layers({k: v.detach() for k, v in flat.items()})
    return {k: v.float().numpy() for k, v in got.items()}


def round_steps_match(japi, jp, tapi, tcfg, mode: str, steps: int = 2,
                      algorithm: str = "fedsubavg", extra=None) -> dict:
    """``steps`` rounds of ``make_round_step`` under ``algorithm`` (FedSubAvg,
    or FedAvg: no heat correction) in both packages, each from the JAX
    package's parameters, with ``extra(rng)``'s numpy leaves added to each
    round's batch: losses, metrics and parameters within 1e-5. Returns the
    last round's port parameters in the reference's stacked layout. Each
    round starts from the same parameters because these models' gradients
    move ~25x a last-ulp parameter difference after a
    heat-corrected first update (xLSTM's embedding moves by 0.54): at the
    two packages' parameters after one round, JAX's own embedding gradient
    differs by 7.6e-5 of its scale, while the port's and JAX's at the same
    parameters agree to 4.9e-6."""
    fed = dict(num_clients=10, clients_per_round=2, local_iters=2, lr=0.05,
               algorithm=algorithm)
    correct = algorithm == "fedsubavg"
    jstep = jax.jit(j_make_round_step(japi.loss, jp, JFedConfig(**fed), mode=mode,
                                      correct=correct))
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu",
                                   cfg=tcfg, flat=True)
    step = make_round_step(tapi.loss, params, axes, FedConfig(**fed), mode=mode,
                           correct=correct)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        params, _ = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu",
                                    cfg=tcfg, flat=True)
        b = {"tokens": rng.integers(0, 512, (4, 32)).astype(np.int32),
             "heat_vocab": rng.integers(0, 8, 512).astype(np.float32)}
        if extra is not None:
            b.update(extra(rng))
        jp, jm = jstep(jp, {k: jnp.asarray(x) for k, x in b.items()})
        params, tm = step(params, {k: torch.from_numpy(x) for k, x in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32_TOL)
        assert set(tm) == set(jm)
        for name in ("sub_rows", "density"):
            if name in jm:
                assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-6)
        want = _flatten(jax.tree.map(np.asarray, unbox(jp)))
        got = stacked_numpy(params)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, err_msg=name, **F32_TOL)
    return got
