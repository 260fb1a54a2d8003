"""Port parity, models: DIN and LSTM of ``repro_torch.models.recsys`` against
the JAX package's on its own random initialisation (converted with
``params_from_jax``): logits, losses and the gradient of every leaf within
1e-5, with padded samples, padded ids and all-pad rows in every batch; and
the converter's handling of the LSTM's tuple of cells."""
import numpy as np
import pytest
import torch
from torch.func import grad

import jax
import jax.numpy as jnp

from repro.models import recsys as jr
from repro.sharding.logical import is_param, unbox

from repro_torch.convert import _flatten, _is_lm, params_from_jax
from repro_torch.models import recsys as tr

TOL = dict(rtol=1e-5, atol=1e-5)
V = 53


def _din_batch(rng, b=12, h=7, v=V):
    hist = rng.integers(0, v, (b, h)).astype(np.int32)
    lens = rng.integers(0, h + 1, b)
    lens[0], lens[1] = 0, h                       # one all-pad row, one full row
    hist[np.arange(h)[None, :] >= lens[:, None]] = -1
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0                               # padded samples
    return {"hist": hist, "target": rng.integers(0, v, b).astype(np.int32),
            "label": rng.integers(0, 2, b).astype(np.int32), "sample_mask": mask}


def _lstm_batch(rng, b=10, s=9, v=V):
    tokens = rng.integers(0, v, (b, s)).astype(np.int32)
    lens = rng.integers(1, s + 1, b)
    lens[0], lens[1] = 0, s                       # one all-pad row, one full row
    tokens[np.arange(s)[None, :] >= lens[:, None]] = -1
    mask = np.ones(b, np.float32)
    mask[-1] = 0.0
    return {"tokens": tokens, "label": rng.integers(0, 2, b).astype(np.int32),
            "sample_mask": mask}


MODELS = {
    "din": (lambda key: jr.make_din_params(V, rng=key), _din_batch,
            lambda p, b: jr.din_logits(p, b["hist"], b["target"]), jr.din_loss,
            lambda p, b: tr.din_logits(p, b["hist"], b["target"]), tr.din_loss),
    "lstm": (lambda key: jr.make_lstm_params(V, emb_dim=8, hidden=12, rng=key),
             _lstm_batch,
             lambda p, b: jr.lstm_logits(p, b["tokens"],
                                         (b["tokens"] >= 0).astype(jnp.float32)),
             jr.lstm_loss,
             lambda p, b: tr.lstm_logits(p, b["tokens"],
                                         (b["tokens"] >= 0).to(torch.float32)),
             tr.lstm_loss),
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_loss_and_grads_match_reference(model, seed):
    j_make, make_batch, j_logits, j_loss, t_logits, t_loss = MODELS[model]
    j_params = unbox(j_make(jax.random.PRNGKey(seed)))
    params, _ = params_from_jax(jax.tree.map(np.asarray, j_params), device="cpu")
    batch = make_batch(np.random.default_rng(seed))
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    np.testing.assert_allclose(t_logits(params, t_batch).numpy(),
                               np.asarray(j_logits(j_params, j_batch)), **TOL)
    np.testing.assert_allclose(float(t_loss(params, t_batch)),
                               float(j_loss(j_params, j_batch)), **TOL)
    want = _flatten(jax.tree.map(np.asarray, jax.grad(j_loss)(j_params, j_batch)))
    got = grad(t_loss)(params, t_batch)
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, err_msg=name, **TOL)
    # the embedding's gradient reaches only rows the batch names
    table = "item_emb" if model == "din" else "embedding"
    ids = np.concatenate([batch[k].reshape(-1) for k in ("hist", "target", "tokens")
                          if k in batch])
    untouched = np.setdiff1d(np.arange(V), ids)
    assert not got[table][untouched].any()


def test_lstm_cells_tuple_round_trip():
    j_params = jax.tree.map(np.asarray, unbox(
        jr.make_lstm_params(V, emb_dim=8, hidden=12, layers=3,
                            rng=jax.random.PRNGKey(4))))
    assert isinstance(j_params["cells"], tuple)
    params, axes = params_from_jax(j_params, device="cpu")
    assert set(params) == set(axes) == set(tr.lstm_axes(3))
    assert axes == tr.lstm_axes(3)
    for i, cell in enumerate(j_params["cells"]):
        for leaf, value in cell.items():
            np.testing.assert_array_equal(params[f"cells.{i}.{leaf}"].numpy(), value)
    np.testing.assert_array_equal(params["embedding"].numpy(), j_params["embedding"])
    assert not _is_lm(_flatten(j_params))


def _ref_layout(tree):
    """Name -> (shape, logical axes) of a reference tree of Param boxes."""
    out = {}
    for path, p in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_param)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = (tuple(p.value.shape), p.axes)
    return out


@pytest.mark.parametrize("model", ["din", "lstm"])
def test_port_init_matches_reference_layout_and_scales(model):
    """The port's own initialisation: the reference's shapes, axes, zero
    biases and draw scales (0.02 for the embedding, 1/sqrt(fan-in) else),
    the same draws again for the same seed."""
    j_make, t_make = ((jr.make_din_params, tr.make_din_params) if model == "din"
                      else (jr.make_lstm_params, tr.make_lstm_params))
    params, axes = t_make(400, device="cpu")
    assert {k: (tuple(v.shape), axes[k]) for k, v in params.items()} == _ref_layout(
        j_make(400, abstract=True))
    assert axes == (tr.DIN_AXES if model == "din" else tr.LSTM_AXES)
    for name, p in params.items():
        if axes[name][0] == "vocab":
            assert abs(float(p.std()) - 0.02) < 2e-3, name
        elif p.dim() == 1:
            assert not p.any(), name
        else:
            assert abs(float(p.std()) * p.shape[-2] ** 0.5 - 1.0) < 0.15, name
    again, _ = t_make(400, device="cpu")
    for name in params:
        assert torch.equal(params[name], again[name]), name


def test_paper_models_registry():
    assert set(tr.PAPER_MODELS) == set(jr.PAPER_MODELS)
    assert tr.PAPER_MODELS["din_ctr"] == (tr.make_din_params, tr.din_loss)
    assert tr.PAPER_MODELS["sent140_lstm"] == (tr.make_lstm_params, tr.lstm_loss)
