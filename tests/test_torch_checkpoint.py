"""Port parity, checkpoints: ``repro_torch.checkpoint`` writes the JAX
package's npz layout. The port's own round trip (bf16 stored as f32 and
cast back, ``ServerState`` with optimizer slots, RowSparse leaves); both
directions between the packages for LR and the LSTM (a JAX checkpoint
loads into the port and equals ``params_from_jax``; the port's loads into
the JAX package's ``load_checkpoint``); and a trainer resumed from a
checkpoint of its ``ServerState`` equal to an uninterrupted one."""
import functools
import json

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.models.recsys import make_lr_params as j_make_lr_params
from repro.models.recsys import make_lstm_params as j_make_lstm_params
from repro.sharding.logical import unbox

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import FedConfig
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.core.algorithms import ServerState
from repro_torch.data.synthetic import make_movielens_like
from repro_torch.federated.server import FederatedTrainer
from repro_torch.models.recsys import lr_loss, make_lr_params, make_lstm_params
from repro_torch.sparse.rowsparse import RowSparse


def _jax_params(model):
    if model == "lstm":
        return j_make_lstm_params(50, emb_dim=5, hidden=6, layers=2,
                                  rng=jax.random.PRNGKey(2))
    tree = j_make_lr_params(30)
    rng = np.random.default_rng(4)
    return jax.tree.map(lambda p: p + rng.normal(size=p.shape).astype(np.float32), tree)


def test_port_round_trip_with_bf16_state_and_rowsparse(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"embedding": torch.randn(7, 3, generator=g).to(torch.bfloat16),
              "head_w": torch.randn(3, 1, generator=g)}
    state = ServerState(params, ({k: torch.randn(p.shape, generator=g) for k, p in
                                  params.items()}, {k: torch.zeros(p.shape) for k, p in
                                                    params.items()}), 5)
    tree = {"state": state, "delta": RowSparse(torch.tensor([[0, 4, -1]], dtype=torch.int32),
                                               torch.randn(1, 3, 3, generator=g), 7),
            "none": None, "count": 3}
    path = str(tmp_path / "sub" / "ckpt")
    save_checkpoint(path, tree, step=11, extra={"arch": "lstm"},
                    axes={"embedding": ("vocab", "embed"), "head_w": (None, None)})
    meta = json.load(open(path + ".meta.json"))
    assert meta["step"] == 11 and meta["extra"] == {"arch": "lstm"}
    assert meta["axes"]["state/.params/embedding"] == ["vocab", "embed"]
    assert meta["axes"]["delta/1"] is None
    with np.load(path + ".npz") as z:
        assert z["state/.params/embedding"].dtype == np.float32
        assert sorted(z.files) == sorted(
            ["count", "delta/0", "delta/1", "state/.params/embedding",
             "state/.params/head_w", "state/.opt/0/embedding", "state/.opt/0/head_w",
             "state/.opt/1/embedding", "state/.opt/1/head_w", "state/.rounds"])
    template = {"state": ServerState({k: torch.zeros_like(p) for k, p in params.items()},
                                     tuple({k: torch.zeros(p.shape) for k, p in
                                            params.items()} for _ in range(2)), 0),
                "delta": RowSparse(torch.zeros(1, 3, dtype=torch.int32), torch.zeros(1, 3, 3),
                                   7), "none": None, "count": 0}
    back = load_checkpoint(path, template)
    assert back["state"].rounds == 5 and back["count"] == 3 and back["none"] is None
    for k, p in params.items():
        assert back["state"].params[k].dtype == p.dtype
        assert torch.equal(back["state"].params[k], p)
        for i in range(2):
            assert torch.equal(back["state"].opt[i][k], state.opt[i][k])
    assert torch.equal(back["delta"].ids, tree["delta"].ids)
    assert torch.equal(back["delta"].rows, tree["delta"].rows)
    assert back["delta"].num_rows == 7
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {**template, "count": 0, "delta": RowSparse(
            torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 2, 3), 7)})


@pytest.mark.parametrize("model", ["lr", "lstm"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, model):
    jp = _jax_params(model)
    path = str(tmp_path / "jax")
    j_save(path, jp, step=3)
    want, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    make = (functools.partial(make_lstm_params, 50, emb_dim=5, hidden=6, layers=2)
            if model == "lstm" else functools.partial(make_lr_params, 30))
    template, t_axes = make(device="cpu")
    assert t_axes == axes
    got = load_checkpoint(path, template)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    meta = json.load(open(path + ".meta.json"))
    for name, ax in axes.items():
        assert meta["axes"][name.replace(".", "/")] == list(ax)


@pytest.mark.parametrize("model", ["lr", "lstm"])
def test_port_checkpoint_loads_into_jax(tmp_path, model):
    jp = _jax_params(model)
    params, axes = params_from_jax(jax.tree.map(np.asarray, unbox(jp)), device="cpu")
    params = {k: v * 2 + 1 for k, v in params.items()}
    path = str(tmp_path / "port")
    save_checkpoint(path, params, step=4, axes=axes)
    back = j_load(path, jp)
    flat = _flatten(jax.tree.map(np.asarray, unbox(back)))
    assert set(flat) == set(params)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, params[k].numpy(), err_msg=k)
    meta = json.load(open(path + ".meta.json"))
    j_save(str(tmp_path / "jax"), jp, step=4)
    assert meta == json.load(open(str(tmp_path / "jax") + ".meta.json"))


@pytest.mark.parametrize("alg", ["fedsubavg", "fedadam"])
def test_trainer_state_checkpoint_resume(tmp_path, alg):
    ds = make_movielens_like(num_clients=40, num_items=40, mean_samples=15)

    def make():
        cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=6, local_iters=3,
                        local_batch=4, lr=0.5, algorithm=alg, sparse=True)
        return FederatedTrainer(ds, functools.partial(make_lr_params, ds.num_features),
                                lr_loss, cfg, device="cpu")

    path = str(tmp_path / f"state_{alg}")
    tr1 = make()
    for _ in range(3):
        tr1.run_round()
    save_checkpoint(path, tr1.state, step=tr1._rounds_run)
    reference = [tr1.run_round() for _ in range(3)]
    tr2 = make()
    for _ in range(3):
        tr2.run_round()                      # replay the numpy stream
    template = ServerState({k: torch.zeros_like(v) for k, v in tr2.state.params.items()},
                           tuple({k: torch.zeros_like(v) for k, v in d.items()}
                                 for d in tr2.state.opt) if isinstance(tr2.state.opt, tuple)
                           else tr2.state.opt, 0)
    tr2.state = load_checkpoint(path, template)
    assert tr2.state.rounds == 3
    assert [tr2.run_round() for _ in range(3)] == reference
    for k in tr1.state.params:
        assert torch.equal(tr1.state.params[k], tr2.state.params[k])
