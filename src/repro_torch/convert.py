"""Parameter conversion from the JAX package's layout.

The JAX package keeps parameters as nested trees of boxed arrays. Given the
unboxed values as numpy arrays, ``params_from_jax`` returns them in the
port's form on ``device``:

- the LR, DIN and LSTM trees: the port's flat parameter dict (nested keys
  joined with ".", the LSTM's tuple of cells as ``cells.{i}``) and its
  logical axes;
- the transformer's tree, dense or MoE (``repro.models.transformer.make_params``,
  layers stacked on a leading L axis, the MoE's router ``(L, d, E)`` and
  experts ``(L, E, ., .)`` among them): the port's ``Transformer`` module,
  one entry of its ``layers`` per slice of L, and its logical axes; with
  ``flat=True`` the flat training dict of ``transformer.train_params``
  (``layers.{i}.attn.wq.w`` and so on) instead of the module;
- Zamba2's tree (``repro.models.zamba.make_params``: ``mamba.*`` stacked on
  L, ``shared_attn.*`` once): a ``layers.ModelTree`` (``mamba.{i}.*``), and
  xLSTM's (``repro.models.xlstm_model.make_params``: a ``runs`` tuple of
  ``{"m": ...}`` or ``{"s": ...}``, each stacked on its run's length): an
  ``layers.ModelTree`` (``runs.{r}.{m|s}.{i}.*``); Whisper's
  (``repro.models.whisper.make_params``: ``encoder`` and ``decoder``
  stacked on their depths; ``encoder_norm``, ``final_norm``, ``embedding``
  and ``lm_head`` once): a ``layers.ModelTree`` (``encoder.{i}.*``,
  ``decoder.{i}.*``); ``flat=True`` as above.

``server_state_from_jax`` carries a recsys trainer's whole ``ServerState``
across: parameters, the server optimizer's slots and the round count.

The JAX package is not imported: the caller hands over plain numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.algorithms import ServerState
from repro_torch.models.api import build_model
from repro_torch.models.recsys import DIN_AXES, LR_AXES, lstm_axes
from repro_torch.models.transformer import train_params, unstack_layers


def _model_axes(names) -> Optional[Dict[str, Tuple]]:
    """The logical axes of the recsys model with these parameter names."""
    layers = sum(name.startswith("cells.") and name.endswith(".wx") for name in names)
    for axes in (LR_AXES, DIN_AXES, lstm_axes(layers)):
        if set(axes) == set(names):
            return dict(axes)
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested Mappings and tuples (the LSTM's cells) to dotted names."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, Sequence):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _is_lm(flat: Mapping[str, np.ndarray]) -> bool:
    """An LLM's tree, of any family: only they have an ``lm_head``."""
    return "embedding" in flat and "lm_head" in flat


def _writable_copy(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A writable copy of each array (torch reads no read-only array without
    a warning); bf16 (numpy's ``ml_dtypes`` type, which torch does not read)
    widened to f32 exactly, which ``make_params`` narrows back to the
    model's dtype."""
    return {name: arr.astype(np.float32) if arr.dtype.name == "bfloat16" else np.array(arr)
            for name, arr in flat.items()}


def params_from_jax(np_tree: Mapping, device=None, cfg: Optional[ModelConfig] = None,
                    flat: bool = False) -> Tuple[object, Dict[str, Tuple]]:
    """``(params, axes)`` for a JAX parameter tree given as numpy arrays.
    An LLM's tree needs its ``cfg``; ``params`` is then the model, or with
    ``flat=True`` its flat training dict."""
    leaves = _flatten(np_tree)
    if _is_lm(leaves):
        if cfg is None:
            raise ValueError("params_from_jax: an LLM's tree needs its "
                             "ModelConfig (cfg=...)")
        state = unstack_layers(_writable_copy(leaves))
        model = build_model(cfg).init(device=device, state=state)
        if set(state) != set(model.axes):
            raise ValueError(f"params_from_jax: the tree does not fit {cfg.name}: "
                             f"{sorted(set(state) ^ set(model.axes))}")
        return train_params(model) if flat else (model, dict(model.axes))
    axes = _model_axes(leaves)
    if axes is None:
        raise ValueError(f"no ported model has parameters {sorted(leaves)}")
    dev = resolve_device(device)
    # a copy: the trainer updates its tables in place
    params = {k: torch.tensor(v, device=dev) for k, v in leaves.items()}
    return params, axes


def server_state_from_jax(params_np: Mapping, opt_np, rounds,
                          device=None) -> ServerState:
    """The port's ``ServerState`` for a JAX recsys ``ServerState`` given as
    numpy: ``opt_np`` is ``()`` (fedavg, fedprox, fedsubavg, central), a
    tree like the parameters (scaffold's control delta) or a pair of them
    (fedadam's ``(m, v)``); each slot tree becomes a flat dict keyed like
    the parameters."""
    params, _ = params_from_jax(params_np, device)
    if not isinstance(params, dict):
        raise ValueError("server_state_from_jax carries the recsys models' state")
    dev = resolve_device(device)

    def slots(tree) -> Dict[str, torch.Tensor]:
        flat = _flatten(tree)
        if set(flat) != set(params):
            raise ValueError(f"optimizer slots {sorted(flat)} do not match the "
                             f"parameters {sorted(params)}")
        return {k: torch.tensor(v, device=dev) for k, v in flat.items()}

    if isinstance(opt_np, Mapping):
        opt = slots(opt_np)
    elif len(opt_np) == 0:
        opt = ()
    else:
        opt = tuple(slots(t) for t in opt_np)
    return ServerState(params, opt, int(np.asarray(rounds)))
