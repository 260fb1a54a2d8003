"""Decoder-only transformer, dense and MoE families: port of
``repro/models/transformer.py``.

Serves and trains Qwen2.5-14B, Qwen3-32B, DeepSeek-67B, Mistral Large 123B,
Mixtral 8x22B, Llama 4 Maverick and Qwen2-VL 7B: GQA with optional qk_norm,
QKV bias and sliding window, gated MLP or dropping MoE (``layers.moe``),
RoPE or M-RoPE (``layers.apply_mrope`` on the batch's ``mrope_pos``), and
early-fusion patch embeddings (``embed_tokens``). The parameters are a
``Transformer`` module whose layers sit in an ``nn.ModuleList``; every level
is a ``layers.ParamTree`` under the reference's keys, so the functions below
read ``lp["attn"]["wq"]["w"]`` as the reference does. The reference's
``lax.scan`` and ``fori_loop`` over stacked layers become a Python loop.

Split over a mesh: with rules installed (``repro_torch.sharding.set_rules``
on a ``launch.mesh.DeviceMesh``), ``forward`` and ``loss_fn`` read the
rank's part of the flat dict (``launch.shardings.shard_params``) and split
the layers over the ``model`` ranks as the rules split the weights
(``model_split``): each rank attends with its whole query heads through K3
(and K3's backward), the MLP and the experts are column- then
row-parallel, the embedding and ``lm_head`` are vocabulary-parallel. The
reference's ``constrain`` sites stay, each checking the rank's local shape.
The batch's split over ``data`` is the round step's (``CohortSharding``).
Serving (``prefill``, ``decode_step``) splits the same way under
``make_rules("decode")``, with the KV cache split by sequence over ``model``
and K4's partials merged across the ranks by their log-sum-exp.

FSDP (the rules' ``embed`` over ``data``: ``rules.fsdp_rules``): a rank
also holds only its slice of every weight's ``d_model``, and gathers a
layer's weights whole inside the layer (``gather_for_data``; the final
norm and ``lm_head`` where they are used, and of the embedding the rows
the batch looks up, ``lookup_for_data``). Inside ``_Remat`` the
recompute gathers again, so at most one remat group's weights are whole at
a time; the gradient of each gathered weight is reduce-scattered back to
the rank's slice. The dense, MoE and VLM families run under it; Zamba2,
xLSTM and Whisper refuse it (``model_split``).

Serving: ``prefill`` and ``decode_step`` run under ``torch.no_grad`` and
write the KV cache in place; decode's MoE is drop-free (capacity ``B * k``).
Training: ``loss_fn`` (the causal LM loss through ``chunked_xent``, plus
``router_aux_weight`` times the MoE layers' mean aux loss) differentiates
``forward`` with K3's gradient kernel on the card. ``forward`` reads the
parameters in either form: the ``Transformer`` module serving takes, or the
flat ``{state_dict name: tensor}`` dict that ``train_params`` gives the
round step with its logical axes.

Remat: the reference's ``jax.checkpoint`` per layer (and per group of
layers with ``cfg.remat_groups``) is ``_Remat``, a ``torch.autograd.Function``
that keeps only its inputs (the hidden state and the layer's parameter
tensors) and whose backward runs the layer again under ``torch.func.vjp``.
``torch.utils.checkpoint`` cannot serve here: the round plans differentiate
through ``torch.func.grad`` and ``vmap``, which refuse saved-tensor hooks
(``use_reentrant=False``) and a Function without ``setup_context``
(``use_reentrant=True``). Zamba2's, xLSTM's and Whisper's layers go
through it too, each with its own layer function. Remat changes no number; on the card K3
then runs twice per layer (the forward, and the recompute that asks for
the log-sum-exp) and its backward once.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamTree
from repro_torch.sharding.context import (constrain, data_mesh, get_rules, is_whole,
                                          split_mesh)
from repro_torch.sharding.logical import axes_tree, unbox
from repro_torch.sharding.parallel import (copy_to_model, gather_for_data, gather_from_model,
                                           lookup_for_data, max_from_model,
                                           merge_decode_partials, reduce_from_model)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """Parameter container. ``axes`` maps each ``state_dict`` name to its
    logical axes (the reference's, without the stacked "layers" axis)."""

    def __init__(self, embedding: nn.Parameter, layers: List[ParamTree],
                 final_norm: ParamTree, lm_head: nn.Parameter, axes: Dict[str, Tuple]):
        super().__init__()
        self.embedding = embedding
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.axes = axes

    def __getitem__(self, key: str):
        return getattr(self, key)


class FlatParams:
    """A flat parameter dict read with the module's keys:
    ``FlatParams(flat)["layers"][0]["attn"]["wq"]["w"]`` is
    ``flat["layers.0.attn.wq.w"]``."""

    def __init__(self, flat: Mapping[str, torch.Tensor], prefix: str = ""):
        self.flat, self.prefix = flat, prefix

    def __getitem__(self, key):
        name = f"{self.prefix}{key}"
        if name in self.flat:
            return self.flat[name]
        return FlatParams(self.flat, name + ".")

    def __contains__(self, key) -> bool:
        return f"{self.prefix}{key}" in self.flat


Params = Union[Transformer, Mapping[str, torch.Tensor]]


def as_tree(params):
    """The module (any family's) as it is, a flat dict behind ``FlatParams``."""
    return params if isinstance(params, nn.Module) else FlatParams(params)


def train_params(model: nn.Module) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """``(params, axes)`` for the round step: the module's tensors under their
    ``state_dict`` names (the same storage, not a copy) and their logical
    axes. ``lm_head``'s vocabulary axis is axis 1: it stays dense on the
    sparse transport and is heat-corrected on the dense one."""
    return unbox(model), axes_tree(model)


#: the prefixes whose leaves the reference stacks on a leading layer axis:
#: the transformer's ``layers``, Zamba2's ``mamba``, each run of xLSTM
#: blocks (``runs.{r}.m`` or ``runs.{r}.s``) and Whisper's ``encoder`` and
#: ``decoder``
_STACKED = r"(layers|mamba|encoder|decoder|runs\.\d+\.[ms])"
_PER_LAYER_NAME = re.compile(_STACKED + r"\.(\d+)\.(.+)")
_STACKED_NAME = re.compile(_STACKED + r"\.(.+)")


def stack_layers(flat: Mapping[str, torch.Tensor], axes: Optional[Mapping[str, Tuple]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Tuple]]]:
    """The flat training dict of any family in the reference's stacked
    layout: each layer leaf ``layers.{i}.attn.wq.w`` (``mamba.{i}.in_proj``,
    ``runs.{r}.m.{i}.up_z``) goes, in layer order, into one ``(L, ...)``
    tensor under ``layers.attn.wq.w`` (``mamba.in_proj``,
    ``runs.{r}.m.up_z``, ``encoder.attn.wq.w``), its axes led by
    ``"layers"``; the other leaves (``shared_attn.*``, ``encoder_norm.scale``
    among them) stay as they are. ``save_checkpoint`` of
    the two writes the reference's LLM checkpoint."""
    out: Dict[str, object] = {}
    per_layer: Dict[str, str] = {}
    for name, t in flat.items():
        m = _PER_LAYER_NAME.fullmatch(name)
        if m:
            prefix, i, rest = m.groups()
            key = f"{prefix}.{rest}"
            out.setdefault(key, {})[int(i)] = t
            per_layer[key] = f"{prefix}.0.{rest}"
        else:
            out[name] = t
    for name, by_layer in out.items():
        if isinstance(by_layer, dict):
            if sorted(by_layer) != list(range(len(by_layer))):
                raise ValueError(f"{name}: layers {sorted(by_layer)} are not 0..L-1")
            out[name] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    if axes is None:
        return out, None
    return out, {name: (("layers",) + tuple(axes[per_layer[name]]) if name in per_layer
                        else tuple(axes[name])) for name in out}


def unstack_layers(stacked: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``stack_layers``'s inverse: ``layers.attn.wq.w`` ``(L, ...)`` back to
    ``layers.{i}.attn.wq.w`` (a view of each slice; numpy arrays too), each
    stacked prefix's layers at the place of its first leaf, in
    ``train_params``'s key order."""
    groups: Dict[str, List[str]] = {}
    for name in stacked:
        m = _STACKED_NAME.fullmatch(name)
        if m:
            groups.setdefault(m.group(1), []).append(name)
    out: Dict[str, torch.Tensor] = {}
    for name, t in stacked.items():
        m = _STACKED_NAME.fullmatch(name)
        if m is None:
            out[name] = t
        elif name == groups[m.group(1)][0]:
            prefix = m.group(1)
            for i in range(t.shape[0]):
                for n in groups[prefix]:
                    out[f"{prefix}.{i}.{n[len(prefix) + 1:]}"] = stacked[n][i]
    return out


#: a tensor of more elements than this is drawn in slices along axis 0 of at
#: most ``DRAW_SLICE`` elements (at least one row), so that drawing it takes
#: one f32 slice beside the model rather than the whole tensor in f32: a
#: Llama 4 expert stack (128, 5,120, 8,192) is 21.5 GB in f32. Every tensor
#: of the other configurations is below it and is drawn whole, as before
DRAW_WHOLE_MAX = 1 << 30
DRAW_SLICE = 1 << 28


class _Factory:
    """Makes each parameter as ``repro/sharding/logical.py::ParamFactory``
    draws it (``normal``: 0.02 * N(0, 1); ``fan_in``: N(0, 1) /
    sqrt(shape[-2]) of the unstacked shape; ``ones``; ``zeros``; drawn in
    f32, then cast; above ``DRAW_WHOLE_MAX`` elements in slices along axis
    0; ``ssm_a``: Mamba2's A_log, log U[1, 16], kept in f32), or takes it from
    ``state`` by name; records its logical axes. On the ``meta`` device it
    draws nothing: the tensor has a shape and a dtype only."""

    def __init__(self, dtype, device, generator, state, axes=None, prefix=""):
        self.dtype, self.device = dtype, device
        self.generator, self.state = generator, state
        self.axes: Dict[str, Tuple] = {} if axes is None else axes
        self.prefix = prefix

    def scope(self, name: str) -> "_Factory":
        return _Factory(self.dtype, self.device, self.generator, self.state, self.axes,
                        f"{self.prefix}{name}.")

    def __call__(self, name, shape, axes, init="fan_in", dtype=None) -> nn.Parameter:
        full = self.prefix + name
        self.axes[full] = tuple(axes)
        dtype = dtype or self.dtype
        if self.state is not None:
            if full not in self.state:
                raise ValueError(f"{full}: not in the given state")
            value = torch.as_tensor(self.state[full])
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f"{full}: shape {tuple(value.shape)}, want {tuple(shape)}")
            value = value.to(self.device, dtype, copy=True)
        elif self.device.type == "meta":
            value = torch.empty(shape, dtype=dtype, device=self.device)
        elif init in ("ones", "zeros"):
            value = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=dtype, device=self.device)
        elif init == "ssm_a":
            u = torch.rand(shape, generator=self.generator, dtype=torch.float32,
                           device=self.device)
            value = torch.log(u * 15.0 + 1.0).to(dtype)
        else:
            std = 0.02 if init == "normal" else 1.0 / math.sqrt(max(shape[-2], 1))
            value = self._draw(shape, std, dtype)
        return nn.Parameter(value, requires_grad=False)

    def _draw(self, shape, std: float, dtype) -> torch.Tensor:
        def randn(part_shape):
            return torch.randn(part_shape, generator=self.generator, dtype=torch.float32,
                               device=self.device).mul_(std)

        if math.prod(shape) <= DRAW_WHOLE_MAX:
            return randn(shape).to(dtype)
        value = torch.empty(shape, dtype=dtype, device=self.device)
        rows = max(1, DRAW_SLICE // math.prod(shape[1:]))
        for i in range(0, shape[0], rows):
            part = value[i:i + rows]
            part.copy_(randn(part.shape))
        return value


def _make_linear(pf: _Factory, name: str, d_in: int, d_out: int, axes: Tuple,
                 bias: bool = False) -> ParamTree:
    pf = pf.scope(name)
    p = {"w": pf("w", (d_in, d_out), axes)}
    if bias:
        p["b"] = pf("b", (d_out,), (axes[-1],), init="zeros")
    return ParamTree(p)


def _make_rmsnorm(pf: _Factory, name: str, d: int) -> ParamTree:
    return ParamTree({"scale": pf.scope(name)("scale", (d,), ("embed",), init="ones",
                                               dtype=torch.float32)})


def make_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, state: Optional[Mapping[str, object]] = None
                ) -> Transformer:
    """The model's parameters on ``device`` (the card unless ``"cpu"``).

    Drawn from ``generator`` (a ``torch.Generator`` on that device; seed 0
    when omitted) with the reference's distributions, or taken from
    ``state``, keyed by ``state_dict`` names such as ``layers.0.attn.wq.w``.
    On ``device="meta"`` the tree has shapes and dtypes only
    (``api.abstract_params``).
    """
    if cfg.family in ("hybrid", "ssm"):
        raise ValueError(f"{cfg.name}: the {cfg.family} family's parameters come from "
                         "models/zamba.py or models/xlstm_model.py (api.build_model)")
    if cfg.family == "audio":
        from repro_torch.models import whisper
        return whisper.make_params(cfg, generator, device, state=state)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    dev = resolve_device(device)
    if generator is None and state is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    root = _Factory(model_dtype(cfg), dev, generator, state)
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    layers = []
    for i in range(cfg.num_layers):
        pf = root.scope(f"layers.{i}")
        ap = pf.scope("attn")
        attn = {
            "norm": _make_rmsnorm(ap, "norm", d),
            "wq": _make_linear(ap, "wq", d, q_dim, ("embed", "heads"), cfg.qkv_bias),
            "wk": _make_linear(ap, "wk", d, kv_dim, ("embed", "kv"), cfg.qkv_bias),
            "wv": _make_linear(ap, "wv", d, kv_dim, ("embed", "kv"), cfg.qkv_bias),
            "wo": _make_linear(ap, "wo", q_dim, d, ("heads", "embed")),
        }
        if cfg.qk_norm:
            attn["q_norm"] = ap("q_norm", (hd,), (None,), init="ones", dtype=torch.float32)
            attn["k_norm"] = ap("k_norm", (hd,), (None,), init="ones", dtype=torch.float32)
        ffn = (L.make_moe(pf.scope("ffn"), d, cfg.d_ff, cfg.num_experts) if cfg.is_moe
               else L.make_mlp(pf.scope("ffn"), d, cfg.d_ff))
        layers.append(ParamTree({"attn": ParamTree(attn),
                                 "ffn_norm": _make_rmsnorm(pf, "ffn_norm", d),
                                 "ffn": ffn}))
    embedding = root("embedding", (cfg.vocab_size, d), ("vocab", "embed"), init="normal")
    final_norm = _make_rmsnorm(root, "final_norm", d)
    lm_head = root("lm_head", (d, cfg.vocab_size), ("embed", "vocab"))
    return Transformer(embedding, layers, final_norm, lm_head, root.axes)


# ---------------------------------------------------------------------------
# The split over the model ranks
# ---------------------------------------------------------------------------


class Split(NamedTuple):
    """Which dims of the layers the installed rules split over the model
    ranks: each the model axis's ``CohortMesh``, or None where whole."""

    heads: object = None         # wq's columns, wo's rows: whole query heads
    kv: object = None            # wk's and wv's columns: whole KV heads
    ffn: object = None           # the MLP's (or each expert's) d_ff
    experts: object = None       # whole experts, and the router's columns
    vocab: object = None         # lm_head's columns
    batch: object = None         # the data axis, for the MoE's whole-batch routing
    embed: object = None         # the embedding's rows
    ssm: object = None           # Mamba2: in_proj's, conv_w's and conv_b's columns and
    #                              out_proj's rows, so whole SSM heads (ssm.mamba2_block)
    mlstm: object = None         # the mLSTM's inner dim: up_z's, up_x's, wq's, wk's and
    #                              wv's columns, w_i's, w_f's and down's rows, so whole
    #                              mLSTM heads (xlstm.mlstm_block)
    slstm: object = None         # the sLSTM's d: w_in's, b's and up's columns and down's
    #                              rows (xlstm.slstm_block)
    data: object = None          # FSDP: the data axis every weight's d_model is split
    #                              over, gathered where it is used (gather_for_data)


NO_SPLIT = Split()


def _all_or_none(what: str, meshes: Mapping[str, object]):
    """The one mesh of ``meshes`` when every dim splits, None when none
    does; a partial split is refused (no configuration has one)."""
    got = {m is None for m in meshes.values()}
    if len(got) > 1:
        raise NotImplementedError(
            f"{what}: the rules split {sorted(k for k, m in meshes.items() if m is not None)} "
            f"over 'model' but not {sorted(k for k, m in meshes.items() if m is None)}")
    return next(iter(meshes.values()))


def model_split(cfg: ModelConfig) -> Split:
    """The split of ``cfg``'s layers under the installed rules (none off the
    mesh). It follows ``rules.param_rules`` as ``launch.shardings`` does,
    so it is the split of the rank's parameters: KV heads only with query
    heads, each only where its count divides the model axis. The
    embedding's rows split with the vocabulary, except where the sparse
    transport hands the loss a whole sub-table (``context.whole_leaves``).
    Zamba2's Mamba2 layers split by whole SSM heads where every fused dim
    divides the model axis (``ssm``); xLSTM's blocks by their inner dims
    (``mlstm``, ``slstm``), and it has no attention or MLP to split.
    Under FSDP (``context.data_mesh``) every weight's ``d_model`` is split
    over ``data`` too (``data``); the MoE routes the whole batch over the
    rules' batch axes (``("data",)``, or ``("pod", "data")`` on the
    multi-pod mesh)."""
    mesh, rules = get_rules()
    if mesh is None:
        return NO_SPLIT
    data = data_mesh(cfg.d_model)
    if data is not None and cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: FSDP (each weight's d_model over 'data') runs the dense, MoE "
            f"and VLM families; the {cfg.family} family trains and serves on the mesh "
            "with layout='tp'")
    hd = cfg.head_dim
    vocab = split_mesh("vocab", cfg.vocab_size)
    embed = None if is_whole("embedding") else vocab
    if cfg.family == "ssm":
        d = cfg.d_model
        di = cfg.ssm_expand * d
        m = int(mesh.shape.get("model", 1))
        mlstm = _all_or_none("the mLSTM", {
            "ffn": split_mesh("ffn", di), "heads": split_mesh("heads", di),
            "ssm_heads": split_mesh("heads", di) if cfg.ssm_heads % m == 0 else None})
        slstm = _all_or_none("the sLSTM", {
            f"ffn {n}d": split_mesh("ffn", n * d) for n in (1, 2, 4)})
        return Split(vocab=vocab, embed=embed, mlstm=mlstm, slstm=slstm)
    heads = split_mesh("heads", cfg.num_heads * hd)
    batch = None
    batch_axes = tuple(rules.get("batch") or ())
    if cfg.is_moe and math.prod(int(mesh.shape.get(n, 1)) for n in batch_axes) > 1:
        batch = mesh.axis(batch_axes)
    ssm = None
    if cfg.family == "hybrid":
        di, n, h = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.ssm_heads
        m = int(mesh.shape.get("model", 1))
        ssm = _all_or_none("Mamba2", {
            "in_proj": split_mesh("ffn", 2 * di + 2 * n + h),
            "conv": split_mesh("ffn", di + 2 * n), "out_proj": split_mesh("ffn", di),
            "ssm heads": split_mesh("ffn", di) if h % m == 0 else None})
    return Split(heads=heads,
                 kv=split_mesh("kv", cfg.num_kv_heads * hd) if heads is not None else None,
                 ffn=split_mesh("ffn", cfg.d_ff),
                 experts=split_mesh("experts", cfg.num_experts) if cfg.is_moe else None,
                 vocab=vocab, batch=batch, embed=embed, ssm=ssm, data=data)


#: the dim of ``d_model`` (the ``embed`` axis) in the leaves outside the
#: layers that FSDP gathers whole where they are used (the embedding's rows
#: are looked up instead: ``lookup_for_data``)
_TOP_EMBED_DIMS = {"lm_head": 0, "final_norm.scale": 0}


@functools.lru_cache(maxsize=32)
def layer_embed_dims(cfg: ModelConfig) -> Dict[str, int]:
    """The dim of ``d_model`` (the ``embed`` axis) of each of a layer's
    leaves that has one, by its name within the layer (``attn.wq.w``: 0,
    ``attn.wo.w``: 1), from the model's axes on ``meta``."""
    axes = make_params(cfg.replace(num_layers=1), device="meta").axes
    return {name[len("layers.0."):]: ax.index("embed") for name, ax in axes.items()
            if name.startswith("layers.0.") and "embed" in ax}


def gather_layer(cfg: ModelConfig, names, tensors, split: Split) -> tuple:
    """A layer's parameter tensors (named within the layer) with every
    ``d_model`` slice gathered whole over ``data`` under FSDP; as they are
    otherwise."""
    if split.data is None:
        return tuple(tensors)
    dims = layer_embed_dims(cfg)
    return tuple(gather_for_data(t, split.data, dims[n]) if n in dims else t
                 for n, t in zip(names, tensors))


def _gathered_layer(cfg: ModelConfig, lp, split: Split):
    """``lp`` (a layer's parameters) with its weights gathered whole under
    FSDP, behind ``FlatParams``; ``lp`` as it is otherwise."""
    if split.data is None:
        return lp
    names, tensors = _layer_leaves(lp)
    return FlatParams(dict(zip(names, gather_layer(cfg, names, tensors, split))))


def whole_leaf(p, name: str, split: Split) -> torch.Tensor:
    """``lm_head`` or the final norm's scale (``name``), gathered whole over
    ``data`` under FSDP where it is used; as it is otherwise."""
    t = p[name]
    if split.data is None:
        return t
    return gather_for_data(t, split.data, _TOP_EMBED_DIMS[name])


def final_norm(p, split: Split):
    """The final norm's parameters as ``layers.rmsnorm`` reads them."""
    return p["final_norm"] if split.data is None else {
        "scale": whole_leaf(p, "final_norm.scale", split)}


def _copied(p, mesh, tag: str):
    """A linear's weight and bias through ``copy_to_model``: whole on every
    rank, but used in part, so its gradient is summed over the ranks."""
    return {name: copy_to_model(p[name], mesh, tag) for name in ("w", "b") if name in p}


def _rank_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, rank: int, hl: int):
    """The KV heads that query heads ``[rank * hl, (rank + 1) * hl)`` attend
    with, from whole K and V: their whole groups, the one group they lie
    in, or (groups cut unevenly) one KV head per query head."""
    g = cfg.num_heads // cfg.num_kv_heads
    h0 = rank * hl
    if hl % g == 0 or g % hl == 0:
        lo, n = h0 // g, max(hl // g, 1)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.div(torch.arange(h0, h0 + hl, device=k.device), g, rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


# ---------------------------------------------------------------------------
# Attention block (shared by prefill / decode)
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ModelConfig, ap, x: torch.Tensor, positions: torch.Tensor,
                 mrope_pos: Optional[torch.Tensor] = None, split: Split = NO_SPLIT):
    """Q, K and V ``(B, S, heads, hd)``, RoPE'd. Split, Q holds the rank's
    query heads and K/V its KV heads, or all of them where the KV heads are
    whole (their weights, and the QK norms, then take ``copy_to_model``)."""
    b, s = x.shape[:2]
    wk, wv = ap["wk"], ap["wv"]
    q_norm = ap["q_norm"] if cfg.qk_norm else None
    k_norm = ap["k_norm"] if cfg.qk_norm else None
    mesh = split.heads
    hl, kvl = cfg.num_heads, cfg.num_kv_heads
    if mesh is not None:
        x = copy_to_model(x, mesh, "attn_in")
        hl //= mesh.size
        if split.kv is not None:
            kvl //= mesh.size
        else:
            wk, wv = _copied(wk, mesh, "attn_kv"), _copied(wv, mesh, "attn_kv")
        if cfg.qk_norm:
            q_norm = copy_to_model(q_norm, mesh, "qk_norm")
            k_norm = copy_to_model(k_norm, mesh, "qk_norm")
    q = L.linear(ap["wq"], x).reshape(b, s, hl, cfg.head_dim)
    k = L.linear(wk, x).reshape(b, s, kvl, cfg.head_dim)
    v = L.linear(wv, x).reshape(b, s, kvl, cfg.head_dim)
    constrain(q, ("batch", None, "heads_act", None), (None, s, cfg.num_heads, cfg.head_dim))
    constrain(k, ("batch", None, "kv_act", None), (None, s, cfg.num_kv_heads, cfg.head_dim))
    constrain(v, ("batch", None, "kv_act", None), (None, s, cfg.num_kv_heads, cfg.head_dim))
    if cfg.qk_norm:
        q = L.head_rmsnorm(q_norm, q, cfg.norm_eps)
        k = L.head_rmsnorm(k_norm, k, cfg.norm_eps)
    if cfg.mrope and mrope_pos is not None:
        q = L.apply_mrope(q, mrope_pos, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_mrope(k, mrope_pos, cfg.rope_theta, cfg.mrope_sections)
    else:
        # an M-RoPE config given no mrope_pos falls back to plain RoPE, as
        # the reference does
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg: ModelConfig, ap, x: torch.Tensor, positions: torch.Tensor,
                    mrope_pos: Optional[torch.Tensor] = None, split: Split = NO_SPLIT):
    """Full-sequence (prefill) attention through ``mea_attention`` (K3 on
    the card; split, on the rank's query heads). Returns (out, (k, v))."""
    if cfg.attn_impl != "mea":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: the port's attention is 'mea' only")
    q, k, v = _project_qkv(cfg, ap, x, positions, mrope_pos, split)
    ka, va = k, v
    if split.heads is not None and split.kv is None:
        ka, va = _rank_kv(cfg, k, v, split.heads.rank, q.shape[2])
    o = L.mea_attention(q, ka, va, causal=True, window=cfg.sliding_window,
                        query_chunk=cfg.query_chunk, kv_chunk=cfg.kv_chunk)
    b, s = x.shape[:2]
    out = L.linear(ap["wo"], o.reshape(b, s, q.shape[2] * cfg.head_dim), reduce=split.heads,
                   tag="attn_out")
    return out, (k, v)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None,
                 split: Split = NO_SPLIT) -> torch.Tensor:
    """Token embeddings scaled by sqrt(d_model); with ``patch_embeds``
    ``(B, P, d)`` and ``cfg.num_patches > 0`` (early fusion) the first P
    positions take the patch embeddings instead, unscaled, in x's dtype.
    Split over the vocabulary (``split.embed``), each rank looks up the
    tokens in its rows, zeroes the others, and the ranks' rows are summed
    (exact: one term is not zero). Under FSDP the table's columns are split
    over ``data`` and its rows are looked up whole-width through
    ``lookup_for_data``, except where the sparse transport hands the loss
    a whole sub-table (``context.whole_leaves``)."""
    emb = params["embedding"]
    data = None if is_whole("embedding") else split.data

    def lookup(ids):
        return emb[ids] if data is None else lookup_for_data(emb, ids, data)

    # sqrt(d_model) in f32, then rounded to the table's dtype, as the
    # reference scales it (in bf16, sqrt(5120) = 71.55 becomes 71.5)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    mesh = split.embed
    if mesh is None:
        x = lookup(tokens) * float(scale.to(emb.dtype))
    else:
        rows = emb.shape[0]
        local = tokens - mesh.rank * rows
        mine = (local >= 0) & (local < rows)
        x = lookup(torch.where(mine, local, 0)) * float(scale.to(emb.dtype))
        x = reduce_from_model(torch.where(mine[..., None], x, 0.0), mesh, "embed")
    constrain(x, ("batch", None, None), (None, tokens.shape[1], cfg.d_model))
    if patch_embeds is None or cfg.num_patches <= 0:
        return x
    p = patch_embeds.shape[1]
    if p > x.shape[1]:
        raise ValueError(f"embed_tokens: {p} patch embeddings for {x.shape[1]} positions")
    return torch.cat([patch_embeds.to(x.dtype), x[:, p:]], dim=1)


# ---------------------------------------------------------------------------
# Forward (train / prefill) and the LM loss
# ---------------------------------------------------------------------------


class ForwardOut(NamedTuple):
    hidden: torch.Tensor                 # (B, S, d) final-norm'd hidden states
    aux_loss: torch.Tensor               # MoE load-balance aux, mean over layers (0 for dense)
    kv: Optional[List[Tuple]]            # per layer (k, v), each (B, S, KV, hd)


def ffn_block(cfg: ModelConfig, fp, x: torch.Tensor, capacity: int = 0,
              split: Split = NO_SPLIT):
    """The gated MLP, or the MoE; returns (out, MoE aux loss or None).
    ``capacity`` > 0 sets the MoE's capacity and routes all tokens at once
    (decode); 0 takes the configured factor and token chunk (forward)."""
    if not cfg.is_moe:
        return L.mlp(fp, x, mesh=split.ffn), None
    out, stats = L.moe(fp, x, num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                       capacity_factor=cfg.moe_capacity_factor,
                       deterministic_capacity=capacity,
                       token_chunk=0 if capacity else cfg.moe_token_chunk,
                       mesh=split.experts or split.ffn,
                       expert_parallel=split.experts is not None, batch=split.batch)
    return out, stats.aux_loss


def _layer(cfg: ModelConfig, lp, x: torch.Tensor, positions: torch.Tensor,
           mrope_pos: Optional[torch.Tensor], split: Split = NO_SPLIT):
    """One decoder layer: ``(x, MoE aux or None, (k, v))``."""
    h, kv = attention_block(cfg, lp["attn"], L.rmsnorm(lp["attn"]["norm"], x, cfg.norm_eps),
                            positions, mrope_pos, split)
    x = x + h
    f, aux = ffn_block(cfg, lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps),
                       split=split)
    x = constrain(x + f, ("batch", None, None), (None, x.shape[1], cfg.d_model))
    return x, aux, kv


def _layer_leaves(lp) -> Tuple[List[str], List[torch.Tensor]]:
    """A layer's parameter tensors and their names within the layer
    (``attn.wq.w``), from the module or the flat training dict."""
    if isinstance(lp, FlatParams):
        names = [n[len(lp.prefix):] for n in lp.flat if n.startswith(lp.prefix)]
        return names, [lp.flat[lp.prefix + n] for n in names]
    named = list(lp.named_parameters())
    return [n for n, _ in named], [t for _, t in named]


def _layer_fn(cfg: ModelConfig, names: Tuple[str, ...], split: Split = NO_SPLIT) -> Callable:
    """``run(x, positions, mrope_pos, *tensors)``: one layer whose parameter
    tensors come in the order of ``names``; returns ``(x,)``, or ``(x,
    aux)`` with the MoE's aux loss as a (1,) tensor. ``split`` is taken
    when the layer is built: remat's recompute may run on autograd's
    device thread, which does not see the installed rules."""
    def run(x, positions, mrope_pos, *tensors):
        tensors = gather_layer(cfg, names, tensors, split)
        x, aux, _ = _layer(cfg, FlatParams(dict(zip(names, tensors))), x, positions,
                           mrope_pos, split)
        return (x, aux.reshape(1)) if cfg.is_moe else (x,)
    return run


def _split(tensors, layer_names) -> List[tuple]:
    out, at = [], 0
    for names in layer_names:
        out.append(tuple(tensors[at:at + len(names)]))
        at += len(names)
    return out


class _Remat(torch.autograd.Function):
    """Consecutive layers (``layer_names``: each layer's parameter names, its
    tensors in that order after ``mrope_pos``) that keep only their inputs
    for the backward: ``jax.checkpoint`` for ``torch.func``. ``layer_fn``
    makes each layer's function from its names: ``layer_fn(names)(x,
    positions, mrope_pos, *tensors)`` returns ``(x,)`` or ``(x, aux)``, aux
    a (1,) tensor (``_layer_fn`` here; Zamba2's, xLSTM's and Whisper's layers
    in their modules). Returns ``(x,)``, or ``(x, aux per layer)`` when the layers
    give one (the MoE). A tensor given to several applications (Zamba2's
    shared block at each of its sites, Whisper's encoder output at each
    decoder layer) gets the sum of their gradients.

    The backward runs each layer again under ``torch.func.vjp`` and takes
    its vector-Jacobian product. Over several layers (a group of the
    two-level remat) it first reruns the group without grad to get each
    layer's input, then goes back layer by layer, recomputing each: the
    group keeps its input, its rerun each layer's, as the reference's
    nested ``jax.checkpoint`` (whose rerun also runs the group's last
    layer, whose output the backward does not need). ``setup_context`` and
    the generated vmap rule let ``grad`` and ``vmap(grad)`` of a loss reach
    through it; the hidden state and each parameter tensor are inputs of
    their own, so that the gradient flows to each; the integer positions
    get none. It is once differentiable, as K3's backward is."""

    generate_vmap_rule = True

    @staticmethod
    def forward(layer_fn, layer_names, x, positions, mrope_pos, *tensors):
        auxes = []
        for names, ts in zip(layer_names, _split(tensors, layer_names)):
            got = layer_fn(names)(x, positions, mrope_pos, *ts)
            x = got[0]
            auxes.extend(got[1:])
        return (x, torch.cat(auxes)) if auxes else (x,)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.layer_fn, ctx.layer_names = inputs[:2]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    def backward(ctx, gx, *gaux):
        layer_names = ctx.layer_names
        x, positions, mrope_pos, *tensors = ctx.saved_tensors
        fns = [ctx.layer_fn(names) for names in layer_names]
        per_layer = _split(tensors, layer_names)
        inputs = [x]
        with torch.no_grad():
            for fn, ts in zip(fns[:-1], per_layer[:-1]):
                inputs.append(fn(inputs[-1], positions, mrope_pos, *ts)[0])
        grads: List[tuple] = [()] * len(fns)
        for j in reversed(range(len(fns))):
            def rerun(xj, *ts, fn=fns[j]):
                return fn(xj, positions, mrope_pos, *ts)

            _, vjp_fn = torch.func.vjp(rerun, inputs[j], *per_layer[j])
            got = vjp_fn((gx, gaux[0][j:j + 1]) if gaux else (gx,))
            # torch.func.grad differentiates with create_graph, so this
            # backward is recorded and each op takes the differentiable
            # formula it takes without remat (under no_grad the fused silu
            # backward would round otherwise): the bits agree. Detached, the
            # gradients do not keep each layer's recompute alive until the
            # whole gradient is done
            gx, grads[j] = got[0].detach(), tuple(g.detach() for g in got[1:])
            del vjp_fn, got
        return (None, None, gx, None, None, *(g for gs in grads for g in gs))


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None,
            mrope_pos: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            collect_kv: bool = False, remat: bool = True) -> ForwardOut:
    """Full-sequence forward (train / prefill) over the module or the flat
    training dict. ``patch_embeds`` ``(B, P, d)`` replace the first P
    positions' embeddings; ``mrope_pos`` ``(3, B, S)`` drives M-RoPE.
    ``remat`` (in grad mode, without ``collect_kv``) keeps only each layer's
    input for the backward, which recomputes the layer; with
    ``cfg.remat_groups`` G > 1 dividing the depth, each of G groups of L/G
    layers keeps only its input too (the reference's two-level remat)."""
    p = as_tree(params)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    split = model_split(cfg)
    x = embed_tokens(cfg, p, tokens, patch_embeds, split)
    nl = cfg.num_layers
    kvs = [] if collect_kv else None
    auxes = []
    if remat and not collect_kv and torch.is_grad_enabled():
        leaves = [_layer_leaves(p["layers"][i]) for i in range(nl)]
        g = cfg.remat_groups
        per = nl // g if g > 1 and nl % g == 0 else 1
        for start in range(0, nl, per):
            group = leaves[start:start + per]
            got = _Remat.apply(functools.partial(_layer_fn, cfg, split=split),
                               tuple(tuple(names) for names, _ in group), x, positions,
                               mrope_pos, *(t for _, ts in group for t in ts))
            x = got[0]
            if cfg.is_moe:
                auxes.append(got[1])
        aux_all = torch.cat(auxes) if auxes else None
    else:
        for i in range(nl):
            x, aux, kv = _layer(cfg, _gathered_layer(cfg, p["layers"][i], split), x,
                                positions, mrope_pos, split)
            if aux is not None:
                auxes.append(aux)
            if collect_kv:
                kvs.append(kv)
        aux_all = torch.stack(auxes) if auxes else None
    hidden = L.rmsnorm(final_norm(p, split), x, cfg.norm_eps)
    aux_loss = (aux_all.mean() if aux_all is not None
                else torch.zeros((), dtype=torch.float32, device=x.device))
    return ForwardOut(hidden, aux_loss, kvs)


def chunked_xent(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor, chunk: int = 512,
                 split: Split = NO_SPLIT) -> torch.Tensor:
    """Next-token cross-entropy in sequence chunks against ``lm_head``: f32
    logits of one ``(B, c, V)`` chunk at a time, ``logsumexp - gold`` masked,
    summed over chunks and divided by ``max(mask count, 1)``.

    Split over the vocabulary (``split.vocab``), each rank makes its
    ``(B, c, V/m)`` logits; the max over the vocabulary is a max over the
    ranks, the sum of exponentials and the gold logit (from the rank that
    holds it, zero elsewhere) are summed over them in one all-reduce."""
    head = whole_leaf(as_tree(params), "lm_head", split)
    mesh = split.vocab
    if mesh is not None:
        hidden = copy_to_model(hidden, mesh, "xent_in")
    s = hidden.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"chunked_xent: sequence length {s} is not a multiple of {c}")
    losses, counts = [], []
    for i in range(s // c):
        piece = slice(i * c, (i + 1) * c)
        logits = constrain((hidden[:, piece] @ head).float(), ("batch", None, "vocab"),
                           (None, c, cfg.vocab_size))
        if mesh is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, targets[:, piece, None].long())[..., 0]
        else:
            top = max_from_model(logits.amax(dim=-1), mesh, "xent_max")
            local = targets[:, piece].long() - mesh.rank * logits.shape[-1]
            mine = (local >= 0) & (local < logits.shape[-1])
            gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
            sums = reduce_from_model(
                torch.stack([torch.exp(logits - top[..., None]).sum(dim=-1),
                             torch.where(mine, gold, 0.0)]), mesh, "xent_sum")
            lse, gold = torch.log(sums[0]) + top, sums[1]
        m = mask[:, piece]
        losses.append(((lse - gold) * m).sum())
        counts.append(m.sum())
    return torch.stack(losses).sum() / torch.clamp(torch.stack(counts).sum(), min=1.0)


def lm_targets(batch: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``(tokens, labels, mask)`` of an LM batch: ``labels`` default to the
    tokens shifted left and padded with 0, ``mask`` to ones."""
    tokens = batch["tokens"]
    targets = batch.get("labels")
    if targets is None:
        targets = F.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    return tokens, targets, mask


def loss_fn(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Causal LM loss, the mean over the batch's unmasked tokens
    (``lm_targets``), plus ``router_aux_weight`` times the MoE aux loss. The
    batch's ``patch_embeds`` and ``mrope_pos``, when present, go to
    ``forward``, as does ``remat`` (on by default, as the reference's). A
    dense model has no router: the reference adds ``router_aux_weight * 0``,
    which changes no bit, and the port adds nothing."""
    tokens, targets, mask = lm_targets(batch)
    out = forward(cfg, params, tokens, patch_embeds=batch.get("patch_embeds"),
                  mrope_pos=batch.get("mrope_pos"), remat=remat)
    ce = chunked_xent(cfg, params, out.hidden, targets, mask, split=model_split(cfg))
    return ce + cfg.router_aux_weight * out.aux_loss if cfg.is_moe else ce


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> L.KVCache:
    cap = min(cfg.sliding_window, max_seq) if cfg.sliding_window > 0 else max_seq
    return L.make_kv_cache(cfg.num_layers, batch, cfg.num_kv_heads, cap, cfg.head_dim,
                           dtype=model_dtype(cfg), device=resolve_device(device))


def _seq_mesh(cache):
    """The model axis's mesh when the cache (a ``layers.KVCache``, or
    Zamba2's or Whisper's, whose ``k`` and ``v`` are the KV cache) is this
    rank's slice of a cache split by sequence
    (``launch.shardings.local_cache``), else None."""
    if cache.k.shape[3] == cache.capacity:
        return None
    mesh = get_rules()[0]
    if mesh is None:
        raise ValueError(f"a slice of {cache.k.shape[3]} of a {cache.capacity}-slot cache "
                         "with no mesh installed")
    return mesh.axis("model")


def decode_attend(q: torch.Tensor, k_layer: torch.Tensor, v_layer: torch.Tensor,
                  slot_pos: torch.Tensor, pos: int, split: Split, seq, window: int = 0
                  ) -> torch.Tensor:
    """One token's attention through K4: ``q`` ``(B, heads, hd)`` the rank's
    query heads (all of them off the mesh), the cache layer ``(B, KV, S,
    hd)`` this rank's slice. Split, q is gathered over ``model``
    (``decode_q``), K4 runs on every head against the slice with its
    log-sum-exp out where ``seq`` (the model axis) splits the slots, the
    ranks' partials are merged (``merge_decode_partials``), and the rank's
    heads of the result are returned."""
    hl = q.shape[1]
    heads = split.heads
    if heads is not None:
        q = gather_from_model(q, heads, "decode_q", dim=1)
    if seq is None:
        o = L.decode_attention(q, k_layer, v_layer, slot_pos, pos, window=window)
    else:
        o, lse = L.decode_attention(q, k_layer, v_layer, slot_pos, pos, window=window,
                                    return_lse=True)
        o = merge_decode_partials(o, lse, seq, k_layer.dtype)
    if heads is not None:
        o = o[:, heads.rank * hl:(heads.rank + 1) * hl]
    return o


def decode_kv(k: torch.Tensor, v: torch.Tensor, split: Split):
    """One token's K and V ``(B, KV, hd)`` of every KV head: gathered over
    ``model`` where the KV heads are split (``decode_kv``)."""
    if split.kv is None:
        return k, v
    return gather_from_model(torch.stack([k, v]), split.kv, "decode_kv", dim=2).unbind(0)


def write_prefill_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, split: Split, start: int) -> None:
    """A layer's prefill K and V ``(B, S, KV, hd)`` (the rank's KV heads)
    into its cache layer ``(B, KV, slots, hd)``, this rank's slice of slots
    from ``start``: the KV heads gathered over ``model`` where they are
    split (``prefill_kv``); slots the prompt does not reach stay."""
    if split.kv is not None:
        k, v = gather_from_model(torch.stack([k, v]), split.kv, "prefill_kv", dim=3).unbind(0)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    hi = min(start + cache_k.shape[2], k.shape[2])
    if hi > start:
        cache_k[:, :, :hi - start] = k[:, :, start:hi]
        cache_v[:, :, :hi - start] = v[:, :, start:hi]


def _whole_logits(p, hidden: torch.Tensor, split: Split) -> torch.Tensor:
    """f32 logits of ``hidden`` (B, d), the vocabulary whole: gathered over
    the model ranks where ``lm_head``'s columns are split."""
    logits = (hidden @ whole_leaf(p, "lm_head", split)).float()
    if split.vocab is not None:
        logits = gather_from_model(logits, split.vocab, "logits", dim=-1)
    return logits


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: L.KVCache, *, patch_embeds: Optional[torch.Tensor] = None,
            mrope_pos: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, L.KVCache]:
    """Run the prompt (its first positions ``patch_embeds`` when given,
    M-RoPE on ``mrope_pos`` (3, B, S) when given), fill the cache (in
    place), return last-token logits (f32) and the cache at position
    ``S``.

    Under installed rules (``make_rules("decode")``, the rank's part of the
    flat dict and of the cache, ``launch.shardings.local_cache``): the
    forward runs on the rank's query heads through K3 as training's does;
    the rank's K/V heads are gathered over ``model`` where they are split,
    and the rank keeps its slice of the cache's slots (after the ring's
    roll); the logits are gathered whole over the vocabulary."""
    p = as_tree(params)
    split = model_split(cfg)
    out = forward(cfg, params, tokens, patch_embeds=patch_embeds, mrope_pos=mrope_pos,
                  collect_kv=True, remat=False)
    s = tokens.shape[1]
    cap, width, lo = cache.capacity, cache.k.shape[3], cache.start
    for i, (k, v) in enumerate(out.kv):
        if split.kv is not None:
            k, v = gather_from_model(torch.stack([k, v]), split.kv, "prefill_kv",
                                     dim=3).unbind(0)
        k, v = k.transpose(1, 2), v.transpose(1, 2)            # -> (B, KV, S, hd)
        if cfg.sliding_window > 0 and s > cap:
            # ring semantics: keep the last `cap` tokens at their mod-cap slots
            shift = s % cap
            k = torch.roll(k[:, :, -cap:], shift, dims=2)
            v = torch.roll(v[:, :, -cap:], shift, dims=2)
        hi = min(lo + width, k.shape[2])
        if hi > lo:
            cache.k[i, :, :, :hi - lo] = k[:, :, lo:hi]
            cache.v[i, :, :, :hi - lo] = v[:, :, lo:hi]
    return _whole_logits(p, out.hidden[:, -1], split), cache._replace(pos=s)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache: L.KVCache,
                tokens: torch.Tensor, *, mrope_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, L.KVCache]:
    """One decode step: tokens (B,) at position ``cache.pos`` (M-RoPE at
    ``mrope_pos`` (3, B, 1) when given). Writes the token's K/V into the
    cache (in place) before attending, as the reference does; returns f32
    logits and the cache at ``pos + 1``.

    Under installed rules each rank projects its query heads and gathers q
    over ``model`` (and the token's k and v where the KV heads are split);
    the rank whose slice holds the token's slot writes it; every rank runs
    K4 on all heads against its slice with the log-sum-exp out, and the
    ranks' partials are merged (``merge_decode_partials``); the rank's
    heads of the result go into the row-parallel ``wo``. A cache the rules
    leave whole on every rank (a capacity ``model`` does not divide) is
    written and read whole. The MoE routes the whole batch at its drop-free
    capacity ``B * k`` (B the whole batch's)."""
    p = as_tree(params)
    split = model_split(cfg)
    seq = _seq_mesh(cache)
    b = tokens.shape[0]
    pos = cache.pos
    ring = cfg.sliding_window > 0
    dev = tokens.device
    positions = torch.full((b, 1), pos, device=dev)
    x = embed_tokens(cfg, p, tokens[:, None], split=split)
    width = cache.k.shape[3]
    slot_pos = L.cache_slot_positions(pos + 1, cache.capacity, ring, dev)  # incl. current
    slot_pos = slot_pos[cache.start:cache.start + width].contiguous()
    heads = split.heads
    capacity = b * cfg.experts_per_token * (split.batch.size if split.batch is not None else 1)
    for i in range(cfg.num_layers):
        lp = _gathered_layer(cfg, p["layers"][i], split)
        ap = lp["attn"]
        q, k, v = _project_qkv(cfg, ap, L.rmsnorm(ap["norm"], x, cfg.norm_eps), positions,
                               mrope_pos, split)
        k, v = decode_kv(k[:, 0], v[:, 0], split)
        k_layer, v_layer = L.cache_write(cache.k[i], cache.v[i], pos, k, v, ring,
                                         cache.slots, cache.start)
        o = decode_attend(q[:, 0], k_layer, v_layer, slot_pos, pos, split, seq,
                          cfg.sliding_window)
        x = x + L.linear(ap["wo"], o.reshape(b, -1), reduce=heads, tag="attn_out")[:, None]
        # decode's MoE is drop-free: one token per sequence, capacity B * k
        f, _ = ffn_block(cfg, lp["ffn"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps),
                         capacity=capacity, split=split)
        x = x + f
    hidden = L.rmsnorm(final_norm(p, split), x, cfg.norm_eps)
    return _whole_logits(p, hidden[:, 0], split), cache._replace(pos=pos + 1)
