"""Uniform model API: port of ``repro/models/api.py``.

``build_model(cfg)`` returns a ``ModelApi`` whose functions have the
reference's signatures, so the serving and training launchers treat every
ported family the same way:

    init(generator=None, device=None, *, state=None)
                                           -> parameters (a ``Transformer``,
                                              a ``layers.ModelTree`` for Zamba2,
                                              xLSTM and Whisper)
    abstract_params()                      -> the same tree on ``meta``
    loss(params, batch, remat=True)        -> scalar (the module, or the flat
                                              dict of ``transformer.train_params``)
    init_cache(batch, max_seq, device=None) -> KVCache, ZambaCache, XLSTMCache
                                              or WhisperCache
    prefill(params, batch, cache)          -> (logits, cache)
    decode_step(params, cache, batch)      -> (logits, cache)
    input_specs(shape_name)                -> batch dict of ``meta`` tensors

``abstract_params`` and ``input_specs`` stand in for the reference's
``ShapeDtypeStruct`` trees: tensors on the ``meta`` device carry a shape and
a dtype and no storage, so a 123B configuration exists on any host. The
dense, MoE and VLM families (``models/transformer.py``; patch embeddings
and M-RoPE ride in the batch as ``patch_embeds`` and ``mrope_pos``), the
hybrid family (Zamba2, ``models/zamba.py``), the SSM family (xLSTM,
``models/xlstm_model.py``) and the audio family (Whisper,
``models/whisper.py``; its prefill reads the batch's ``frames``) are
ported: every family of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import xlstm_model as XM
from repro_torch.models import zamba as Z

META = torch.device("meta")


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]
    abstract_params: Callable[[], Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]
    input_specs: Callable[[str], Dict]


def _spec(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=META)


def _common_specs(cfg: ModelConfig, sc: ShapeConfig, kind: str) -> Dict[str, torch.Tensor]:
    b, s = sc.global_batch, sc.seq_len
    emb_dt = T.model_dtype(cfg)
    specs: Dict[str, torch.Tensor] = {}
    if kind == "decode":
        specs["tokens"] = _spec((b,), torch.int32)
    else:
        specs["tokens"] = _spec((b, s), torch.int32)
    if kind == "train":
        specs["labels"] = _spec((b, s), torch.int32)
        specs["mask"] = _spec((b, s), torch.float32)
    if cfg.frontend == "vision_patches" and kind != "decode":
        specs["patch_embeds"] = _spec((b, cfg.num_patches, cfg.d_model), emb_dt)
    if cfg.frontend == "audio_frames":
        specs["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model), emb_dt)
    if cfg.mrope:
        specs["mrope_pos"] = _spec((3, b, 1 if kind == "decode" else s), torch.int32)
    if kind == "train":
        # static heat statistics consumed by the FedSubAvg correction
        specs["heat_vocab"] = _spec((cfg.vocab_size,), torch.float32)
        if cfg.is_moe:
            specs["heat_expert"] = _spec((cfg.num_experts,), torch.float32)
    return specs


def build_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        mod = T

        def prefill(params, batch, cache):
            return T.prefill(cfg, params, batch["tokens"], cache,
                             patch_embeds=batch.get("patch_embeds"),
                             mrope_pos=batch.get("mrope_pos"))

        def decode_step(params, cache, batch):
            return T.decode_step(cfg, params, cache, batch["tokens"],
                                 mrope_pos=batch.get("mrope_pos"))

    elif fam in ("hybrid", "ssm"):
        mod = Z if fam == "hybrid" else XM

        def prefill(params, batch, cache):
            return mod.prefill(cfg, params, batch["tokens"], cache)

        def decode_step(params, cache, batch):
            return mod.decode_step(cfg, params, cache, batch["tokens"])

    elif fam == "audio":
        mod = W

        def prefill(params, batch, cache):
            return W.prefill(cfg, params, batch["tokens"], batch["frames"], cache)

        def decode_step(params, cache, batch):
            return W.decode_step(cfg, params, cache, batch["tokens"])

    else:
        raise ValueError(f"unknown family {fam!r}")

    def init(generator=None, device=None, *, state=None):
        return mod.make_params(cfg, generator, device, state=state)

    def init_cache(batch: int, max_seq: int, device=None):
        return mod.init_cache(cfg, batch, max_seq, device)

    def loss(params, batch, remat: bool = True):
        return mod.loss_fn(cfg, params, batch, remat=remat)

    def input_specs(shape_name: str) -> Dict[str, torch.Tensor]:
        sc = SHAPES[shape_name]
        return _common_specs(cfg, sc, sc.kind)

    return ModelApi(cfg=cfg, init=init,
                    abstract_params=lambda: mod.make_params(cfg, device=META),
                    loss=loss, prefill=prefill, decode_step=decode_step,
                    init_cache=init_cache, input_specs=input_specs)
