"""Logical axis -> mesh axis rules per workload kind: port of
``repro/sharding/rules.py`` (plain dicts, copied as they are).

Baseline layout (single pod, mesh ("data","model"); multi-pod prepends "pod"):

    batch/clients   -> ("pod","data")     cohort / request parallelism
    vocab rows      -> "model"            the paper's huge embedding layer
    ffn hidden      -> "model"            Megatron-style MLP TP
    fused q heads   -> "model"
    fused kv dim    -> "model"
    experts         -> None (TP baseline) | "model" (expert-parallel variant)
    kv cache seq    -> "model" (decode)   flash-decode seq sharding
    everything else -> replicated

``complete_rules`` adds what the reference's dry run sets per architecture
(``launch/dryrun.py:110-115``): the attention activations' head axes, only
where the head counts divide the model axis. ``param_rules`` is the port's
own: the rules its parameters are split by, which keep whole heads on each
rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

MeshAxes = Optional[Tuple[str, ...]]


def make_rules(kind: str, multi_pod: bool = False, expert_parallel: bool = False,
               seq_shard_decode: bool = True) -> Dict[str, MeshAxes]:
    batch = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, MeshAxes] = {
        "batch": batch,
        "clients": batch,
        "vocab": ("model",),
        # expert parallelism moves the model axis to the expert dim; each
        # expert's FFN then lives intact on one shard group
        "ffn": None if expert_parallel else ("model",),
        "heads": ("model",),       # fused H*head_dim projection columns
        "kv": ("model",),          # fused KV*head_dim projection columns
        "embed": None,
        "layers": None,
        "state": None,
        "conv": None,
        "experts": ("model",) if expert_parallel else None,
        # attention activation head axes: set per arch by complete_rules
        "heads_act": None,
        "kv_act": None,
        "seq": None,
        "kv_seq": ("model",) if (kind in ("decode", "prefill") and seq_shard_decode) else None,
        "kv_heads": None,           # cache head axis
    }
    return rules


TRAIN_RULES = make_rules("train")
DECODE_RULES = make_rules("decode")


def complete_rules(cfg, rules: Dict[str, MeshAxes], model_size: int) -> Dict[str, MeshAxes]:
    """``rules`` with ``heads_act`` and ``kv_act`` set to the model axis
    where ``cfg``'s head counts divide ``model_size``, as the reference's
    dry run sets them: query heads when ``num_heads`` divides, KV heads
    when ``num_kv_heads`` divides as well."""
    heads = cfg.num_heads % model_size == 0
    return dict(rules,
                heads_act=("model",) if heads else None,
                kv_act=("model",) if heads and cfg.num_kv_heads % model_size == 0 else None)


def param_rules(rules: Dict[str, MeshAxes]) -> Dict[str, MeshAxes]:
    """The rules the port splits parameters by: ``rules`` with the fused
    ``heads`` and ``kv`` projection columns split only where their
    activations are (``heads_act``, ``kv_act``), so that a rank holds
    whole heads. Where the reference splits a partial head's columns,
    GSPMD gathers them again before attention; the port keeps those
    projections whole on every rank instead, and gets the same numbers."""
    return dict(rules,
                heads=rules.get("heads") if rules.get("heads_act") else None,
                kv=rules.get("kv") if rules.get("kv_act") else None)
