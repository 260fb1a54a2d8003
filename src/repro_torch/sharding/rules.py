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

The dry run's layouts (``launch/dryrun.py:67-76, 105-108``): ``"tp"`` keeps
the rules as they are, every weight resident on its model ranks;
``"fsdp"`` (``fsdp_rules``) also splits each weight's ``d_model`` (the
``embed`` axis) over ``data``, and the layers gather it whole per layer;
``"auto"`` (``choose_layout``) takes FSDP where a model-axis shard of the
bf16 parameters would exceed the HBM budget.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

MeshAxes = Optional[Tuple[str, ...]]

LAYOUTS = ("tp", "fsdp", "auto")
#: the families whose layers gather their weights under FSDP
FSDP_FAMILIES = ("dense", "moe", "vlm")


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


def choose_layout(cfg, hbm_budget_gib: float = 6.0) -> str:
    """The dry run's ``"auto"`` layout: ``"tp"`` when a shard of the bf16
    parameters over the production mesh's 16 model ranks fits
    ``hbm_budget_gib``, ``"fsdp"`` otherwise (``launch/dryrun.py:67-76``)."""
    shard_gib = cfg.param_counts()["total"] * 2 / 16 / 2**30
    return "tp" if shard_gib <= hbm_budget_gib else "fsdp"


def resolve_layout(cfg, layout: str) -> str:
    """``layout`` as the rules take it: ``"auto"`` becomes ``choose_layout``'s
    choice; anything but the three layouts raises."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")
    return choose_layout(cfg) if layout == "auto" else layout


def fsdp_rules(rules: Dict[str, MeshAxes]) -> Dict[str, MeshAxes]:
    """``rules`` with every weight's ``d_model`` split over ``data``, as
    the dry run builds its FSDP rules (``launch/dryrun.py:105-108``)."""
    return dict(rules, embed=("data",))


def layout_rules(cfg, rules: Dict[str, MeshAxes], layout: str) -> Dict[str, MeshAxes]:
    """``rules`` laid out for ``cfg`` by ``layout`` (``"tp"``, ``"fsdp"`` or
    ``"auto"``). FSDP is refused for a family whose layers do not gather
    (``FSDP_FAMILIES``): no layout falls back to another."""
    if resolve_layout(cfg, layout) == "tp":
        return rules
    if cfg.family not in FSDP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family has no FSDP layout in the port (its "
            f"layers do not gather their weights over 'data'); use layout='tp'")
    return fsdp_rules(rules)
