"""Configuration, stdlib only: port of ``repro/configs/base.py``.

``ModelConfig`` (one architecture; field for field, with ``param_counts``),
``ShapeConfig`` and ``SHAPES`` (the four assigned input shapes) and
``FedConfig`` (paper Algorithm 1) keep the reference's fields, defaults
and construction-time validation. The registry (``get_config``,
``get_smoke_config``, ``ARCH_IDS``, ``all_arch_ids``) covers every
architecture of the reference, in its order; an unknown name raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    source: str = ""                 # citation for the configuration

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_token_chunk: int = 0         # >0: scan dispatch in token chunks (§Perf)

    # --- attention details ---
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 -> full causal attention

    # --- SSM / recurrent ---
    ssm_state: int = 0               # Mamba2 state dim per head
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    block_pattern: Tuple[str, ...] = ()   # xLSTM: e.g. ('m','m','s',...)

    # --- hybrid (zamba2-style) ---
    attn_every: int = 0              # shared attention block every k SSM layers

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder length (1500 for whisper)
    cross_attention: bool = False

    # --- modality frontend carve-out ---
    frontend: str = "none"           # none | audio_frames | vision_patches
    num_patches: int = 0             # VLM: patch embeddings provided per example
    mrope: bool = False              # qwen2-vl multi-dimensional RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # eligibility for the long_500k decode shape (sub-quadratic path exists)
    sub_quadratic: bool = False

    # attention implementation: "mea" (chunked online softmax; on the card the
    # K3 flash_attention kernel). The reference's "naive" is not a path of the
    # port: the transformer raises on it (layers.naive_attention stays as a
    # plain function)
    attn_impl: str = "mea"
    query_chunk: int = 1024
    kv_chunk: int = 1024
    # two-level remat: scan G groups of L/G layers, checkpointing both levels.
    # Residual memory ~ (G + L/G) * activation instead of L * activation.
    remat_groups: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.family not in ("ssm",) or any(b == "a" for b in self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter counting (used for MODEL_FLOPS = 6*N*D roofline term)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts by group: total and active-per-token."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d            # wq, wk, wv, wo
        if self.family == "ssm":
            attn = 0
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        if self.is_moe:
            ffn_one = 3 * d * ff                     # gated mlp
            ffn_total = self.num_experts * ffn_one + d * self.num_experts  # + router
            ffn_active = self.experts_per_token * ffn_one + d * self.num_experts
        else:
            ffn_total = ffn_active = 3 * d * ff if ff > 0 else 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            e = self.ssm_expand
            n = max(self.ssm_state, 1)
            h = self.ssm_heads or max(1, (e * d) // 64)
            # in_proj (z,x,B,C,dt) + conv + out_proj, mamba2-style
            ssm = d * (2 * e * d + 2 * n * h + h) + e * d * self.ssm_conv_width + e * d * d
        per_layer_total = attn + ffn_total + ssm + 2 * d
        per_layer_active = attn + ffn_active + ssm + 2 * d
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * d + 3 * d * ff + 2 * d)
        total = emb + head + L * per_layer_total + enc
        active = emb + head + L * per_layer_active + enc
        return {
            "embedding": emb,
            "lm_head": head,
            "per_layer_total": per_layer_total,
            "per_layer_active": per_layer_active,
            "encoder": enc,
            "total": total,
            "active": active,
        }


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Federated configuration (paper Algorithm 1)
# ---------------------------------------------------------------------------


#: server-side algorithms
SERVER_ALGORITHMS = ("fedavg", "fedprox", "scaffold", "fedadam", "fedsubavg",
                     "central")
#: heat estimators (paper App. F)
HEAT_ESTIMATORS = ("exact", "secure_agg", "randomized_response")
#: sparse local-training replica layouts (see ``FedConfig.sparse_local``)
SPARSE_LOCAL_MODES = ("auto", "replicated", "sparse_replicated")


@dataclass(frozen=True)
class FedConfig:
    num_clients: int = 100           # N
    clients_per_round: int = 10      # K
    local_iters: int = 1             # I
    local_batch: int = 8
    microbatches: int = 1            # grad-accumulation steps per round (fedsgd)
    lr: float = 0.1                  # gamma
    server_lr: float = 1.0
    algorithm: str = "fedsubavg"     # fedavg|fedprox|scaffold|fedadam|fedsubavg|central
    prox_mu: float = 0.01            # FedProx proximal coefficient
    server_beta1: float = 0.9        # FedAdam
    server_beta2: float = 0.99
    server_eps: float = 1e-3
    weighted: bool = False           # App. D.4 weighted generalisation
    heat_estimator: str = "exact"    # exact | secure_agg | randomized_response
    rr_flip_prob: float = 0.1        # randomized-response flip probability
    seed: int = 0

    # --- sparse submodel update plane (repro_torch.sparse) ---
    sparse: bool = False             # row-sparse client deltas + sparse server agg
    sparse_topk: int = 0             # >0: per-client top-k row sparsification
    sparse_int8: bool = False        # int8 stochastic-rounding row payloads
    # "sparse_replicated": each client's replica is its gathered submodel;
    # "replicated": K dense replicas; "auto": sparse_replicated whenever the
    # model's axis-0 feature tables span the dataset's id space
    sparse_local: str = "auto"

    def __post_init__(self):
        if self.algorithm not in SERVER_ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}: expected one of "
                f"{SERVER_ALGORITHMS}")
        if self.heat_estimator not in HEAT_ESTIMATORS:
            raise ValueError(
                f"unknown heat_estimator {self.heat_estimator!r}: expected "
                f"one of {HEAT_ESTIMATORS}")
        if self.sparse_local not in SPARSE_LOCAL_MODES:
            raise ValueError(
                f"unknown sparse_local mode {self.sparse_local!r}: expected "
                f"one of {SPARSE_LOCAL_MODES}")
        if self.sparse_topk < 0:
            raise ValueError(
                f"sparse_topk must be >= 0 (0 disables top-k), got "
                f"{self.sparse_topk}")
        if self.microbatches > 1 and self.sparse:
            raise ValueError(
                "microbatches > 1 does not compose with sparse=True: the "
                "sparse plane computes one fused cohort gradient per round; "
                "set microbatches=1 or sparse=False")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

#: architectures the port runs: the reference's ten, in its order
ARCH_IDS = (
    "mixtral_8x22b",
    "whisper_large_v3",
    "llama4_maverick_400b_a17b",
    "mistral_large_123b",
    "qwen3_32b",
    "qwen2_5_14b",
    "zamba2_1_2b",
    "qwen2_vl_7b",
    "deepseek_67b",
    "xlstm_350m",
)


def _canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = _canon(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r} (registered: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def all_arch_ids():
    return ARCH_IDS
