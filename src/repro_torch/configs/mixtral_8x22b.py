"""Mixtral 8x22B — MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] (Mixtral of Experts; SWA per the assignment spec, window 4096
as in Mistral-7B from which the architecture descends).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    sub_quadratic=True,            # SWA -> eligible for long_500k
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mixtral-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        sliding_window=32,
        query_chunk=32,
        kv_chunk=32,
    )
