"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

38 Mamba2 layers with a single *shared* attention+MLP block applied every 6
layers (zamba2's shared-transformer design: one set of attention weights reused
at each insertion point).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=64,                  # expand*d_model / head_dim(64) = 4096/64
    ssm_expand=2,
    attn_every=6,
    sub_quadratic=True,
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-smoke",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_heads=8,
        attn_every=2,
        query_chunk=32,
        kv_chunk=32,
    )
