"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1, early-fusion multimodal.

[hf:meta-llama/Llama-4-Scout-17B-16E]. Early fusion: image patch embeddings are
interleaved into the token stream (vision encoder stubbed per the carve-out).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    frontend="vision_patches",     # early fusion: patch embeds join the stream
    num_patches=256,
    sub_quadratic=False,           # full-attention config here
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="llama4-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        experts_per_token=1,
        num_patches=8,
        query_chunk=32,
        kv_chunk=32,
    )
