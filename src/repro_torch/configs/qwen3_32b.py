"""Qwen3-32B — dense decoder with QK-norm and GQA. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,                  # explicit head_dim (qwen3 style, != d_model/heads)
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    sub_quadratic=False,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        query_chunk=32,
        kv_chunk=32,
    )
