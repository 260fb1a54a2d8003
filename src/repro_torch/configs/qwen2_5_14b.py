"""Qwen2.5-14B — dense decoder with GQA and QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    sub_quadratic=False,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2.5-smoke",
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
