"""Mistral Large 123B — dense decoder. [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    sub_quadratic=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mistral-large-smoke",
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
