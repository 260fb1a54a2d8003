"""DeepSeek 67B — dense llama-architecture decoder. [arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
    sub_quadratic=False,
    source="arXiv:2401.02954",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-smoke",
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
