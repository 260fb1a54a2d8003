"""Qwen2-VL-7B — VLM decoder backbone with M-RoPE. [arXiv:2409.12191]

The ViT vision encoder + projector is a STUB per the carve-out: ``input_specs``
provides precomputed patch embeddings (dynamic resolution -> num_patches per
example) plus 3D M-RoPE position ids (temporal, height, width).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # sums to head_dim//2
    frontend="vision_patches",
    num_patches=1024,
    sub_quadratic=False,
    source="arXiv:2409.12191",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        mrope_sections=(4, 6, 6),
        d_ff=256,
        vocab_size=512,
        num_patches=8,
        query_chunk=32,
        kv_chunk=32,
    )
