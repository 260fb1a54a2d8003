"""Whisper large-v3 — encoder-decoder audio model (transformer backbone only).

[arXiv:2212.04356]. The mel-spectrogram + conv feature extractor is a stub, as
in the reference: ``input_specs`` provides precomputed frame embeddings of
shape (batch, encoder_seq, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                 # decoder layers
    encoder_layers=32,
    encoder_seq=1500,              # 30 s of audio at 50 Hz after conv stride
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,               # MHA (GQA kv=20 == heads)
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    cross_attention=True,
    frontend="audio_frames",
    rope_theta=10_000.0,           # whisper uses learned/sinusoidal; rope stands in
    sub_quadratic=False,
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-smoke",
        num_layers=2,
        encoder_layers=2,
        encoder_seq=64,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        query_chunk=32,
        kv_chunk=32,
    )
