"""xLSTM-350M — sLSTM + mLSTM recurrent blocks. [arXiv:2405.04517]

xLSTM[7:1] block ratio: one sLSTM block per 8 layers, the rest mLSTM. d_ff=0:
the up/down projections live inside the xLSTM blocks (expand factor 2), no
separate FFN, matching the paper's block design.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple("s" if i % 8 == 4 else "m" for i in range(24))

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    ssm_heads=4,
    ssm_expand=2,
    block_pattern=_PATTERN,
    sub_quadratic=True,
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        ssm_heads=4,
        vocab_size=512,
        block_pattern=("m", "s", "m", "m"),
        query_chunk=32,
        kv_chunk=32,
    )
