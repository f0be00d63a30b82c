"""xLSTM-350M — alternating sLSTM + mLSTM blocks, no FFN-free variant.

[arXiv:2405.04517]  d_ff=0 in the pool spec => the block itself contains the
up/down projection (proj_factor), so ffn kind is "none".
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

_PATTERN = tuple(
    ("mlstm" if i % 2 == 0 else "slstm", "none") for i in range(24)
)

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=_PATTERN,
    default_mixer="mlstm",
    default_ffn="none",
    ssm=SSMConfig(proj_factor=2.0, chunk_size=128),
))
