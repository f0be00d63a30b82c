"""Qwen3-4B — dense GQA (kv=8) with qk-norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
