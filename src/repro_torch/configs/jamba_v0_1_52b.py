"""Jamba-v0.1 (52B) — Mamba+attention 1:7 interleave, MoE every 2nd layer.

[arXiv:2403.19887]  32 layers = 4 groups of 8; within a group the 5th layer
(index 4) is attention, the rest Mamba; odd layers carry MoE FFNs (16e top-2).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig, register

_PATTERN = tuple(
    ("gqa" if i % 8 == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(32)
)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=_PATTERN,
    default_mixer="mamba",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, num_shared=0),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
))
