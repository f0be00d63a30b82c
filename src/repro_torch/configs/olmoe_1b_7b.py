"""OLMoE-1B-7B — MoE, 64 experts top-8. [arXiv:2409.02060]"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    default_ffn="moe",
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024, num_shared=0),
))
