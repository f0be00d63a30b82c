"""DeepSeek-V2-Lite (16B) — MLA kv_lora=512, MoE 64 routed top-6 + 2 shared.

[arXiv:2405.04434]  First layer uses a dense FFN, remaining layers MoE.
(The assignment header reads "MoE 64e top-6"; we use 64 routed experts.)
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

_PATTERN = tuple(
    ("mla", "dense" if i == 0 else "moe") for i in range(27)
)

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,   # dense first-layer FFN width
    vocab=102400,
    head_dim=192,  # nope(128) + rope(64)
    pattern=_PATTERN,
    default_mixer="mla",
    default_ffn="moe",
    mla=MLAConfig(q_lora_rank=None, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
))
