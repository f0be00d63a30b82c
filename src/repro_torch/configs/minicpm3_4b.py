"""MiniCPM3-4B — dense transformer with MLA. [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    head_dim=96,  # qk_nope(64) + qk_rope(32)
    default_mixer="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
))
