"""PaliGemma-3B — gemma decoder backbone; the SigLIP frontend is a STUB: a
batch's ``vision_embeds`` (B, 256, d_model) are precomputed patch embeddings
that take the place of the first 256 token embeddings. [arXiv:2407.07726]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    frontend="vision",
    n_frontend_tokens=256,
    tie_embeddings=True,
))
