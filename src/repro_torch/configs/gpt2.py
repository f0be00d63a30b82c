"""GPT-2 family — the paper's own experimental models (Table 4/5)."""
from repro_torch.configs.base import ModelConfig, register

_SPECS = {
    # name: (layers, heads, d_model)
    "gpt2-60m": (6, 10, 640),
    "gpt2-small": (12, 12, 768),
    "gpt2-200m": (16, 14, 896),
    "gpt2-medium": (24, 16, 1024),
    "gpt2-500m": (28, 18, 1152),
    "gpt2-large": (36, 20, 1280),
    "gpt2-1.3b": (44, 24, 1536),
    "gpt2-xl": (48, 25, 1600),
}

CONFIGS = {}
for _name, (_l, _h, _d) in _SPECS.items():
    CONFIGS[_name] = register(ModelConfig(
        name=_name,
        family="dense",
        num_layers=_l,
        d_model=_d,
        n_heads=_h,
        n_kv_heads=_h,
        d_ff=4 * _d,
        vocab=50304,
        tie_embeddings=True,
        rope_theta=10_000.0,
    ))
