"""LLaMA family at paper scales (Table 8)."""
from repro_torch.configs.base import ModelConfig, register

_SPECS = {
    # name: (hidden, intermediate, heads, blocks)
    "llama-60m": (512, 1376, 8, 8),
    "llama-130m": (768, 2048, 12, 12),
    "llama-350m": (1024, 2736, 16, 24),
    "llama-1b": (2048, 5461, 32, 24),
}

CONFIGS = {}
for _name, (_d, _ff, _h, _l) in _SPECS.items():
    CONFIGS[_name] = register(ModelConfig(
        name=_name,
        family="dense",
        num_layers=_l,
        d_model=_d,
        n_heads=_h,
        n_kv_heads=_h,
        d_ff=_ff,
        vocab=32000,
    ))
