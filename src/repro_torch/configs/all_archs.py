"""Import every config module so the registry is populated (the port's copy
of ``repro.configs.all_archs``), and the architectures assigned to this
reproduction, in the JAX package's order."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_lite_16b,
    gpt2,
    jamba_v0_1_52b,
    llama_small,
    minicpm3_4b,
    musicgen_large,
    olmoe_1b_7b,
    paligemma_3b,
    phi3_mini_3_8b,
    qwen3_4b,
    xlstm_350m,
    yi_9b,
)

ASSIGNED = [
    "minicpm3-4b",
    "phi3-mini-3.8b",
    "qwen3-4b",
    "yi-9b",
    "xlstm-350m",
    "olmoe-1b-7b",
    "deepseek-v2-lite-16b",
    "jamba-v0.1-52b",
    "paligemma-3b",
    "musicgen-large",
]
