from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    cut_layers,
    get_config,
    list_configs,
    register,
    shape_applicable,
)
