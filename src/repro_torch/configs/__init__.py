from repro_torch.configs.base import (
    ADMISSIONS,
    ARCH_IDS,
    KERNEL_BACKENDS,
    FLConfig,
    ModelConfig,
    NOMAConfig,
    SHAPES,
    ShapeConfig,
    all_configs,
    canon,
    get_config,
)

__all__ = [
    "ADMISSIONS",
    "ARCH_IDS",
    "KERNEL_BACKENDS",
    "FLConfig",
    "ModelConfig",
    "NOMAConfig",
    "SHAPES",
    "ShapeConfig",
    "all_configs",
    "canon",
    "get_config",
]
