from repro_torch.config.base import (
    ModelConfig,
    MoEConfig,
    NSAConfig,
    RecurrentConfig,
    SHAPES,
    ServeConfig,
    ShapeConfig,
    SSVConfig,
    TrainConfig,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "NSAConfig",
    "RecurrentConfig",
    "SHAPES",
    "ServeConfig",
    "ShapeConfig",
    "SSVConfig",
    "TrainConfig",
]
