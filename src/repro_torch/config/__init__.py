from repro_torch.config.base import (
    MeshConfig,
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
    "MeshConfig",
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
