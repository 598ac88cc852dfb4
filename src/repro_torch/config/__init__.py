from repro_torch.config.base import (
    ModelConfig,
    MoEConfig,
    NSAConfig,
    RecurrentConfig,
    ServeConfig,
    SSVConfig,
    TrainConfig,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "NSAConfig",
    "RecurrentConfig",
    "ServeConfig",
    "SSVConfig",
    "TrainConfig",
]
