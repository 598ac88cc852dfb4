from repro_torch.config.base import (
    ModelConfig,
    MoEConfig,
    NSAConfig,
    RecurrentConfig,
    ServeConfig,
    SSVConfig,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "NSAConfig",
    "RecurrentConfig",
    "ServeConfig",
    "SSVConfig",
]
