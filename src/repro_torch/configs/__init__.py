from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    ArchConfig,
    MoEConfig,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    shapes_for,
    smoke_config,
)
