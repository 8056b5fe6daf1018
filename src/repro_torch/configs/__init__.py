from repro_torch.configs.base import ArchConfig, InputShape, SHAPES, SHAPE_BY_NAME
from repro_torch.configs.registry import (
    ASSIGNED_ARCHS, get_config, get_shape, list_archs,
)
