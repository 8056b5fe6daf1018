from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, list_archs
