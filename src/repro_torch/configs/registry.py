"""Architecture registry of the port: the two dense GQA decoders its paged
engine serves. get_config("<id>") / list_archs()."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "smollm-360m": "smollm_360m",
    "edge-6b": "edge_6b",
}


def list_archs():
    return tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
