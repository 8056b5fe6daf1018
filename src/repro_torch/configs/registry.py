"""Architecture registry of the port: every architecture of the JAX
package's registry (``repro.configs.registry``), configs copied with their
imports changed. get_config("<id>") / list_archs()."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "internvl2-26b": "internvl2_26b",
    "hymba-1.5b": "hymba_1p5b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "smollm-360m": "smollm_360m",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
    "yi-6b": "yi_6b",
    "minicpm-2b": "minicpm_2b",
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
