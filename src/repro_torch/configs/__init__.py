"""Config registry: ``get_config("<arch-id>")`` for every ported arch.

The port carries the dense all-``attn`` architectures; the others arrive
with their block kinds.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = (
    "smollm_360m",
    "smollm_135m",
    # paper models
    "mup_gpt",
)

_ALIASES = {
    "smollm-360m": "smollm_360m",
    "smollm-135m": "smollm_135m",
    "mup-gpt": "mup_gpt",
}


def _module(arch: str):
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg: ModelConfig = _module(arch).CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg: ModelConfig = _module(arch).SMOKE
    return cfg.replace(**overrides) if overrides else cfg

