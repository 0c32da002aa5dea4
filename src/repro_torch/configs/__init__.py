"""Config registry: ``get_config("<arch-id>")`` for every ported arch.

The port carries the decoder-only architectures: the all-``attn`` ones,
gemma2's local/global alternation (2b and 27b), the MoE ones with untied
embeddings (mixtral-8x22b, llama4-scout), mamba2-130m's ``ssd`` blocks and
recurrentgemma-9b's ``recurrent`` blocks with their ``tail``.  The others
(whisper's ``dec`` and llama-3.2-vision's ``cross``) arrive with their
block kinds.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = (
    "gemma2_27b",
    "gemma2_2b",
    "smollm_360m",
    "smollm_135m",
    "mixtral_8x22b",
    "llama4_scout_17b_a16e",
    "mamba2_130m",
    "recurrentgemma_9b",
    # paper models
    "mup_gpt",
)

_ALIASES = {
    "gemma2-27b": "gemma2_27b",
    "gemma2-2b": "gemma2_2b",
    "smollm-360m": "smollm_360m",
    "smollm-135m": "smollm_135m",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
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

