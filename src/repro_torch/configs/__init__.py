"""Configurations: the router's (`eagle.py`) and the model registry,
``--arch <id>`` -> ModelConfig (a copy of the JAX package's registry and
its ten data files, so both packages name the same fleet)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduced

_MODULES: Dict[str, str] = {
    "whisper-large-v3": "whisper_large_v3",
    "olmo-1b": "olmo_1b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-8b": "qwen3_8b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "internlm2-20b": "internlm2_20b",
    "gemma3-12b": "gemma3_12b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-7b": "zamba2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced_config(arch: str, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU tests."""
    return reduced(get_config(arch), **overrides)
