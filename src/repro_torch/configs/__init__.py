"""Architecture config registry (``--arch <id>``).

A copy of the JAX package's registry: the config files beside this one,
and the shape table, are data only and equal to the JAX package's."""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig
from .shapes import SHAPES, ShapeSpec, applicable

_MODULES = {
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "gemma3-27b": "gemma3_27b",
    "deepseek-7b": "deepseek_7b",
    "granite-34b": "granite_34b",
    "whisper-medium": "whisper_medium",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2p7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCHS = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "applicable", "get_config",
           "get_smoke"]
