"""Architecture config registry of the port.

``get_config("llama-8b")`` returns the full config;
``get_smoke_config("llama-8b")`` the reduced same-family variant. Every
architecture of the reference is listed (dense, vlm, ssm, moe, hybrid and
audio); asking for another one raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      MoEConfig, SSMConfig)

# arch id -> module name
_ARCH_MODULES = {
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "yi-34b": "yi_34b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-base": "whisper_base",
    "internvl2-2b": "internvl2_2b",
    "llama-8b": "llama_8b",
    "llama-70b": "llama_70b",
}

# the reference's assigned architectures, in its order
ASSIGNED_ARCHS: List[str] = [
    "olmo-1b", "granite-8b", "zamba2-2.7b", "phi3-mini-3.8b", "yi-34b",
    "mamba2-1.3b", "qwen2-moe-a2.7b", "deepseek-moe-16b", "whisper-base",
    "internvl2-2b"]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs() -> List[str]:
    return list(ASSIGNED_ARCHS)


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "InputShape", "INPUT_SHAPES",
    "ASSIGNED_ARCHS", "get_config", "get_smoke_config", "list_archs",
]
