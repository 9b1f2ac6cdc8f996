"""Architecture config registry of the port.

``get_config("llama-8b")`` returns the full config;
``get_smoke_config("llama-8b")`` the reduced same-family variant. Only
the architectures whose model family is ported are listed (dense, vlm,
ssm, moe and hybrid); asking for another one of the reference's
architectures (whisper-base, the audio family) raises
``NotImplementedError`` (see ROADMAP.md, Queue A), anything else
``KeyError``.
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
    "internvl2-2b": "internvl2_2b",
    "llama-8b": "llama_8b",
    "llama-70b": "llama_70b",
}

# architectures of the reference package whose families are not ported yet
_NOT_PORTED = ("whisper-base",)

# the reference's assigned architectures that are ported, in its order
ASSIGNED_ARCHS: List[str] = [
    "olmo-1b", "granite-8b", "zamba2-2.7b", "phi3-mini-3.8b", "yi-34b",
    "mamba2-1.3b", "qwen2-moe-a2.7b", "deepseek-moe-16b", "internvl2-2b"]


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet "
            f"(ROADMAP.md, Queue A); ported: {sorted(_ARCH_MODULES)}")
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
