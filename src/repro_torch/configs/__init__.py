"""Architecture registry: ``--arch <id>`` resolution. It holds the one
LM the port serves so far and the paper's two CNNs."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs import cnn
from repro_torch.configs.base import CNNConfig, ModelConfig

ARCH_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
}


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_cnn_config(arch: str) -> CNNConfig:
    return cnn.config(arch)


__all__ = ["CNNConfig", "ModelConfig", "get_config", "get_smoke_config",
           "get_cnn_config"]
