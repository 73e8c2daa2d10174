"""Architecture registry: ``--arch <id>`` resolution. It holds the JAX
package's ten LMs (the dense GQA family, the MoE family, the hybrid
family, the xLSTM family and the two frontend configs) and the paper's two
CNNs."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs import cnn
from repro_torch.configs.base import (LM_SHAPES, CNNConfig, FrontendConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, XLSTMConfig, get_shape,
                                      shape_applicable)

ARCH_MODULES: Dict[str, str] = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "arctic-480b": "arctic_480b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "musicgen-medium": "musicgen_medium",
    "stablelm-1.6b": "stablelm_1_6b",
    "command-r-35b": "command_r_35b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-8b": "granite_3_8b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def list_archs() -> List[str]:
    return list(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_cnn_config(arch: str) -> CNNConfig:
    return cnn.config(arch)


__all__ = ["CNNConfig", "FrontendConfig", "LM_SHAPES", "ModelConfig",
           "MoEConfig", "SSMConfig", "ShapeConfig", "XLSTMConfig",
           "get_cnn_config", "get_config", "get_shape", "get_smoke_config",
           "list_archs", "shape_applicable"]
