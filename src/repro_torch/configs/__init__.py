"""Config registry: one module per architecture the port has reached.

``get_config(name)`` returns the full-size config, ``get_smoke(name)`` the
reference's reduced variant of it for CPU tests. Names and aliases are the
reference's; every one of the ten architectures is ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, FedConfig, InputShape,  # noqa: F401
                                      ModelConfig, validate_config)

ARCH_IDS = [
    "llava_next_34b",
    "phi3_mini_3_8b",
    "jamba_1_5_large_398b",
    "minicpm3_4b",
    "qwen2_5_3b",
    "whisper_medium",
    "xlstm_125m",
    "deepseek_moe_16b",
    "granite_moe_3b_a800m",
    "qwen1_5_0_5b",
]

# dashed aliases matching the assignment table
ALIASES = {
    "llava-next-34b": "llava_next_34b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen2.5-3b": "qwen2_5_3b",
    "whisper-medium": "whisper_medium",
    "xlstm-125m": "xlstm_125m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
}

# the dense GQA family, jamba, the MoE archs (granite's GQA, deepseek's
# leading dense layer), minicpm3's MLA, llava's image inputs, xlstm's
# mLSTM / sLSTM blocks and whisper's encoder-decoder: all of ARCH_IDS
PORTED = ("qwen1_5_0_5b", "qwen2_5_3b", "phi3_mini_3_8b",
          "jamba_1_5_large_398b", "granite_moe_3b_a800m", "deepseek_moe_16b",
          "minicpm3_4b", "llava_next_34b", "xlstm_125m", "whisper_medium")


def _module(name: str):
    arch = ALIASES.get(name, name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()
