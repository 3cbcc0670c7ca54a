"""Assigned architecture configs (``--arch <id>``) + reduced smoke variants.

Copies of ``repro.configs``. Each module defines ``CONFIG`` (the exact
assigned configuration, with the source citation) and ``smoke_config()``
(2 layers, d_model ≤ 512, ≤ 4 experts — runnable on CPU).
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCH_IDS = (
    "mamba2_1p3b",
    "llama_3_2_vision_11b",
    "phi4_mini_3p8b",
    "olmoe_1b_7b",
    "kimi_k2_1t_a32b",
    "qwen2_5_32b",
    "minitron_4b",
    "qwen3_14b",
    "jamba_1_5_large_398b",
    "whisper_medium",
)

# public --arch ids (dashes) -> module names
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2.5-32b": "qwen2_5_32b",
    "minitron-4b": "minitron_4b",
    "qwen3-14b": "qwen3_14b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-medium": "whisper_medium",
}


def _module(arch: str):
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__name__}.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ALIASES}
