"""Architecture registry: one module per assigned architecture.

``get(name)`` returns the full ModelConfig; ``registry()`` lists all ids.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_ARCH_IDS: List[str] = [
    "gemma_2b",
    "codeqwen15_7b",
    "h2o_danube3_4b",
    "qwen3_8b",
    "phi35_moe",
    "deepseek_v3",
    "musicgen_large",
    "mamba2_130m",
    "qwen2_vl_72b",
    "jamba15_large",
]

_ALIASES = {
    "gemma-2b": "gemma_2b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen3-8b": "qwen3_8b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "deepseek-v3-671b": "deepseek_v3",
    "musicgen-large": "musicgen_large",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-1.5-large-398b": "jamba15_large",
}


def get(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def registry() -> List[str]:
    return list(_ARCH_IDS)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in _ARCH_IDS}


# which shape cells apply per arch (per DESIGN.md §Arch-applicability):
# long_500k only for sub-quadratic decode (ssm / hybrid / sliding-window)
LONG_CONTEXT_ARCHS = {"mamba2_130m", "jamba15_large", "h2o_danube3_4b"}


def shapes_for(arch: str) -> List[str]:
    arch = _ALIASES.get(arch, arch)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        shapes.append("long_500k")
    return shapes
