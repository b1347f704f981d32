"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

import importlib

from .base import ModelConfig, reduce_for_smoke

# assigned pool (10) + the paper's own model
ARCH_IDS = (
    "llama1_7b",
    "zamba2_1p2b",
    "seamless_m4t_medium",
    "glm4_9b",
    "qwen3_32b",
    "qwen2_1p5b",
    "granite_8b",
    "phi3_vision_4p2b",
    "rwkv6_7b",
    "deepseek_v2_236b",
    "qwen3_moe_30b_a3b",
)

_ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "glm4-9b": "glm4_9b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-1.5b": "qwen2_1p5b",
    "granite-8b": "granite_8b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "rwkv6-7b": "rwkv6_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama1-7b": "llama1_7b",
}


def _resolve(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{_resolve(name)}", __package__)
    return mod.config()


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{_resolve(name)}", __package__)
    if hasattr(mod, "smoke_config"):
        return mod.smoke_config()
    return reduce_for_smoke(mod.config())
