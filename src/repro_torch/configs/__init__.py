"""Config registry: ``get_config(arch_id)`` -> (CONFIG, SMOKE)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "zamba2_7b",
    "qwen3_8b",
    "seamless_m4t_medium",
    "llama_3_2_vision_90b",
    "granite_34b",
    "qwen2_0_5b",
    "llama4_scout_17b_a16e",
    "mixtral_8x22b",
    "mamba2_130m",
    "mistral_large_123b",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def canonical(arch: str) -> str:
    a = arch.replace(".", "_")
    return _ALIAS.get(a, a.replace("-", "_"))


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_smoke(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
