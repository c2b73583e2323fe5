"""Config registry: one module per architecture, the JAX package's ten."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig  # noqa: F401

ARCH_IDS: List[str] = [
    "moonshot_v1_16b_a3b",
    "deepseek_moe_16b",
    "seamless_m4t_medium",
    "qwen2_vl_2b",
    "granite_20b",
    "qwen3_14b",
    "starcoder2_15b",
    "tinyllama_1_1b",
    "zamba2_7b",
    "xlstm_125m",
]


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r} (known: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
