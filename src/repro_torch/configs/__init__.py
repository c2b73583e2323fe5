"""Config registry: one module per ported architecture."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig  # noqa: F401

ARCH_IDS: List[str] = [
    "moonshot_v1_16b_a3b",
    "deepseek_moe_16b",
    "granite_20b",
    "qwen3_14b",
    "starcoder2_15b",
    "tinyllama_1_1b",
    "zamba2_7b",
]


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        # xlstm-125m, seamless-m4t-medium and qwen2-vl-2b: the ssm family,
        # encdec and vlm
        raise ValueError(
            f"arch {arch!r} is not ported yet (ported: {ARCH_IDS}); the other "
            f"families are ROADMAP.md queue 1 item 11")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
