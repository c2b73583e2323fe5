"""Config registry: one module per ported architecture."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig  # noqa: F401

ARCH_IDS: List[str] = [
    "tinyllama_1_1b",
]


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(
            f"arch {arch!r} is not ported yet (ported: {ARCH_IDS}); the other "
            f"families are listed in ROADMAP.md queue 1")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
