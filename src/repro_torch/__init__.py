"""PyTorch/CUDA port of ``repro``: its serving system, and the GPTPU library
(Tensorizer, instruction set, tpuGemm) with the paper's applications.

The package mirrors ``repro``'s module names (apps, configs, core, kernels,
models, serving, launch) so each port module sits where its counterpart does. It
imports ``torch`` and ``numpy`` only. Entry points run on the CUDA card unless
the caller asks for the CPU (``device="cpu"``), which is how the tests run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA device requested where none is present raises instead of
    carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA card is available; pass "
            f"device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
