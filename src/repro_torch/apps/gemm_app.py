"""GEMM (paper §7.1): the tpuGemm library call against an fp64 reference."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core.gemm import tpu_gemm


@register("gemm")
def run(n: int, quantized: bool = True, device=None):
    # positive-range data, as the paper's GEMM evaluation (Fig. 7: "1024x1024
    # matrices with positive integers"); zero-mean data would make MAPE a
    # cancellation metric rather than an accuracy one
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 16.0, (n, n)).astype(np.float32)
    b = rng.uniform(0.0, 16.0, (n, n)).astype(np.float32)
    lowering = None if quantized else "fp32"
    out = tpu_gemm(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                   lowering=lowering)
    return out.cpu().numpy(), lambda: a.astype(np.float64) @ b.astype(np.float64)
