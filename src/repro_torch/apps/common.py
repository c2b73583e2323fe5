"""Shared app scaffolding and the paper's error metrics."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import numpy as np

from repro_torch import resolve_device

ALL: Dict[str, Callable] = {}


@dataclasses.dataclass
class AppResult:
    name: str
    n: int
    mape_pct: float
    rmse_pct: float
    t_gptpu_s: float
    t_ref_s: float


def mape(out: np.ndarray, ref: np.ndarray, rel_floor: float = 1e-3) -> float:
    """Mean absolute percentage error (paper Table 4a), in percent.

    Reference entries below ``rel_floor`` x the largest are left out: a
    percentage of a near-zero denominator measures the metric, not the
    computation (LUD and GEMM have exact zeros in the reference)."""
    thresh = rel_floor * max(float(np.max(np.abs(ref))), 1e-12)
    mask = np.abs(ref) >= thresh
    if not mask.any():
        return 0.0
    return float(np.mean(np.abs(out[mask] - ref[mask]) / np.abs(ref[mask])) * 100.0)


def rmse_pct(out: np.ndarray, ref: np.ndarray) -> float:
    """Range-normalized RMSE (paper Table 4b), in percent."""
    rng = max(float(ref.max() - ref.min()), 1e-9)
    return float(np.sqrt(np.mean((out - ref) ** 2)) / rng * 100.0)


def register(name: str):
    def deco(fn):
        ALL[name] = fn
        return fn
    return deco


def run_app(name: str, n: int = 256, quantized: bool = True, device=None) -> AppResult:
    """Run app ``name`` at size ``n`` on ``device`` (the card unless the
    caller says ``"cpu"``) and score it against its fp64 reference.
    ``t_gptpu_s`` is host wall time and includes kernel builds on first use."""
    dev = resolve_device(device)
    fn = ALL[name]
    t0 = time.perf_counter()
    out, ref_fn = fn(n, quantized=quantized, device=dev)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = ref_fn()
    t_r = time.perf_counter() - t0
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return AppResult(name=name, n=n, mape_pct=mape(out, ref),
                     rmse_pct=rmse_pct(out, ref), t_gptpu_s=t_g, t_ref_s=t_r)
