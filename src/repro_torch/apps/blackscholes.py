"""Black-Scholes (paper §7.2.6): option pricing where the cumulative normal
distribution is a ninth-degree polynomial evaluated as one FullyConnected
(powers-of-x matrix x coefficient vector): the paper's mapping of a scalar
special function onto the matrix unit."""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core import instr as I
from repro_torch.core import tensorizer as tz

_DEG = 9
# Phi fitted on the normalized basis t = x/4 in [-1, 1]: every power t^i
# stays in [-1, 1], so int8 quantization keeps full resolution on every basis
# column (quantizing raw x^9 ~ 2.6e5 would wipe out the low-order terms).
_xs = np.linspace(-1, 1, 4001)
_phi = 0.5 * (1.0 + np.array([math.erf(4 * t / math.sqrt(2)) for t in _xs]))
_COEF = np.polyfit(_xs, _phi, _DEG)[::-1].astype(np.float32)   # ascending


def _cnd_gptpu(x: torch.Tensor, quantized: bool) -> torch.Tensor:
    t = torch.clamp(x / 4.0, -1.0, 1.0)
    powers = torch.stack([t ** i for i in range(_DEG + 1)], dim=-1)  # (N, 10)
    coef = torch.from_numpy(_COEF).to(x.device)[:, None]
    if quantized:
        # per-column calibration and a second pass on the residual: two int8
        # passes give ~14 bits, the paper's §10 "iteratively computing on
        # different portions of raw input numbers"
        pq = tz.fake_quantize(powers, axis=(0,))
        resid = tz.fake_quantize(powers - pq, axis=(0,))
        out = (pq + resid) @ coef
    else:
        out = I.fully_connected_fp(powers, coef)
    return torch.clamp(out[..., 0], 0.0, 1.0)


def _cnd_ref(x: np.ndarray) -> np.ndarray:
    return np.array([0.5 * (1.0 + math.erf(t / math.sqrt(2))) for t in x])


def _bs_call(S, K, T, r, sigma, cnd):
    d1 = (np.log(S / K) + (r + 0.5 * sigma ** 2) * T) / (sigma * np.sqrt(T))
    d2 = d1 - sigma * np.sqrt(T)
    return S * cnd(d1) - K * np.exp(-r * T) * cnd(d2)


@register("blackscholes")
def run(n: int, quantized: bool = True, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    N = n * n                                  # n is a side length elsewhere
    S = rng.uniform(10, 100, N)
    K = S * rng.uniform(0.7, 1.3, N)           # bounded moneyness
    T = rng.uniform(0.2, 2.0, N)
    r, sigma = 0.05, 0.3

    def cnd(d):
        x = torch.from_numpy(d.astype(np.float32)).to(dev)
        return _cnd_gptpu(x, quantized).cpu().numpy().astype(np.float64)

    out = _bs_call(S, K, T, r, sigma, cnd)

    def ref():
        return _bs_call(S, K, T, r, sigma, _cnd_ref)

    return out, ref
