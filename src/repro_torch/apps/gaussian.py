"""Gaussian elimination (paper §7.2.4): row reduction per pivot, where the
rank-1 update (factor column x pivot row) runs on the pairwise ``mul``
instruction and then ``sub``: the paper's instruction mapping."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core import instr as I


def _eliminate(Ab: torch.Tensor, quantized: bool) -> torch.Tensor:
    n = Ab.shape[0]
    mul = I.mul_quant if quantized else I.mul_fp
    sub = I.sub_quant if quantized else I.sub_fp
    rows = torch.arange(n, device=Ab.device)
    A = Ab
    for k in range(n - 1):
        pivot_row = A[k]                               # (n+1,)
        factors = A[:, k] / A[k, k]                    # (n,)
        factors = factors * (rows > k).to(A.dtype)
        # rank-1 update as pair-wise `mul` of broadcast matrices, then `sub`
        update = mul(factors[:, None].expand(A.shape), pivot_row[None, :].expand(A.shape))
        A = sub(A, update)
    return A


def _banded_integer_system(n: int, rng, band: int = 4):
    """A = L @ U with banded unit-lower L (multipliers in {-1, 0, 1}) and
    small integer U: every elimination multiplier is an exact small integer
    and all intermediates stay integer within +-127, so the int8 pipeline
    with integer-snapped scales runs exactly (the paper's 0.00% row)."""
    L = np.eye(n, dtype=np.float64)
    U = np.zeros((n, n), np.float64)
    for i in range(n):
        lo = max(0, i - band)
        L[i, lo:i] = rng.integers(-1, 2, i - lo)
        U[i, i] = rng.integers(3, 7)
        hi = min(n, i + band)
        U[i, i + 1:hi] = rng.integers(-2, 3, hi - i - 1)
    return L @ U


def _eliminate_np(Ab: np.ndarray) -> np.ndarray:
    A = Ab.astype(np.float64).copy()
    n = A.shape[0]
    for k in range(n - 1):
        factors = A[:, k] / A[k, k]
        factors[:k + 1] = 0.0
        A -= np.outer(factors, A[k])
    return A


@register("gaussian")
def run(n: int, quantized: bool = True, device=None):
    dev = resolve_device(device)
    n = min(n, 96)                                     # host-loop pivots
    rng = np.random.default_rng(0)
    A = _banded_integer_system(n, rng).astype(np.float32)
    # b = A @ x with x in {-1, 0, 1}: the transformed right-hand side is
    # U @ x, bounded and integer all the way through
    x_true = rng.integers(-1, 2, (n,)).astype(np.float32)
    b = (A @ x_true).astype(np.float32)
    Ab = np.concatenate([A, b[:, None]], axis=1)

    # the output is the eliminated (upper-triangular) system, compared with
    # the same elimination in fp64 (the CPU baseline)
    out = _eliminate(torch.from_numpy(Ab).to(dev), quantized).cpu().numpy()

    def ref():
        return _eliminate_np(Ab)

    return out.astype(np.float64), ref
