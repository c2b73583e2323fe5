"""LU decomposition (paper §7.2.3): the recursive block algorithm via crop /
tpuGemm: the O(n^3) Schur-complement update runs on tpuGemm, the
triangular solves stay on the host (the paper's CPU/TPU split).

Input: diagonally dominant small-integer matrices (quantization-lossless for
the dominant range, as the paper's measured 0.00% LUD error)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core.gemm import tpu_gemm

BLOCK = 32


def _lu_base(A: np.ndarray):
    """Doolittle LU (no pivoting) for the base block."""
    n = A.shape[0]
    L = np.eye(n, dtype=np.float64)
    U = A.astype(np.float64).copy()
    for k in range(n - 1):
        L[k + 1:, k] = U[k + 1:, k] / U[k, k]
        U[k + 1:, k:] -= np.outer(L[k + 1:, k], U[k, k:])
        U[k + 1:, k] = 0.0
    return L, U


def _lu_block(A: np.ndarray, quantized: bool, dev: torch.device):
    n = A.shape[0]
    if n <= BLOCK:
        return _lu_base(A)
    h = n // 2
    A11, A12 = A[:h, :h], A[:h, h:]        # the paper's `crop`
    A21, A22 = A[h:, :h], A[h:, h:]
    L11, U11 = _lu_block(A11, quantized, dev)
    U12 = np.linalg.solve(L11, A12)                        # host triangular solve
    L21 = np.linalg.solve(U11.T, A21.T).T
    if quantized:
        prod = tpu_gemm(torch.from_numpy(L21.astype(np.float32)).to(dev),
                        torch.from_numpy(U12.astype(np.float32)).to(dev))
        prod = prod.cpu().numpy().astype(np.float64)
    else:
        prod = L21 @ U12
    S = A22 - prod                                          # Schur complement
    L22, U22 = _lu_block(S, quantized, dev)
    L = np.block([[L11, np.zeros((h, n - h))], [L21, L22]])
    U = np.block([[U11, U12], [np.zeros((n - h, h)), U22]])
    return L, U


@register("lud")
def run(n: int, quantized: bool = True, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    A = rng.integers(-8, 9, (n, n)).astype(np.float64)
    A += np.eye(n) * 8.0 * n               # diagonal dominance (no pivoting)
    L, U = _lu_block(A, quantized, dev)
    out = L @ U                            # validate the factorization

    def ref():
        return A

    return out, ref
