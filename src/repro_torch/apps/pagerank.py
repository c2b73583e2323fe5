"""PageRank (paper §7.2.1): the power method, one FullyConnected (mat-vec)
per iteration on the quantized adjacency matrix."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core import instr as I

DAMPING = 0.85
ITERS = 20


def _graph(n: int, rng) -> np.ndarray:
    """Column-stochastic adjacency of a random sparse-ish graph."""
    deg = 8
    M = np.zeros((n, n), np.float32)
    for j in range(n):
        targets = rng.choice(n, size=min(deg, n), replace=False)
        M[targets, j] = 1.0
    M /= np.maximum(M.sum(axis=0, keepdims=True), 1.0)
    return M


@register("pagerank")
def run(n: int, quantized: bool = True, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    M = _graph(n, rng)
    r = np.full((n,), 1.0 / n, np.float32)
    fc = I.fully_connected_quant if quantized else I.fully_connected_fp
    Mt = torch.from_numpy(np.ascontiguousarray(M.T)).to(dev)  # FullyConnected is v @ W
    rv = torch.from_numpy(r).to(dev)
    for _ in range(ITERS):
        rv = DAMPING * fc(rv, Mt) + (1 - DAMPING) / n
        rv = rv / torch.sum(rv)

    def ref():
        rr = np.full((n,), 1.0 / n, np.float64)
        Md = M.astype(np.float64)
        for _ in range(ITERS):
            rr = DAMPING * (Md @ rr) + (1 - DAMPING) / n
            rr = rr / rr.sum()
        return rr

    return rv.cpu().numpy(), ref
