"""The public kernel entries of ``repro/kernels/ops.py``, under the same
names and positional contracts, each a thin call into a kernel module.

JAX's ``interpret=`` and the Pallas block sizes (``bk``, ``bm``, ``bn``)
have no counterpart: the tensors' device decides. CPU tensors take the
plain versions; CUDA tensors launch the hand-written kernels, once per call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref  # noqa: F401  (re-exported, as in repro)
from repro_torch.kernels.qdot_serve import qgemv
from repro_torch.kernels.qgemm import qgemm, qgemm_tiles
from repro_torch.kernels.stencil3x3 import stencil3x3

__all__ = ["qgemm_f32", "qgemm_tiles", "qgemm_i32", "stencil", "qgemv", "ref"]


def qgemm_f32(a_q: torch.Tensor, b_q: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 -> (M,N) f32 with per-channel dequant."""
    return qgemm(a_q, b_q, sb)


def qgemm_i32(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product as f32: ``qgemm`` with unit scales."""
    return qgemm(a_q, b_q, torch.ones(b_q.shape[1], dtype=torch.float32, device=b_q.device))


def stencil(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 cross-correlation of an (H, W) f32 field."""
    return stencil3x3(x, w)
