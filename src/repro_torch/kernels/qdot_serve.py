"""Int8-weight GEMV: the CUDA kernel ``csrc/qgemv.cu`` and its plain version.

Replaces ``repro/kernels/qdot_serve.py::qgemv``, the weight-only product of
a decode-shaped batch. Contract::

    qgemv(x, w_q, scale)[b, n] = (sum_k x[b, k] * float(w_q[k, n])) * scale[n]

``x`` is (B, K) f32 with B >= 1, ``w_q`` (K, N) int8 with N a multiple of
256 (the Pallas wrapper's assert), ``scale`` (N,) f32. The sum is finished
before the scale is applied; the order of its additions is the kernel's
own, so the kernel and the plain version agree within f32 rounding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

BN = 256        # N must be a multiple of this (the Pallas kernel's stripe)
TN = 128        # columns per block of the CUDA kernel
KSTEP = 64      # a block's K range is a multiple of 8 warps x 8 rows
BLOCKS_PER_SM = 2   # the plan splits K until the grid holds this many per SM


def qgemv_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the f32 product, then the scale."""
    return (x @ w_q.to(torch.float32)) * scale[None, :]


def plan(B: int, K: int, N: int, sms: int) -> Tuple[int, int, int]:
    """(rows per block, K range per block, splits of K) for the kernel: rows
    of x in chunks of 1, 2, 4 or 8, and K split across blocks until the
    128-wide stripes times the row chunks times the splits reach
    ``BLOCKS_PER_SM`` per SM, or each split holds only ``KSTEP`` rows."""
    rb = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    blocks = (N // TN) * -(-B // rb)
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // blocks), -(-K // KSTEP)))
    kchunk = -(-K // splits)
    kchunk = -(-kchunk // KSTEP) * KSTEP
    return rb, kchunk, -(-K // kchunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, w_q, scale) -> None:
    for name, t, dt in (("x", x, torch.float32), ("w_q", w_q, torch.int8),
                        ("scale", scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"qgemv: {name} must be {dt}, got {t.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"qgemv: expected x (B,K), w_q (K,N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, {tuple(scale.shape)}")
    B, K = x.shape
    K2, N = w_q.shape
    if K != K2 or scale.shape[0] != N or min(B, K, N) < 1:
        raise ValueError(f"qgemv: shape mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} with scale {tuple(scale.shape)}")
    if N % BN:
        raise ValueError(f"qgemv: N = {N} must be a multiple of {BN}")
    if w_q.device != x.device or scale.device != x.device:
        raise ValueError("qgemv: all operands must be on one device")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qgemv: operands must be contiguous")


def qgemv(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    _check(x, w_q, scale)
    if x.device.type == "cpu":
        return qgemv_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"qgemv: unsupported device {x.device}")
    if w_q.data_ptr() % 4:
        raise ValueError("qgemv: w_q must be 4-byte aligned")
    B, K = x.shape
    N = w_q.shape[1]
    rb, kchunk, splits = plan(B, K, N, _sm_count(x.device.index))
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, B, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.library("qgemv")
    err = lib.qgemv_launch(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        B, K, N, rb, kchunk, splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qgemv")
    qgemv.launches += 1
    return out


qgemv.launches = 0
