"""3x3 stencil: the CUDA kernel ``csrc/stencil3x3.cu`` and its plain version.

Replaces ``repro/kernels/stencil3x3.py::stencil3x3``, HotSpot3D's inner loop
and the GPTPU conv2D instruction at 3x3, stride 1, SAME::

    stencil3x3(x, w)[r, c] = sum_p sum_q w[p, q] * x[r + p - 1, c + q - 1]

``x`` is an (H, W) f32 field (any H, W >= 1) with zeros outside it, ``w`` the
(3, 3) f32 weights; the sum starts from 0 and runs in (p, q) order, one
rounding after each multiply and each add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build


def stencil3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the zero-padded field and nine shifted
    multiply-adds in (p, q) order, as ``repro/kernels/ref.py``'s oracle."""
    H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    out = torch.zeros((H, W), dtype=torch.float32, device=x.device)
    for p in range(3):
        for q in range(3):
            out = out + w[p, q] * xp[p:p + H, q:q + W]
    return out


def _check(x, w) -> None:
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"stencil3x3: x and w must be float32, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or min(x.shape) < 1 or tuple(w.shape) != (3, 3):
        raise ValueError(f"stencil3x3: expected x (H, W) and w (3, 3), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("stencil3x3: x and w must be on one device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stencil3x3: operands must be contiguous")


def stencil3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    _check(x, w)
    if x.device.type == "cpu":
        return stencil3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"stencil3x3: unsupported device {x.device}")
    H, W = x.shape
    out = torch.empty((H, W), dtype=torch.float32, device=x.device)
    lib = _build.library("stencil3x3")
    err = lib.stencil3x3_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), H, W,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stencil3x3")
    stencil3x3.launches += 1
    return out


stencil3x3.launches = 0
