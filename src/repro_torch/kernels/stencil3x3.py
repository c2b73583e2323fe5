"""3x3 stencil: the CUDA kernel ``csrc/stencil3x3.cu`` and its plain version.

Replaces ``repro/kernels/stencil3x3.py::stencil3x3``, HotSpot3D's inner loop
and the GPTPU conv2D instruction at 3x3, stride 1, SAME::

    stencil3x3(x, w)[r, c] = sum_p sum_q w[p, q] * x[r + p - 1, c + q - 1]

``x`` is an (H, W) f32 field (any H, W >= 1) with zeros outside it, ``w`` the
(3, 3) f32 weights; the sum starts from 0 and runs in (p, q) order, one
rounding after each multiply and each add.

On the card each warp walks down a strip of ``rows`` output rows in a band
of 32 x ``width`` columns, the warps of a block in adjacent bands, holding
a 3-row window in registers and taking its neighbour columns from the
adjacent lanes by shuffles and from the adjacent warps through shared
memory (the source's notes say more). :func:`plan` picks the width and
the strip height from the shape, the alignment and the SM count; the warps
per block and the rows in flight are the kernel's constants.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import accounting
from repro_torch.kernels import _build

WARPS = 4           # warps per block (the kernel's WARPS)
ROWS = (4, 2)       # strip heights, tallest first
BLOCKS_PER_SM = 8   # the plan shortens strips until the grid holds this many per SM


class Plan(NamedTuple):
    width: int      # columns per lane: 4 (16-byte accesses) or 1
    rows: int       # output rows per warp (the strip height)

    @property
    def band(self) -> int:
        """Columns per warp."""
        return 32 * self.width

    def blocks(self, H: int, W: int) -> int:
        """Blocks of ``WARPS`` adjacent bands by strips."""
        return -(-W // (WARPS * self.band)) * -(-H // self.rows)


@functools.lru_cache(maxsize=256)
def plan(H: int, W: int, aligned: bool, sms: int) -> Plan:
    """The kernel's launch plan. Width 4 where every row starts on a 16-byte
    boundary (``W % 4 == 0`` and ``aligned``, the base pointer's), else 1.
    The tallest strip in ``ROWS`` whose grid reaches ``BLOCKS_PER_SM``
    blocks per SM, else the shortest. It reads the shape, the alignment and
    the SM count only."""
    width = 4 if W % 4 == 0 and aligned else 1
    for rows in ROWS:
        p = Plan(width, rows)
        if p.blocks(H, W) >= BLOCKS_PER_SM * sms:
            return p
    return p


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    launch the kernel on the current stream; meta tensors launch nothing
    (the call is recorded with the accounting context either way: 18 FLOPs
    a cell, a convolution's count)."""
    _check(x, w)
    H, W = x.shape
    with accounting.kernel("stencil3x3", 18 * H * W, 8 * H * W + 36):
        if x.device.type == "cpu":
            return stencil3x3_plain(x, w)
        if x.device.type == "meta":
            return torch.empty((H, W), dtype=torch.float32, device=x.device)
        if x.device.type != "cuda":
            raise ValueError(f"stencil3x3: unsupported device {x.device}")
        p = plan(H, W, x.data_ptr() % 16 == 0, _sm_count(x.device.index))
        out = torch.empty((H, W), dtype=torch.float32, device=x.device)
        lib = _build.library("stencil3x3")
        err = lib.stencil3x3_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), H, W,
                                    p.width, p.rows,
                                    torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "stencil3x3")
        stencil3x3.launches += 1
        return out


stencil3x3.launches = 0
