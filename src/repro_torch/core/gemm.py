"""tpuGemm, the paper's library GEMM (GPTPU §7.1): the port of
``repro.core.gemm``.

Two lowerings of C = A @ B, as in the paper:

  * ``fully_connected`` — a 128-tile blocked int8 product with per-tile
    scales and wide accumulation (§7.1.1, §6.2.1), on the tile-scales GEMM
    kernel;
  * ``conv2d`` — each row of A reshaped into a ceil(sqrt(K))^2 patch, each
    column of B into a kernel of the same shape, and a convolution whose
    stride equals the patch size (§7.1.2). Quantized, that strided
    convolution is exactly the int8 product of the flattened patches and
    kernels, which runs on the int8 GEMM kernel.

``tpu_gemm(lowering=None)`` takes the lowering with the higher measured
throughput on the operands' device (``instr_select``).
"""

from __future__ import annotations

import math
from typing import Literal, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import instr_select
from repro_torch.core import tensorizer as tz
from repro_torch.core.instr import conv2d_image
from repro_torch.kernels.qgemm import qgemm, qgemm_tiles

Lowering = Literal["fully_connected", "conv2d", "fp32"]


def gemm_fully_connected(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Blocked W8A8 GEMM: A and B are cut into 128x128 tiles, each tile is
    quantized against its own amax, and the per-tile-pair int32 partials are
    scaled and accumulated in f32 over k in the tile-scales kernel."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"gemm_fully_connected: {tuple(a.shape)} @ {tuple(b.shape)}")
    t = tz.MXU_TILE
    at = tz.partition(a.to(torch.float32), t)          # (Mb, Kb, t, t)
    bt = tz.partition(b.to(torch.float32), t)          # (Kb, Nb, t, t)
    sa = tz.amax_calibrate(at, axis=(-1, -2))          # (Mb, Kb, 1, 1)
    sb = tz.amax_calibrate(bt, axis=(-1, -2))          # (Kb, Nb, 1, 1)
    qa = torch.clamp(torch.round(at / sa), -tz.QMAX, tz.QMAX).to(torch.int8)
    qb = torch.clamp(torch.round(bt / sb), -tz.QMAX, tz.QMAX).to(torch.int8)
    return tz.reassemble(qgemm_tiles(qa, sa, qb, sb), M, N)


def _patch_layout(a: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Each row of A (M, K) as an s x s patch, stacked vertically: the
    (M*s, s) image, with K zero-padded to s*s."""
    M, K = a.shape
    s = math.isqrt(K - 1) + 1 if K > 0 else 1     # ceil(sqrt(K))
    ap = F.pad(a, (0, s * s - K))
    return ap.reshape(M * s, s), s, s


def gemm_conv2d(a: torch.Tensor, b: torch.Tensor, *, quantized: bool = True) -> torch.Tensor:
    """GEMM lowered onto a strided conv2D: stride (s, s) walks the patch
    grid, so each output element is exactly one GEMM dot product (Eq. 9).

    Quantized (per-tensor scales on the image and the kernels), the strided
    convolution over int8 codes equals ``qi.q.reshape(M, s*s) @
    qk.q.reshape(s*s, N)`` in int32; it runs on the qgemm kernel with the
    scale ``qi.scale * qk.scale`` in its epilogue, one rounding, as the JAX
    package's ``float(acc) * (qi.scale * qk.scale)``."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"gemm_conv2d: {tuple(a.shape)} @ {tuple(b.shape)}")
    img, sx, sy = _patch_layout(a)                              # (M*sx, sy)
    kern = F.pad(b, (0, 0, 0, sx * sy - K)).reshape(sx, sy, N)
    if not quantized:
        return conv2d_image(img, kern, stride=(sx, sy), padding="VALID")[:, 0, :]
    qi, qk = tz.quantize(img), tz.quantize(kern)
    scale = (qi.scale * qk.scale).reshape(1).expand(N).contiguous()
    return qgemm(qi.q.reshape(M, sx * sy), qk.q.reshape(sx * sy, N), scale)


def tpu_gemm(a: torch.Tensor, b: torch.Tensor,
             lowering: Optional[Lowering] = None) -> torch.Tensor:
    """The library GEMM (the paper's ``tpuGemm``) on the operands' device.
    ``lowering=None`` consults the measured cost table of that device."""
    if lowering is None:
        lowering = instr_select.best_gemm_lowering(a.device)
    if lowering == "fp32":
        return a.to(torch.float32) @ b.to(torch.float32)
    if lowering == "conv2d":
        return gemm_conv2d(a, b)
    return gemm_fully_connected(a, b)
