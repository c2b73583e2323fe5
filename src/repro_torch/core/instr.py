"""The GPTPU instruction set (paper Table 1): the port of ``repro.core.instr``.

Each instruction has two lowerings:

  * ``fp``    — the reference semantics (what the host would compute);
  * ``quant`` — Tensorizer-calibrated int8 semantics (what the Edge TPU
                executes).

The paper's applications are written against this set as OpenCtpu programs
call ``openctpu_invoke_operator``. conv2D at 3x3, stride 1, SAME (every
conv2D the applications run) goes to the stencil kernel in both lowerings;
FullyConnected's quant lowering runs on the int8 GEMM kernel through
``tensorizer.qdot``.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tensorizer as tz
from repro_torch.kernels.stencil3x3 import stencil3x3


class Instr(enum.Enum):
    CONV2D = "conv2D"
    FULLY_CONNECTED = "FullyConnected"
    SUB = "sub"
    ADD = "add"
    MUL = "mul"
    CROP = "crop"
    EXT = "ext"
    MEAN = "mean"
    MAX = "max"
    TANH = "tanh"
    RELU = "ReLu"


Stride = Tuple[int, int]


# --------------------------------------------------------------------------
# Convolution (NN convention: cross-correlation), single-channel image
# --------------------------------------------------------------------------

def _is_stencil(kernel: torch.Tensor, stride: Stride, padding: str) -> bool:
    return tuple(kernel.shape) == (3, 3) and tuple(stride) == (1, 1) and padding == "SAME"


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding along one axis: output ceil(size / s), the extra
    cell (when odd) on the high side."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_image(x: torch.Tensor, kernels: torch.Tensor, stride: Stride = (1, 1),
                 padding: str = "SAME") -> torch.Tensor:
    """f32 cross-correlation of an (H, W) image with ``kernels`` (kh, kw, N)
    through ``F.conv2d``; returns (Ho, Wo, N). ``padding`` is "SAME" or
    "VALID", as in ``lax.conv_general_dilated``. cuDNN runs f32
    convolutions in TF32 by default; this call turns that off for itself
    only, so the card computes in f32 as the CPU does."""
    kh, kw, n = kernels.shape
    if padding == "SAME":
        pads = (_same_pads(x.shape[0], kh, stride[0]), _same_pads(x.shape[1], kw, stride[1]))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        raise ValueError(f"conv2d: padding must be 'SAME' or 'VALID', got {padding!r}")
    xp = F.pad(x.to(torch.float32), (*pads[1], *pads[0]))[None, None]
    w = kernels.to(torch.float32).permute(2, 0, 1)[:, None]          # (N, 1, kh, kw)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(xp, w, stride=tuple(stride))
    return out[0].permute(1, 2, 0)


# --------------------------------------------------------------------------
# fp lowerings (the semantics; Table 1 "Description" column)
# --------------------------------------------------------------------------

def conv2d_fp(x: torch.Tensor, kernel: torch.Tensor, stride: Stride = (1, 1),
              padding: str = "SAME") -> torch.Tensor:
    """2D convolution (cross-correlation, NN convention) of a matrix by a
    kernel; 3x3 stride-1 SAME runs on the stencil kernel."""
    if _is_stencil(kernel, stride, padding):
        return stencil3x3(x.to(torch.float32).contiguous(),
                          kernel.to(torch.float32).contiguous())
    return conv2d_image(x, kernel[:, :, None], stride, padding)[:, :, 0]


def fully_connected_fp(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input vector (or batch of vectors) multiplies a weight matrix."""
    return v.to(torch.float32) @ w.to(torch.float32)


def add_fp(a, b):
    return a + b


def sub_fp(a, b):
    return a - b


def mul_fp(a, b):
    return a * b


def mean_fp(a):
    return torch.mean(a)


def max_fp(a):
    return torch.max(a)


def tanh_fp(a):
    return torch.tanh(a)


def relu_fp(a):
    return torch.clamp_min(a, 0.0)


crop_fp = tz.crop
ext_fp = tz.ext


# --------------------------------------------------------------------------
# Quantized lowerings (Tensorizer semantics)
# --------------------------------------------------------------------------

def _all_int(x: torch.Tensor) -> torch.Tensor:
    return (torch.round(x) == x).all()


def _pairwise_quant(op: Callable, kind: tz.OpKind) -> Callable:
    """Pairwise int8 op with sampled output-range scaling (paper Eq. 4):
        add/sub:  |out| <= amax_a + amax_b
        mul:      |out| <= amax_a * amax_b
    Integer inputs whose output bound is within int8 stay exact end to end
    (scale snapped to 1: Table 4's 0.00% rows). The operations and their
    order are the JAX package's, so integer paths are bitwise equal to it."""
    def f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        amax_a = torch.clamp_min(a.abs().amax(), 1e-12)
        amax_b = torch.clamp_min(b.abs().amax(), 1e-12)
        bound = amax_a * amax_b if kind == tz.OpKind.MUL else amax_a + amax_b
        S = 1.0 / bound                                       # Eq. 4
        out = op(tz.fake_quantize(a, snap_integer=True),
                 tz.fake_quantize(b, snap_integer=True))
        both_int = _all_int(a) & _all_int(b) & (bound <= tz.QMAX)
        q = torch.clamp(torch.round(out * S * tz.QMAX), -tz.QMAX, tz.QMAX)
        return torch.where(both_int, out, q / (S * tz.QMAX))
    return f


add_quant = _pairwise_quant(add_fp, tz.OpKind.ADD_SUB)
sub_quant = _pairwise_quant(sub_fp, tz.OpKind.ADD_SUB)
mul_quant = _pairwise_quant(mul_fp, tz.OpKind.MUL)


def fully_connected_quant(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tz.qdot(v, w)


def conv2d_quant(x: torch.Tensor, kernel: torch.Tensor, stride: Stride = (1, 1),
                 padding: str = "SAME") -> torch.Tensor:
    """conv2D on int8 codes with exact integer sums, then the dequant
    ``float(acc) * (qx.scale * qk.scale)``. The codes run as f32: every
    product is an integer <= 127^2 and every sum stays below 2^24, so f32
    holds them exactly in any order (checked for the general path)."""
    qx, qk = tz.quantize(x), tz.quantize(kernel)
    xf, kf = qx.q.to(torch.float32), qk.q.to(torch.float32)
    if _is_stencil(kernel, stride, padding):
        acc = stencil3x3(xf, kf)
    else:
        kh, kw = kernel.shape
        if kh * kw * 127 * 127 >= 2 ** 24:
            raise ValueError(f"conv2d_quant: a {kh}x{kw} kernel's integer sums "
                             f"can pass 2^24 and would round in f32")
        acc = conv2d_image(xf, kf[:, :, None], stride, padding)[:, :, 0]
    return acc * (qx.scale * qk.scale)


def _elementwise_quant(op: Callable) -> Callable:
    def f(a: torch.Tensor) -> torch.Tensor:
        return op(tz.fake_quantize(a))
    return f


tanh_quant = _elementwise_quant(tanh_fp)
relu_quant = _elementwise_quant(relu_fp)


def mean_quant(a: torch.Tensor) -> torch.Tensor:
    """Matrix-wise op: 64x64 sub-matrix instructions and host-side
    aggregation (paper §6.2.1). Zero padding adds nothing to the sums; the
    true element count divides."""
    tiles = tz.partition(a, tz.MATRIXWISE_TILE)
    per_tile = tz.fake_quantize(tiles).sum(dim=(-1, -2))
    return per_tile.sum() / a.numel()


def max_quant(a: torch.Tensor) -> torch.Tensor:
    t = tz.MATRIXWISE_TILE
    H, W = a.shape
    ap = (a.min() - 1.0).expand(tz.round_up(H, t), tz.round_up(W, t)).clone()
    ap[:H, :W] = a
    per_tile = tz.fake_quantize(tz.partition(ap, t)).amax(dim=(-1, -2))
    return per_tile.max()


# --------------------------------------------------------------------------
# Dispatch tables
# --------------------------------------------------------------------------

FP: Dict[Instr, Callable] = {
    Instr.CONV2D: conv2d_fp,
    Instr.FULLY_CONNECTED: fully_connected_fp,
    Instr.ADD: add_fp,
    Instr.SUB: sub_fp,
    Instr.MUL: mul_fp,
    Instr.CROP: crop_fp,
    Instr.EXT: ext_fp,
    Instr.MEAN: mean_fp,
    Instr.MAX: max_fp,
    Instr.TANH: tanh_fp,
    Instr.RELU: relu_fp,
}

QUANT: Dict[Instr, Callable] = {
    Instr.CONV2D: conv2d_quant,
    Instr.FULLY_CONNECTED: fully_connected_quant,
    Instr.ADD: add_quant,
    Instr.SUB: sub_quant,
    Instr.MUL: mul_quant,
    Instr.CROP: crop_fp,   # shape ops are exact in either lowering
    Instr.EXT: ext_fp,
    Instr.MEAN: mean_quant,
    Instr.MAX: max_quant,
    Instr.TANH: tanh_quant,
    Instr.RELU: relu_quant,
}


def invoke(instr: Instr, *args, quantized: bool = True, **kw):
    """``openctpu_invoke_operator``: execute one accelerator instruction."""
    table = QUANT if quantized else FP
    return table[instr](*args, **kw)
