"""Tensorizer: the port of ``repro.core.tensorizer`` (GPTPU's §6.2).

It derives range-calibrated int8 scales per operator (the paper's Eqs. 4-8),
partitions operations into 128x128 tiles (``ext``, ``crop``, ``partition``,
``reassemble``), and accumulates in wider precision than int8 (``qdot`` and
its variants, through the int8 GEMM kernel).

``QTensor.scale`` is the dequantization multiplier: ``x_hat = q * scale``.
The paper's ``S`` is a quantization multiplier (``q = round(x * S * 127)``),
so ``scale = 1 / (S * 127)``. Quantization is symmetric int8 over [-127, 127]
with round-half-to-even, the same arithmetic as the JAX package, so int8
codes and scales match it bit for bit on the same inputs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.qgemm import qgemm

QMAX = 127.0          # symmetric int8; -128 is excluded
MXU_TILE = 128        # the 128x128 matrix unit the paper tiles for
MATRIXWISE_TILE = 64  # the paper's sub-matrix for mean / max


class OpKind(enum.Enum):
    """Operator classes with distinct scaling rules (paper §6.2.2)."""

    MATMUL = "matmul"            # conv2D / FullyConnected       (Eq. 5)
    ADD_SUB = "add_sub"          # pair-wise add / sub           (Eq. 6)
    MUL = "mul"                  # pair-wise mul                 (Eq. 7)
    ELEMENTWISE = "elementwise"  # tanh / relu / crop / ext / ...  (Eq. 8)


@dataclasses.dataclass
class QTensor:
    """A symmetric-int8 quantized tensor: ``x_hat = q.float() * scale``.

    ``scale`` is a scalar (per-tensor) or broadcastable tensor (per-channel,
    per-tile). A stacked weight ``(L, K, N)`` carries scales ``(L, 1, N)``;
    ``[i]`` selects layer ``i`` of both. ``meta_shape`` records the logical
    shape before any ``ext`` padding, so ``crop`` can undo it."""

    q: torch.Tensor
    scale: torch.Tensor
    meta_shape: Tuple[int, ...] = ()

    def __getitem__(self, i) -> "QTensor":
        return QTensor(self.q[i], self.scale[i], tuple(self.q[i].shape))

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.meta_shape)

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale


# ---------------------------------------------------------------------------
# Paper scaling rules (Eqs. 4-8), verbatim.
# ---------------------------------------------------------------------------

def paper_scale_for(op: OpKind, lo, hi, n: Optional[int] = None) -> torch.Tensor:
    """The paper's scaling factor S for an operator whose inputs span
    [``lo``, ``hi``]; ``n`` is the contraction length for MATMUL. The rules
    guarantee ``|output| * S <= 1``, so the scaled output cannot overflow."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    r = torch.clamp_min((hi - lo).abs(), 1e-12)  # guard all-equal datasets
    if op == OpKind.MATMUL:
        if n is None:
            raise ValueError("MATMUL scaling (Eq. 5) requires the contraction length n")
        return 1.0 / (r * r * n)                      # Eq. 5
    if op == OpKind.ADD_SUB:
        return 1.0 / (2.0 * r)                        # Eq. 6
    if op == OpKind.MUL:
        return 1.0 / (r * r)                          # Eq. 7
    return 1.0 / r                                    # Eq. 8 (elementwise & others)


def scale_from_paper_S(S: torch.Tensor) -> torch.Tensor:
    """Convert the paper's quantization multiplier S into a dequant scale."""
    return 1.0 / (S * QMAX)


Axis = Optional[Union[int, Sequence[int]]]


def amax_calibrate(x: torch.Tensor, axis: Axis = None,
                   keepdims: bool = True) -> torch.Tensor:
    """Absolute-max range calibration: per-tensor when ``axis is None``,
    per-channel otherwise.

    The divisor is a tensor on ``x``'s device: CUDA divides by a Python
    scalar as a multiply by its rounded reciprocal, which misses the true
    quotient by one ulp for some 4% of values, so scales (and then codes)
    would differ between the card, the CPU and the JAX package."""
    a = x.abs()
    if axis is None:
        amax = a.amax()
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
        amax = a.amax(dim=dims, keepdim=keepdims)
    return torch.clamp_min(amax, 1e-12) / amax.new_full((), QMAX)


def quantize(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
             axis: Axis = None, snap_integer: bool = False) -> QTensor:
    """Symmetric int8 quantization; ``scale`` defaults to amax calibration.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.

    ``snap_integer``: when the data is integer-valued with amax <= 127, the
    scale snaps to 1 so quantization is exact (the paper's 0.00% Gaussian and
    LUD rows, Table 4)."""
    x = x.to(torch.float32)
    if scale is None:
        scale = amax_calibrate(x, axis=axis)
        if snap_integer:
            is_int = (torch.round(x) == x).all() & (x.abs().amax() <= QMAX)
            scale = torch.where(is_int, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return QTensor(q=q, scale=scale, meta_shape=tuple(x.shape))


def dequantize(qt: QTensor) -> torch.Tensor:
    return qt.dequantize()


def fake_quantize(x: torch.Tensor, axis: Axis = None,
                  snap_integer: bool = False) -> torch.Tensor:
    """quantize -> dequantize round trip: the error-model building block."""
    return dequantize(quantize(x, axis=axis, snap_integer=snap_integer))


# ---------------------------------------------------------------------------
# Wide-accumulation quantized contractions
# ---------------------------------------------------------------------------

def _int8_dot_f32(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """``float(a_q @ b_q)`` accumulated in int32 through the qgemm kernel
    (unit scales): ``a_q`` (..., K) or (K,), ``b_q`` (K, N) int8; the result
    has ``a_q``'s leading shape with N last."""
    K, N = b_q.shape
    ones = torch.ones((N,), dtype=torch.float32, device=b_q.device)
    acc = qgemm(a_q.reshape(-1, K).contiguous(), b_q.contiguous(), ones)
    return acc.reshape(*a_q.shape[:-1], N)


def qdot(a: torch.Tensor, b: torch.Tensor, *, per_channel: bool = True) -> torch.Tensor:
    """W8A8 matmul with int32 accumulation and the dequant after it:
    ``a @ b`` in int8. ``a`` is (K,) or (..., M, K), quantized per tensor;
    ``b`` (K, N), quantized per output channel when ``per_channel``.

    The int32 product runs on the qgemm kernel with unit scales; the dequant
    is ``float(acc) * qa.scale * sb``, left to right, as the JAX package
    computes it (a fused ``sb = qa.scale * sb`` would round differently)."""
    if a.shape[-1] > (2 ** 31) // (127 * 127):
        raise ValueError(f"contraction dim {a.shape[-1]} would overflow int32 accumulation")
    qa = quantize(a)
    qb = quantize(b, axis=(0,)) if per_channel else quantize(b)
    acc = _int8_dot_f32(qa.q, qb.q)
    sb = qb.scale.reshape(-1) if per_channel else qb.scale
    return acc * qa.scale * sb


def qdot_paper(a: torch.Tensor, b: torch.Tensor, *,
               requantize_output: bool = False) -> torch.Tensor:
    """Paper-faithful GEMM quantization (Eq. 5 with §6.2.1's wide
    aggregation): int32 accumulation, and Eq. 5's output-range factor ``S``
    bounds the result, so the pipeline cannot overflow (paper Fig. 7). The
    output is requantized to int8 against ``S`` only when it feeds another
    instruction (``requantize_output=True``)."""
    lo = torch.minimum(a.min(), b.min())
    hi = torch.maximum(a.max(), b.max())
    S = paper_scale_for(OpKind.MATMUL, lo, hi, n=a.shape[-1])
    qa, qb = quantize(a), quantize(b, axis=(0,))
    out = _int8_dot_f32(qa.q, qb.q) * (qa.scale * qb.scale)
    if requantize_output:
        q_out = torch.clamp(torch.round(out * S * QMAX), -QMAX, QMAX)
        return q_out / (S * QMAX)
    return out


def qdot_naive_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FBGEMM-style strawman of paper Fig. 7: dtype-range int8 and no
    output calibration, clipped to a 16-bit output. Used by benchmarks only.
    ``float(acc)`` may round past 2^24, but every such value is clipped."""
    qa = torch.clamp(torch.round(a), -QMAX, QMAX).to(torch.int8)
    qb = torch.clamp(torch.round(b), -QMAX, QMAX).to(torch.int8)
    return torch.clamp(_int8_dot_f32(qa, qb), -(2 ** 15), 2 ** 15 - 1)


# ---------------------------------------------------------------------------
# Tile partitioning (paper §6.2.1 "mapping operators into instructions")
# ---------------------------------------------------------------------------

def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ext(x: torch.Tensor, row_mult: int = MXU_TILE, col_mult: int = MXU_TILE) -> torch.Tensor:
    """Pad a matrix with zeros to tile-aligned shape (the paper's ``ext``)."""
    r, c = x.shape[-2], x.shape[-1]
    return F.pad(x, (0, round_up(c, col_mult) - c, 0, round_up(r, row_mult) - r))


def crop(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The logical sub-matrix without padding (the paper's ``crop``)."""
    return x[..., :rows, :cols]


def partition(x: torch.Tensor, tile: int = MXU_TILE) -> torch.Tensor:
    """(R, C) -> (R/t, C/t, t, t) grid of tiles (pads first)."""
    xp = ext(x, tile, tile)
    R, C = xp.shape[-2], xp.shape[-1]
    g = xp.reshape(*xp.shape[:-2], R // tile, tile, C // tile, tile)
    return g.transpose(-3, -2)


def reassemble(tiles: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Inverse of :func:`partition` followed by :func:`crop`."""
    g = tiles.transpose(-3, -2)
    t = g.shape[-1]
    x = g.reshape(*g.shape[:-4], g.shape[-4] * t, g.shape[-2] * t)
    return crop(x, rows, cols)


Path = Tuple[str, ...]


def quantize_params(params, predicate: Optional[Callable[[Path, torch.Tensor], bool]] = None):
    """Quantize every >=2D floating-point leaf of a nested param dict to a
    ``QTensor``, with per-output-channel scales reduced over the contraction
    dim (-2) and every leading stacked-layer axis kept. ``predicate(path,
    leaf)`` (``path`` is the tuple of dict keys) can exclude leaves."""
    def walk(node, path: Path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        quantizable = (
            isinstance(node, torch.Tensor) and node.ndim >= 2
            and node.is_floating_point()
            and (predicate is None or predicate(path, node)))
        return quantize(node, axis=-2) if quantizable else node
    return walk(params, ())
