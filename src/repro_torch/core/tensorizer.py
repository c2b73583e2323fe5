"""Tensorizer W8A8 quantization: the port of ``repro.core.tensorizer``'s
serving subset (``QTensor``, ``amax_calibrate``, ``quantize``,
``quantize_params``).

``QTensor.scale`` is the dequantization multiplier: ``x_hat = q * scale``.
Quantization is symmetric int8 over [-127, 127] with round-half-to-even, the
same arithmetic as the JAX package, so int8 codes and scales match it bit for
bit on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

QMAX = 127.0


@dataclasses.dataclass
class QTensor:
    """A symmetric-int8 quantized tensor: ``x_hat = q.float() * scale``.

    ``scale`` is a scalar (per-tensor) or broadcastable tensor (per-channel).
    A stacked weight ``(L, K, N)`` carries scales ``(L, 1, N)``; ``[i]``
    selects layer ``i`` of both."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "QTensor":
        return QTensor(self.q[i], self.scale[i])

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))


Axis = Optional[Union[int, Sequence[int]]]


def amax_calibrate(x: torch.Tensor, axis: Axis = None,
                   keepdims: bool = True) -> torch.Tensor:
    """Absolute-max range calibration: per-tensor when ``axis is None``,
    per-channel otherwise."""
    a = x.abs()
    if axis is None:
        amax = a.amax()
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
        amax = a.amax(dim=dims, keepdim=keepdims)
    return torch.clamp_min(amax, 1e-12) / QMAX


def quantize(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
             axis: Axis = None) -> QTensor:
    """Symmetric int8 quantization; ``scale`` defaults to amax calibration.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x = x.to(torch.float32)
    if scale is None:
        scale = amax_calibrate(x, axis=axis)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return QTensor(q=q, scale=scale)


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
