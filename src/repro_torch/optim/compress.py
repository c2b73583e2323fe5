"""Gradient compression with error feedback: the port of
``repro.optim.compress``.

Each gradient leaf is quantized to int8 with a per-tensor amax scale (the
Tensorizer applied to the data-parallel all-reduce: 4x fewer wire bytes
than f32), and the quantization residual is carried to the next step, so
the compression bias vanishes in expectation (Karimireddy et al., 2019)::

    g_q, ef = compress_grads(grads, ef)
    grads = decompress_grads(g_q)
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import tensorizer as tz


def init_error_feedback(grads) -> Any:
    return T.tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compress_grads(grads, error_feedback=None) -> Tuple[Any, Any]:
    """``(q_tree, error_feedback)``: each leaf plus its carried residual,
    quantized (a ``QTensor``), and the new residual ``corrected -
    dequantize(q)``."""
    if error_feedback is None:
        error_feedback = init_error_feedback(grads)
    flat_g, spec = T.flatten(grads)
    flat_e = T.leaves(error_feedback)
    qs, efs = [], []
    for g, ef in zip(flat_g, flat_e):
        corrected = g.to(torch.float32) + ef
        qt = tz.quantize(corrected)
        qs.append(qt)
        efs.append(corrected - qt.dequantize())
    return T.unflatten(spec, qs), T.unflatten(spec, efs)


def decompress_grads(q_tree) -> Any:
    return T.tree_map(lambda q: q.dequantize(), q_tree)
