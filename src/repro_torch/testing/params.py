"""Carry a parameter tree from the JAX package into the port.

The input is the JAX param tree with every array already converted to
numpy (for example ``jax.tree.map(np.asarray, params)``, which keeps each
``QTensor`` node with numpy ``q``/``scale`` leaves). Nothing here imports
JAX: a ``QTensor`` is recognised by its ``q`` and ``scale`` attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tensorizer import QTensor


def params_from_numpy(tree, device=None):
    """Nested dicts of numpy arrays (and q/scale pairs) -> the port's params:
    the same tree with torch tensors and port ``QTensor``s on ``device``
    (``resolve_device``: the card unless the caller names the CPU). A
    ``None`` leaf (the hybrid family's absent ``tail``) stays ``None``."""
    return _convert(tree, resolve_device(device))


def _convert(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QTensor(_convert(tree.q, device), _convert(tree.scale, device))
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    raise TypeError(f"unsupported param leaf {type(tree).__name__}")
