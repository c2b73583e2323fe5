"""Shared model layers: the W8A8 matmul, norms, the MLP, RoPE, init.

The port of ``repro.models.layers``'s dense subset. Params are nested dicts
of tensors; compute dtype is ``cfg.dtype`` (bf16) while norm and RoPE math
run in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.kernels.qgemm import qgemm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               device=None) -> torch.Tensor:
    """LeCun-normal init in f32: N(0, 1) * fan_in^-0.5."""
    fan_in = shape[in_axis]
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device) * (fan_in ** -0.5)


def pdot(x: torch.Tensor, w: Union[torch.Tensor, tz.QTensor],
         cfg: ArchConfig) -> torch.Tensor:
    """Activation @ weight with the framework's precision policy.

    For a ``QTensor`` weight (serving, quantize="serve") the activations are
    quantized per ROW (amax over the contraction dim), so a row's numerics
    never depend on what else shares the batch, and the int8 x int8 product
    with int32 accumulation and the dequant epilogue
    ``acc * (row_scale * channel_scale)`` runs in the qgemm kernel."""
    if isinstance(w, tz.QTensor):
        K = x.shape[-1]
        qx = tz.quantize(x.to(torch.float32), axis=x.ndim - 1)
        out = qgemm(qx.q.reshape(-1, K), w.q, w.scale.reshape(-1),
                    sa=qx.scale.reshape(-1), out_dtype=cdtype(cfg))
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return torch.matmul(x, w.to(cdtype(cfg)))


def apply_norm(p: Dict, x: torch.Tensor, cfg: ArchConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    if cfg.norm != "rmsnorm":
        raise ValueError(f"norm {cfg.norm!r} is not ported yet (ROADMAP queue 1 item 11)")
    xf = x.to(_DTYPES[cfg.norm_dtype])
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """SwiGLU: ``silu(x @ wi) * (x @ wg)`` then ``@ wo``. ``wi`` is the
    projection under silu and ``wg`` the multiplier, as in the JAX package."""
    if cfg.act != "swiglu":
        raise ValueError(f"act {cfg.act!r} is not ported yet (ROADMAP queue 1 item 11)")
    h = silu(pdot(x, p["wi"], cfg)) * pdot(x, p["wg"], cfg)
    return pdot(h, p["wo"], cfg)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * 1 / (1 + exp(-x))`` op by op in x's dtype, each op rounded:
    the sequence ``jax.nn.silu`` lowers to. A fused ``F.silu`` rounds once
    instead, which moves bf16 results and, through the next layer's int8
    requantization, whole codes."""
    return x * (1 / (1 + torch.exp(-x)))


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE in f32. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
