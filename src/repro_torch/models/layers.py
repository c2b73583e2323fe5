"""Shared model layers: the W8A8 matmul, the bf16 gradient barrier, norms
(RMSNorm, LayerNorm and qk_norm's head norm), the MLP (SwiGLU and GeLU),
RoPE and M-RoPE, init.

The port of ``repro.models.layers``. Params are nested dicts
of tensors; compute dtype is ``cfg.dtype`` (bf16) while norm and RoPE math
run in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

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


def matmul_fixed_rows(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """x (..., K) @ w (K, N) in calls of exactly ``rows`` rows, the last
    zero-padded. cuBLAS picks its kernel, and with it the order of a row's
    sums, by the call's shape; one call shape keeps a row's bits whatever
    the rows beside it."""
    K = x.shape[-1]
    flat = x.reshape(-1, K)
    n = flat.shape[0]
    pad = -n % rows
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, K))])
    out = torch.cat([torch.matmul(flat[lo:lo + rows], w) for lo in range(0, n + pad, rows)])
    return out[:n].reshape(*x.shape[:-1], w.shape[-1])


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


class _BF16Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the cotangent's mantissa cut to bf16, in the primal's dtype
        return g.to(torch.bfloat16).to(ctx.dtype)


def bf16_grad(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward casts the cotangent to bf16 and back
    to x's dtype, so activation gradients would cross a tensor-parallel
    all-reduce in bf16 (the reference's ``custom_vjp`` of the same name,
    which nothing in the reference calls either)."""
    return _BF16Grad.apply(x)


def init_norm(cfg: ArchConfig, d: int, device=None) -> Dict:
    """Norm params: ``scale`` ones, and LayerNorm's ``bias`` zeros."""
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Dict, x: torch.Tensor, cfg: ArchConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm in ``cfg.norm_dtype`` (f32), cast back to the
    input dtype, each in one fused call (``F.rms_norm``, ``F.layer_norm``):
    it reduces each row in an order fixed by the row's length, whatever the
    number of rows, so a prefill row (S rows in the call) keeps the bits of
    the decode row at its position (B rows) and a continuation re-admitted
    by prefill continues the stream. PyTorch's CUDA ``torch.mean`` picks its
    plan from the number of rows and would not. LayerNorm is the
    reference's ``(x - mean) * rsqrt(var + eps) * scale + bias`` (biased
    variance) up to the order of its row sums."""
    xf = x.to(_DTYPES[cfg.norm_dtype])
    shape = (xf.shape[-1],)
    if cfg.norm == "layernorm":
        out = F.layer_norm(xf, shape, p["scale"].to(xf.dtype), p["bias"].to(xf.dtype), eps)
    elif cfg.norm == "rmsnorm":
        out = F.rms_norm(xf, shape, p["scale"].to(xf.dtype), eps)
    else:
        raise ValueError(f"norm {cfg.norm!r}: expected rmsnorm or layernorm")
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk_norm (qwen3): RMS-normalize the last (head) dim of q or k in f32,
    cast back to x's dtype; one ``F.rms_norm``, row-count invariant as
    :func:`apply_norm` is."""
    xf = x.to(torch.float32)
    return F.rms_norm(xf, (xf.shape[-1],), scale.to(torch.float32), eps).to(x.dtype)


def init_mlp(gen: torch.Generator, cfg: ArchConfig, d: int, f: int, device=None) -> Dict:
    """MLP params in draw order: SwiGLU ``wi``, ``wg``, ``wo``; GeLU ``wi``,
    ``wo`` (the reference's trees)."""
    names = ("wi", "wg", "wo") if cfg.act == "swiglu" else ("wi", "wo")
    return {n: dense_init(gen, (f, d) if n == "wo" else (d, f), device=device)
            for n in names}


def mlp_specs(cfg: ArchConfig) -> Dict:
    """Partition specs of :func:`init_mlp`'s leaves."""
    if cfg.act == "swiglu":
        return {"wi": (None, "model"), "wg": (None, "model"), "wo": ("model", None)}
    return {"wi": (None, "model"), "wo": ("model", None)}


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """SwiGLU: ``silu(x @ wi) * (x @ wg)`` then ``@ wo`` (``wi`` is the
    projection under silu and ``wg`` the multiplier, as in the JAX
    package); GeLU: ``gelu(x @ wi) @ wo``."""
    h = pdot(x, p["wi"], cfg)
    if cfg.act == "swiglu":
        h = silu(h) * pdot(x, p["wg"], cfg)
    elif cfg.act == "gelu":
        h = gelu(h)
    else:
        raise ValueError(f"act {cfg.act!r}: expected swiglu or gelu")
    return pdot(h, p["wo"], cfg)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * 1 / (1 + exp(-x))`` op by op in x's dtype, each op rounded:
    the sequence ``jax.nn.silu`` lowers to. A fused ``F.silu`` rounds once
    instead, which moves bf16 results and, through the next layer's int8
    requantization, whole codes."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form, op by op in x's dtype, each op
    rounded as its lowering rounds: ``x * (0.5 * (1 + tanh(sqrt(2/pi) *
    (x + 0.044715 * x**3))))``, with ``x**3`` as ``(x * x) * x`` and both
    constants rounded to x's dtype first, as JAX casts them. A fused
    ``F.gelu`` rounds once instead (see :func:`silu`)."""
    def const(c):
        return torch.full((), c, dtype=x.dtype, device=x.device)
    inner = const(0.7978845608028654) * (x + const(0.044715) * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE in f32: the hd / 2 rotary frequencies
    split into (temporal, height, width) sections of ``sections`` sizes,
    each rotated by its own row of ``positions3`` (3, B, S). x: (B, S, H,
    hd). With the three rows equal it is :func:`apply_rope`."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not split {half} rotary dims")
    inv = rope_freqs(hd, theta, device=x.device)
    bounds = [0, sections[0], sections[0] + sections[1], half]
    ang = torch.cat([positions3[i].to(torch.float32)[..., None] * inv[lo:hi]
                     for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))], dim=-1)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
