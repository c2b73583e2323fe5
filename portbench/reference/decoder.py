"""The plain reference of the dense decoder configurations (attention with
grouped KV heads, optional qk_norm, a SwiGLU MLP), in f32 plain PyTorch,
one layer at a time.

The quantization is the one the configuration states, worked out here
from the float weights (``portbench/weights.py``), never taken from the
program:

* projections (attention q/k/v/o, the MLP, the output head): weights
  symmetric int-``bits`` per output channel (absolute max over the
  contraction axis, round half to even), activations int8 per row, the
  integer product rescaled by the row scale and the channel scale;
* embedding and norms in float; K and V rounded to the KV cache's
  dtype (bf16) before attention reads them.

``bits`` is 8 for the configuration and 4 for the control (the precision
below int8 that a later change might be tempted by). Matmuls run in f32
with TF32 off; integer codes are held as f32 values, whose products are
exact.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench import weights as W
from portbench.model import Model

ACT_QMAX = 127.0
QUERY_BLOCK = 512          # attention queries per block: bounds the score memory


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize_weight(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric codes (as f32 values) and scales of
    ``w`` (..., K, N): the absolute max over K over the largest code."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / qmax
    return torch.round(w / scale).clamp_(-qmax, qmax), scale


def qlinear(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (T, K) f32 through a quantized weight: x quantized to int8 per
    row, the product of codes, then the row scale and the channel scale."""
    sx = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / ACT_QMAX
    qx = torch.round(x / sx).clamp_(-ACT_QMAX, ACT_QMAX)
    return (qx @ codes) * sx * scale.reshape(1, -1)


def rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis with unit scale (every norm scale of
    the seeded weights is 1)."""
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (S, heads, hd) at positions 0..S-1."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, hd), k and v (S, KV, hd);
    query head h reads KV head h // (H / KV). Returns (S, H * hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    rep = H // KV
    qg = q.permute(1, 0, 2).reshape(KV, rep, S, hd)
    kt = k.permute(1, 2, 0)                      # (KV, hd, S)
    vg = v.permute(1, 0, 2)                      # (KV, S, hd)
    out = torch.empty((KV, rep, S, hd), dtype=torch.float32, device=q.device)
    for a in range(0, S, QUERY_BLOCK):
        b = min(S, a + QUERY_BLOCK)
        s = torch.matmul(qg[:, :, a:b], kt[:, None, :, :b]) * hd ** -0.5
        allowed = (torch.arange(b, device=q.device)[None, :]
                   <= torch.arange(a, b, device=q.device)[:, None])
        s = torch.where(allowed, s, torch.full_like(s, float("-inf")))
        out[:, :, a:b] = torch.matmul(torch.softmax(s, dim=-1), vg[:, None, :b])
    return out.reshape(H, S, hd).permute(1, 0, 2).reshape(S, H * hd)


def _quantized(leaves: Dict[str, torch.Tensor], bits: int) -> Dict[str, Tuple]:
    return {name: quantize_weight(w, bits) for name, w in leaves.items()}


def _mlp(x: torch.Tensor, q: Dict, prefix: str) -> torch.Tensor:
    h = qlinear(x, *q[prefix + "wi"])
    h = torch.nn.functional.silu(h) * qlinear(x, *q[prefix + "wg"])
    return qlinear(h, *q[prefix + "wo"])


def _layer(m: Model, xs: List[torch.Tensor], leaves: Dict[str, torch.Tensor],
           bits: int) -> List[torch.Tensor]:
    q = _quantized(leaves, bits)
    H, KV, hd = m.n_heads, m.n_kv, m.head_dim
    out = []
    for x in xs:
        S = x.shape[0]
        h = rmsnorm(x, m.rms_norm_eps)
        qh = qlinear(h, *q["attn.wq"]).reshape(S, H, hd)
        kh = qlinear(h, *q["attn.wk"]).reshape(S, KV, hd)
        vh = qlinear(h, *q["attn.wv"]).reshape(S, KV, hd)
        if m.qk_norm:
            qh, kh = rmsnorm(qh, m.rms_norm_eps), rmsnorm(kh, m.rms_norm_eps)
        qh, kh = rope(qh, m.rope_theta), rope(kh, m.rope_theta)
        kh = kh.to(torch.bfloat16).to(torch.float32)
        vh = vh.to(torch.bfloat16).to(torch.float32)
        out.append(x + qlinear(attention(qh, kh, vh), *q["attn.wo"]))
    return [x + _mlp(rmsnorm(x, m.rms_norm_eps), q, "mlp.") for x in out]


@torch.no_grad()
def logits(m: Model, seed: int, seqs: Sequence[torch.Tensor], scored: Sequence[int],
           bits: int, device) -> List[torch.Tensor]:
    """The f32 logits (n_i, vocab) at the last ``scored[i]`` positions of
    each token sequence ``seqs[i]`` (int64, on ``device``), every sequence
    attending causally from its first position. Weights are made one layer
    at a time from ``seed``."""
    _no_tf32()
    emb = W.embedding(m, seed, device)
    xs = [emb[s] for s in seqs]
    del emb
    for i in range(m.n_layers):
        xs = _layer(m, xs, W.layer(m, seed, i, device), bits)
    head = quantize_weight(W.lm_head(m, seed, device), bits)
    return [qlinear(rmsnorm(x[x.shape[0] - n:], m.rms_norm_eps), *head)
            for x, n in zip(xs, scored)]
