"""Attention for the serving path: QKV projection, fused prefill that emits
cache-layout K/V, and block-native paged decode.

The port of ``repro.models.attention``'s float-KV serving subset. Prefill's
S x S score product stays plain torch (the JAX package leaves it to XLA);
decode attention runs in the paged-attention kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import paged_decode_attention as _paged_kernel
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_attn(gen: torch.Generator, cfg: ArchConfig, d: int, device=None) -> Dict:
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    return {
        "wq": L.dense_init(gen, (d, H * hd), device=device),
        "wk": L.dense_init(gen, (d, KV * hd), device=device),
        "wv": L.dense_init(gen, (d, KV * hd), device=device),
        "wo": L.dense_init(gen, (H * hd, d), device=device),
    }


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = L.pdot(x, p["wq"], cfg).reshape(B, S, H, hd)
    k = L.pdot(x, p["wk"], cfg).reshape(B, S, KV, hd)
    v = L.pdot(x, p["wv"], cfg).reshape(B, S, KV, hd)
    if cfg.rope_kind != "rope" or cfg.qk_norm:
        raise ValueError("only plain RoPE attention is ported (ROADMAP queue 1 item 11)")
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads (B, S, KV, hd) -> (B, S, H, hd)."""
    rep = n_heads // k.shape[2]
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def prefill_attention_with_kv(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                              positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Full-sequence causal attention that also returns this layer's K/V rows
    in the cache dtype, (B, S, KV, hd) each: ``(out, k_entry, v_entry)``.
    Scores and the value contraction run in f32 against the cache-dtype K/V,
    the same math decode reads back."""
    B, S, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache_dt = L.cdtype(cfg)
    k_c, v_c = k_new.to(cache_dt), v_new.to(cache_dt)
    k = _expand_kv(k_c, cfg.n_heads)
    v = _expand_kv(v_c, cfg.n_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    s = s * (cfg.hd ** -0.5)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = torch.where(causal[None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v.to(torch.float32)).to(x.dtype)
    out = L.pdot(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"], cfg)
    return out, k_c, v_c


def paged_decode_attention(p: Dict, x: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           index: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Block-native single-token attention over ONE layer's pool
    (n_blocks, block_size, KV, hd). The new token's K/V is written into its
    slot's pool cell ``(tables[b, index[b] // bs], index[b] % bs)`` IN PLACE
    (the JAX engine donates the cache for the same effect); rows whose index
    ran past the slot extent (idle slots) clamp into their zeroed table, the
    null block 0, which no live slot reads unmasked. Then the paged-attention
    kernel attends through the tables. Running the step twice rewrites the
    same cells with the same values, so a re-issued step is harmless.
    x: (B, 1, D); returns the attention output (B, 1, D)."""
    B = x.shape[0]
    bs = pool_k.shape[1]
    S = tables.shape[1] * bs
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None])
    pos = torch.clamp(index, max=S - 1).long()
    phys = tables[rows, pos // bs].long()
    off = pos % bs
    pool_k[phys, off] = k_new[:, 0].to(pool_k.dtype)
    pool_v[phys, off] = v_new[:, 0].to(pool_v.dtype)
    o = _paged_kernel(q[:, 0].to(torch.float32).contiguous(), pool_k, pool_v,
                      tables, index)
    o = o[:, None].to(x.dtype)
    return L.pdot(o.reshape(B, 1, cfg.n_heads * cfg.hd), p["wo"], cfg)
