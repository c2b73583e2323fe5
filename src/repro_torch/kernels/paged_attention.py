"""Block-native paged decode attention: the CUDA kernel
``csrc/paged_attention.cu`` and its plain version.

Replaces ``repro/kernels/paged_attention.py::paged_decode_attention``.
Single-query attention for every slot ``b`` over the pool blocks its table
names: ``q`` (B, H, hd) f32 against pools (n_blocks, block_size, KV, hd),
``tables`` (B, MB) int32, ``index`` (B,) int32 causal horizons; returns
(B, H, hd) f32. GQA is folded as (KV, rep, hd), scores are scaled by
hd^-0.5, and positions ``j * bs + t > index[b]`` get weight exactly 0, so
the null block 0 and cells past a lease never leak in.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_POOL_DTYPES = (torch.bfloat16, torch.float32)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 index: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's table-addressed blocks into
    a contiguous view and run masked full-row softmax attention in f32."""
    B, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    S = tables.shape[1] * bs
    flat = tables.reshape(-1).long()
    k = k_pool[flat].reshape(B, S, KV, hd).to(torch.float32)
    v = v_pool[flat].reshape(B, S, KV, hd).to(torch.float32)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.to(torch.float32), k) * hd ** -0.5
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= index.to(q.device)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return torch.einsum("bhk,bkhd->bhd", torch.softmax(s, dim=-1), v)


def _check(q, k_pool, v_pool, tables, index) -> None:
    if q.dtype != torch.float32:
        raise TypeError(f"paged_decode_attention: q must be float32, got {q.dtype}")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_decode_attention: pools must share one of "
                        f"{_POOL_DTYPES}, got {k_pool.dtype}/{v_pool.dtype}")
    if tables.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("paged_decode_attention: tables and index must be int32")
    if q.ndim != 3 or k_pool.ndim != 4 or tables.ndim != 2 or index.ndim != 1:
        raise ValueError("paged_decode_attention: expected q (B,H,hd), pools "
                         "(NB,bs,KV,hd), tables (B,MB), index (B,)")
    B, H, hd = q.shape
    NB, bs, KV, hd2 = k_pool.shape
    if (v_pool.shape != k_pool.shape or hd2 != hd or H % KV
            or tables.shape[0] != B or index.shape[0] != B
            or min(B, NB, bs, tables.shape[1]) < 1):
        raise ValueError(
            f"paged_decode_attention: incompatible shapes q {tuple(q.shape)}, "
            f"pool {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(tables.shape)}, index {tuple(index.shape)}")
    tensors = (q, k_pool, v_pool, tables, index)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: operands must be contiguous")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    _check(q, k_pool, v_pool, tables, index)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, index)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    NB, bs, KV, _ = k_pool.shape
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    lib = _build.library("paged_attention")
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        index.data_ptr(), out.data_ptr(), B, H, KV, hd, bs, tables.shape[1], NB,
        int(k_pool.dtype == torch.bfloat16), hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
