"""Block-native paged decode attention: the CUDA kernel
``csrc/paged_attention.cu`` and its plain version.

Replaces ``repro/kernels/paged_attention.py::paged_decode_attention``.
Single-query attention for every slot ``b`` over the pool blocks its table
names: ``q`` (B, H, hd) f32 against pools (n_blocks, block_size, KV, hd),
``tables`` (B, MB) int32, ``index`` (B,) int32 causal horizons; returns
(B, H, hd) f32. GQA is folded as (KV, rep, hd), scores are scaled by
hd^-0.5, and positions ``j * bs + t > index[b]`` get weight exactly 0, so
the null block 0 and cells past a lease never leak in.

On the card the kernel splits each slot's table into contiguous runs of
entries (flash-decoding), one block per (split, group of query heads,
slot); each split leaves an online-softmax partial that a second kernel
folds in split order. :func:`plan` picks the split from the shapes of the
table and the heads alone, never from the batch or the horizons, so a
slot's result has the same bits however many slots share the call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import accounting
from repro_torch.kernels import _build

NEG_INF = -1e30
_POOL_DTYPES = (torch.bfloat16, torch.float32)
WARPS = 4              # warps per block of the split kernel
ROWS = 2               # rows a lane group takes per step of the split kernel
RESCALE = 8.0          # log2 of the largest weight before the kernel rescales
ROW_BYTES = (32, 64, 128, 256, 512)  # K/V row sizes the kernel takes
MIN_SPLIT_TOKENS = 32  # fewest positions a split covers where the table allows
MAX_SPLITS = 8         # most splits per slot


class Plan(NamedTuple):
    splits: int     # blocks along the table per (slot, head group)
    per: int        # table entries per split; the last split may hold fewer
    heads: int      # query heads per block, all of one KV group

    def blocks(self, B: int, H: int) -> int:
        return B * (H // self.heads) * self.splits


@functools.lru_cache(maxsize=256)
def plan(MB: int, bs: int, H: int, KV: int) -> Plan:
    """The split kernel's launch plan, from the table's width ``MB``, the
    block size and the heads only. Each split covers at least
    ``MIN_SPLIT_TOKENS`` positions (so that its partial, written and read
    once, stays small beside the K/V it reads) and a slot has at most
    ``MAX_SPLITS`` (so that the combine's reads stay small: at a 2048-token
    context, 8 measured faster than 4, 6, 12 or 16 on the H100); a block
    keeps the largest of 8, 4, 2 or 1 query heads that divides the group,
    so that one K/V load serves them all. At the serving shape (MB = 10,
    bs = 16, 32 heads over 4 KV heads) that is 5 splits of 2 entries, 160
    blocks at 8 slots."""
    rep = H // KV
    heads = next(h for h in (8, 4, 2, 1) if rep % h == 0)
    per = min(MB, max(-(-MIN_SPLIT_TOKENS // bs), -(-MB // MAX_SPLITS)))
    return Plan(-(-MB // per), per, heads)


def lanes_per_row(hd: int, dtype: torch.dtype) -> int:
    """Lanes of a warp that hold one K/V row in the split kernel, 16 bytes
    each (hd 64 in bf16: 8); a block keeps at most that many query heads.
    Raises for rows the kernel does not take: 32-512 bytes in a power of
    two."""
    if hd * dtype.itemsize not in ROW_BYTES:
        raise ValueError(f"paged_decode_attention: the CUDA kernel takes K/V rows of "
                         f"32-512 bytes in a power of two, got hd {hd} in {dtype}")
    return hd * dtype.itemsize // 16


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
    launch the kernel on the current stream (two launches where the plan
    splits the table, counted as one call); meta tensors launch nothing.
    The call is recorded with the accounting context from the shapes: the
    score and value contractions over every table entry, each row's blocks
    of K and V read once."""
    _check(q, k_pool, v_pool, tables, index)
    B, H, hd = q.shape
    NB, bs, KV, _ = k_pool.shape
    MB = tables.shape[1]
    kv_bytes = 2 * B * MB * bs * KV * hd * k_pool.element_size()
    nbytes = 2 * accounting.tensor_bytes(q) + kv_bytes + 4 * B * MB + 4 * B
    with accounting.kernel("paged_decode_attention", 4 * B * H * MB * bs * hd, nbytes):
        if q.device.type == "cpu":
            return paged_decode_attention_plain(q, k_pool, v_pool, tables, index)
        if q.device.type == "meta":
            return torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
        if q.device.type != "cuda":
            raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
        lanes = lanes_per_row(hd, k_pool.dtype)
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
            raise ValueError("paged_decode_attention: the CUDA kernel needs 16-byte "
                             "aligned pools")
        p = plan(MB, bs, H, KV)
        out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
        partial = (torch.empty(B * H * p.splits * (hd + 2), dtype=torch.float32,
                               device=q.device) if p.splits > 1 else None)
        lib = _build.library("paged_attention")
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            index.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
            B, H, KV, hd, bs, MB, NB, int(k_pool.dtype == torch.bfloat16), p.splits,
            p.per, min(p.heads, lanes), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "paged_decode_attention")
        paged_decode_attention.launches += 1
        return out


paged_decode_attention.launches = 0
