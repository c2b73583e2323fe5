"""Attention for the serving path: QKV projection, fused and chunked prefill
that emit cache-layout K/V, contiguous decode, and block-native paged decode.

The port of ``repro.models.attention``'s serving subset, float and int8 KV,
with the speculative verify window (``verify_decode_attention``,
``paged_verify_attention``).
Every score and value contraction runs in f32 against the cache-dtype K/V
(int8 entries dequantized first, exactly as decode reads them back), the
math of the reference's ``decode_attention``, so that a cache seeded by any
admission route decodes the same tokens. Prefill's score products stay
plain torch (the JAX package leaves them to XLA); float-KV block-native
decode can run in the paged-attention kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import paged_decode_attention as _paged_kernel
from repro_torch.models import layers as L

NEG_INF = -1e30
QMAX = 127.0
# query rows per value-contraction GEMM in prefill (module doc of _attend)
QUERY_TILE = 256


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


def _quantize_kv(k_new: torch.Tensor, v_new: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Int8 KV-cache quantization, per token and head: amax scales over hd,
    ``(k_q, v_q, k_scale, v_scale)`` with int8 entries (..., KV, hd) and f32
    scales (..., KV). The one definition every write path shares (prefill,
    chunked prefill, contiguous and paged decode).

    The divisor 127 is a tensor on the data's device: CUDA divides by a
    Python scalar as a multiply by its rounded reciprocal, which would move
    scales (and then codes) off the CPU's and the JAX package's."""
    def one(x):
        xf = x.to(torch.float32)
        sc = xf.abs().amax(dim=-1) / xf.new_full((), QMAX) + 1e-12
        q = torch.clamp(torch.round(xf / sc[..., None]), -QMAX, QMAX).to(torch.int8)
        return q, sc
    k_q, k_sc = one(k_new)
    v_q, v_sc = one(v_new)
    return k_q, v_q, k_sc, v_sc


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 entries times their scales, in f32, cast to the compute dtype."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
            cfg: ArchConfig, dtype: torch.dtype, query_tiles: bool = False) -> torch.Tensor:
    """The contraction every route shares: f32 scores of q (B, Sq, H, hd)
    against the head-expanded K (B, S, H, hd), masked where ``valid``
    (broadcast to (B, H, Sq, S)) is False, a full-row softmax, and the f32
    value contraction, cast to ``dtype``: (B, Sq, H, hd).

    ``query_tiles`` (the prefill routes) runs the value contraction in
    GEMMs of exactly QUERY_TILE query rows, the last one zero-padded, so a
    row's sum over the keys is reduced in the same order however many query
    rows share the call: on the H100, cuBLAS sums a row of a 16-row call in
    another order than the same row of a 128- or 2048-row call, and the
    suffix prefill's 16-row chunks would then differ from a cold
    admission's single-shot rows. Calls of 256 or more rows agree (scores
    and softmax agree at any row count), chip_smoke's ``chunked`` and
    ``prefix_cache`` phases hold that."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    s = s * (cfg.hd ** -0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    vf = v.to(torch.float32)
    if not query_tiles:
        return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(dtype)
    Sq = w.shape[2]
    pad = -Sq % QUERY_TILE
    if pad:
        w = torch.cat([w, w.new_zeros(w.shape[:2] + (pad, w.shape[3]))], dim=2)
    o = torch.cat([torch.einsum("bhqk,bkhd->bqhd", w[:, :, i:i + QUERY_TILE], vf)
                   for i in range(0, Sq + pad, QUERY_TILE)], dim=1)
    return o[:, :Sq].to(dtype)


def _out(p: Dict, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S = o.shape[:2]
    return L.pdot(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"], cfg)


def prefill_attention_with_kv(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                              positions: torch.Tensor,
                              int8_kv: bool = False) -> Tuple[torch.Tensor, ...]:
    """Full-sequence causal attention that also returns this layer's K/V rows
    as the cache stores them: ``(out, k_entry, v_entry)`` in the cache dtype,
    (B, S, KV, hd) each, or ``(out, k_q, v_q, k_scale, v_scale)`` on the
    int8-KV path (scales (B, S, KV)). Attends against the cache-dtype K/V,
    the same math decode reads back."""
    S = x.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    if int8_kv:
        entries = _quantize_kv(k_new, v_new)
        k = _dequant(entries[0], entries[2], x.dtype)
        v = _dequant(entries[1], entries[3], x.dtype)
    else:
        entries = (k_new.to(L.cdtype(cfg)), v_new.to(L.cdtype(cfg)))
        k, v = entries
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    o = _attend(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                causal[None, None], cfg, x.dtype, query_tiles=True)
    return (_out(p, o, cfg),) + tuple(entries)


def chunked_prefill_attention_with_kv(
        p: Dict, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
        chunk_start: int, k_acc: torch.Tensor, v_acc: torch.Tensor,
        k_sc_acc: Optional[torch.Tensor] = None,
        v_sc_acc: Optional[torch.Tensor] = None,
        int8_kv: bool = False) -> torch.Tensor:
    """One chunk of the chunked prefill-with-cache: write this chunk's K/V
    (x: (B, W, D)) into the cache-layout accumulators (B, S, KV, hd) at
    ``chunk_start``, IN PLACE (the caller owns them), and attend the chunk's
    queries over every accumulated row under the absolute causal mask.

    Returns the attention output (B, W, D). Scores are (B, H, W, S) per chunk instead of (B, H, S, S). Each query's
    softmax row is the single-shot path's row: rows not written yet lie in
    later chunks, past every query here, so they are masked to weight 0."""
    W = x.shape[1]
    S = k_acc.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    end = chunk_start + W
    if int8_kv:
        k_q, v_q, k_sc, v_sc = _quantize_kv(k_new, v_new)
        k_acc[:, chunk_start:end] = k_q
        v_acc[:, chunk_start:end] = v_q
        k_sc_acc[:, chunk_start:end] = k_sc
        v_sc_acc[:, chunk_start:end] = v_sc
        k = _dequant(k_acc, k_sc_acc, x.dtype)
        v = _dequant(v_acc, v_sc_acc, x.dtype)
    else:
        k_acc[:, chunk_start:end] = k_new.to(k_acc.dtype)
        v_acc[:, chunk_start:end] = v_new.to(v_acc.dtype)
        k, v = k_acc, v_acc
    qpos = chunk_start + torch.arange(W, device=x.device)[:, None]
    valid = torch.arange(S, device=x.device)[None, :] <= qpos
    o = _attend(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                valid[None, None], cfg, x.dtype, query_tiles=True)
    return _out(p, o, cfg)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, n_layers: int, batch: int, seq: int,
               dtype: torch.dtype, device=None) -> Dict:
    """Contiguous K/V rows (L, B, S, KV, hd) in ``dtype`` and a scalar
    index."""
    shape = (n_layers, batch, seq, cfg.n_kv, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def gather_block_kv(pool: Dict, tables: torch.Tensor) -> Dict:
    """Block-paged K/V gather: pool leaves (L, n_blocks, block_size, ...)
    and per-slot tables (B, MB) -> the contiguous view (L, B, MB * bs, ...)
    that :func:`decode_attention` reads, every slot's blocks in table order.
    Table entries past a lease name the null block 0; those positions lie
    past the slot's horizon, where decode gives them weight 0."""
    B, MB = tables.shape
    flat = tables.reshape(-1).long()
    out = {}
    for name, leaf in pool.items():
        g = leaf[:, flat]                                  # (L, B*MB, bs, ...)
        out[name] = g.reshape(leaf.shape[0], B, MB * leaf.shape[2], *leaf.shape[3:])
    return out


def _write_rows(leaf: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                ok: torch.Tensor, new: torch.Tensor) -> None:
    """``leaf[rows, pos] = new`` where ``ok``, the old entry elsewhere: the
    reference's scatter with mode="drop", with no host sync. One entry per
    row: a repeated cell would take either of its values."""
    keep = ok.reshape((-1,) + (1,) * (new.ndim - 1))
    leaf[rows, pos] = torch.where(keep, new.to(leaf.dtype), leaf[rows, pos])


def decode_attention(p: Dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, index: torch.Tensor, cfg: ArchConfig, *,
                     cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """One-token attention against contiguous cache rows (B, S, KV, hd) with
    a per-row ``index`` (B,): row b writes its new K/V at ``index[b]`` and
    attends positions ``<= index[b]``. Rows whose index ran past the rows
    (idle serving slots) write nothing. Writes land IN PLACE (the JAX engine
    donates the cache for the same effect); the input index is never
    modified, so a re-issued step rewrites the same cells with the same
    values. ``cache_scales`` (B, S, KV) x 2 selects the int8 KV cache.
    x: (B, 1, D); returns the attention output (B, 1, D)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None])
    ok = index < S
    pos = torch.clamp(index, max=S - 1).long()
    if cache_scales is not None:
        ks, vs = cache_scales
        k_q, v_q, k_sc, v_sc = _quantize_kv(k_new, v_new)
        for leaf, new in ((cache_k, k_q), (cache_v, v_q), (ks, k_sc), (vs, v_sc)):
            _write_rows(leaf, rows, pos, ok, new[:, 0])
        k = _dequant(cache_k, ks, x.dtype)
        v = _dequant(cache_v, vs, x.dtype)
    else:
        _write_rows(cache_k, rows, pos, ok, k_new[:, 0])
        _write_rows(cache_v, rows, pos, ok, v_new[:, 0])
        k, v = cache_k, cache_v
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= index[:, None, None, None]
    o = _attend(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                valid, cfg, x.dtype)
    return _out(p, o, cfg)


def paged_decode_attention(p: Dict, x: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           index: torch.Tensor, cfg: ArchConfig, *,
                           cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           use_kernel: bool = True) -> torch.Tensor:
    """Block-native single-token attention over ONE layer's pool
    (n_blocks, block_size, KV, hd). The new token's K/V is written into its
    slot's pool cell ``(tables[b, index[b] // bs], index[b] % bs)`` IN PLACE
    (the JAX engine donates the cache for the same effect); rows whose index
    ran past the slot extent (idle slots) clamp into their zeroed table, the
    null block 0, which no live slot reads unmasked. Running the step twice
    rewrites the same cells with the same values, so a re-issued step is
    harmless.

    Then the attention. With ``use_kernel`` and float KV it runs in the
    paged-attention kernel, which attends through the tables. Otherwise
    (``use_kernel=False``, or the int8 KV cache, ``cache_scales`` (NB, bs,
    KV) x 2) this layer's table-addressed rows are gathered into a transient
    (B, MB * bs) view and attended with exactly :func:`decode_attention`'s
    math, so tokens equal the gather bridge's and the contiguous store's.
    The int8 KV cache always takes that plain contraction, as in the JAX
    package: the kernel reads float pools only, and this is the reference's
    route for int8, not a fallback. x: (B, 1, D); returns (B, 1, D)."""
    B = x.shape[0]
    bs = pool_k.shape[1]
    S = tables.shape[1] * bs
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None])
    pos = torch.clamp(index, max=S - 1).long()
    phys = tables[rows, pos // bs].long()
    off = pos % bs
    if cache_scales is not None:
        pks, pvs = cache_scales
        k_q, v_q, k_sc, v_sc = _quantize_kv(k_new, v_new)
        for leaf, new in ((pool_k, k_q), (pool_v, v_q), (pks, k_sc), (pvs, v_sc)):
            leaf[phys, off] = new[:, 0]
    else:
        pool_k[phys, off] = k_new[:, 0].to(pool_k.dtype)
        pool_v[phys, off] = v_new[:, 0].to(pool_v.dtype)
    if use_kernel and cache_scales is None:
        o = _paged_kernel(q[:, 0].to(torch.float32).contiguous(), pool_k, pool_v,
                          tables, index)
        o = o[:, None].to(x.dtype)
    else:
        flat = tables.reshape(-1).long()

        def rows_of(pool):                          # (B, S, ...) view of one layer
            return pool[flat].reshape(B, S, *pool.shape[2:])
        if cache_scales is not None:
            k = _dequant(rows_of(pool_k), rows_of(cache_scales[0]), x.dtype)
            v = _dequant(rows_of(pool_v), rows_of(cache_scales[1]), x.dtype)
        else:
            k, v = rows_of(pool_k), rows_of(pool_v)
        valid = (torch.arange(S, device=x.device)[None, None, None, :]
                 <= index[:, None, None, None])
        o = _attend(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                    valid, cfg, x.dtype)
    return _out(p, o, cfg)


# ---------------------------------------------------------------------------
# speculative verify: a window of W queries per row
# ---------------------------------------------------------------------------

def _attend_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, cfg: ArchConfig,
                   dtype: torch.dtype) -> torch.Tensor:
    """The verify window's contraction as W one-query contractions of
    exactly decode's shapes: query j of q (B, W, H, hd) attends keys
    ``kpos <= positions[:, j]`` of the head-expanded K/V (B, S, H, hd),
    through the call :func:`decode_attention` makes. A row's score and
    value sums are then reduced in decode's order whatever W is (on the
    H100, cuBLAS may sum a row of a multi-row call in another order than
    the same row alone), so window position j keeps the bits of the decode
    step it stands for. Returns (B, W, H, hd) in ``dtype``."""
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    return torch.cat([
        _attend(q[:, j:j + 1].contiguous(), k, v,
                kpos <= positions[:, j, None, None, None], cfg, dtype)
        for j in range(q.shape[1])], dim=1)


def verify_decode_attention(p: Dict, x: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, positions: torch.Tensor,
                            cfg: ArchConfig, *,
                            cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                            ) -> torch.Tensor:
    """Speculative-verify attention against contiguous rows (B, S, KV, hd):
    x (B, W, D) is each row's window, at absolute ``positions`` (B, W) =
    index + arange(W). All W new K/V entries are written into the rows
    first, IN PLACE (positions past the rows are dropped), then query j
    attends ``kpos <= positions[:, j]``: entries of later window positions
    get weight exactly 0, as if not yet written. The visible entries are
    the bits sequential :func:`decode_attention` steps write, and each
    query's contraction is decode's (:func:`_attend_window`), so window
    position j's output is the decode step's after j accepted tokens.
    Rejected entries are real writes; the engine scrubs them through the
    store's rollback. ``cache_scales`` selects the int8 KV cache. Returns
    the attention output (B, W, D)."""
    B, W = x.shape[:2]
    S = cache_k.shape[1]
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    ok = positions < S
    pos = torch.clamp(positions, max=S - 1).long()
    if cache_scales is not None:
        leaves = (cache_k, cache_v) + tuple(cache_scales)
        news = _quantize_kv(k_new, v_new)
    else:
        leaves, news = (cache_k, cache_v), (k_new, v_new)
    # column by column: a clamped (dropped) entry must not race a real one
    for j in range(W):
        for leaf, new in zip(leaves, news):
            _write_rows(leaf, rows, pos[:, j], ok[:, j], new[:, j])
    if cache_scales is not None:
        k = _dequant(cache_k, cache_scales[0], x.dtype)
        v = _dequant(cache_v, cache_scales[1], x.dtype)
    else:
        k, v = cache_k, cache_v
    o = _attend_window(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                       positions, cfg, x.dtype)
    return _out(p, o, cfg)


def paged_verify_attention(p: Dict, x: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor, cfg: ArchConfig, *,
                           cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                           ) -> torch.Tensor:
    """Block-native speculative verify over ONE layer's pool
    (n_blocks, block_size, KV, hd): :func:`verify_decode_attention`'s
    write-then-attend addressed through the block tables. Window positions
    past the slot extent go to the reserved null block 0 instead of a live
    cell, so a window at the end of a lease never corrupts a leased
    position. Then this layer's table-addressed rows are gathered into a
    transient (B, MB * bs) view and attended with
    :func:`paged_decode_attention`'s plain math, W queries wide. The
    paged-attention kernel is a one-query decode kernel and takes no part
    (the engine refuses ``speculative`` with ``paged_kernel``, as the JAX
    package does). Returns (B, W, D)."""
    B = x.shape[0]
    bs = pool_k.shape[1]
    S = tables.shape[1] * bs
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    in_range = positions < S
    pos_c = torch.clamp(positions, max=S - 1).long()
    phys = torch.where(in_range, tables[rows[:, None], pos_c // bs].long(), 0)
    off = torch.where(in_range, pos_c % bs, 0)
    if cache_scales is not None:
        pks, pvs = cache_scales
        k_q, v_q, k_sc, v_sc = _quantize_kv(k_new, v_new)
        for leaf, new in ((pool_k, k_q), (pool_v, v_q), (pks, k_sc), (pvs, v_sc)):
            leaf[phys, off] = new
    else:
        pool_k[phys, off] = k_new.to(pool_k.dtype)
        pool_v[phys, off] = v_new.to(pool_v.dtype)
    flat = tables.reshape(-1).long()

    def rows_of(pool):                          # (B, S, ...) view of one layer
        return pool[flat].reshape(B, S, *pool.shape[2:])
    if cache_scales is not None:
        k = _dequant(rows_of(pool_k), rows_of(cache_scales[0]), x.dtype)
        v = _dequant(rows_of(pool_v), rows_of(cache_scales[1]), x.dtype)
    else:
        k, v = rows_of(pool_k), rows_of(pool_v)
    o = _attend_window(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                       positions, cfg, x.dtype)
    return _out(p, o, cfg)
