"""Attention: QKV projection (RoPE, M-RoPE, qk_norm), fused and chunked
prefill that emit cache-layout K/V, contiguous decode, block-native paged
decode, the full-sequence attention of the encoder-decoder (plain and
online-softmax chunked, causal, bidirectional and cross) and its cross
decode step.

The port of ``repro.models.attention``, float and int8 KV, with the
speculative verify window (``verify_decode_attention``,
``paged_verify_attention``).
Every score and value contraction runs in f32 against the cache-dtype K/V
(int8 entries dequantized first, exactly as decode reads them back), the
math of the reference's ``decode_attention``, so that a cache seeded by any
admission route decodes the same tokens. Float-KV block-native decode can
run in the paged-attention kernel. Every prefill query runs as a one-query
decode contraction (``DecodeRows``: through the kernel on the engine's
kernel route, plain otherwise), so a prefill row keeps the bits of the
decode step at its position and a stream re-admitted by fused prefill (a
drain handoff, a lost host) continues exactly.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.paged_attention import paged_decode_attention as _paged_kernel
from repro_torch.models import layers as L

NEG_INF = -1e30
QMAX = 127.0


def init_attn(gen: torch.Generator, cfg: ArchConfig, d: int, device=None) -> Dict:
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": L.dense_init(gen, (d, H * hd), device=device),
        "wk": L.dense_init(gen, (d, KV * hd), device=device),
        "wv": L.dense_init(gen, (d, KV * hd), device=device),
        "wo": L.dense_init(gen, (H * hd, d), device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def attn_specs(cfg: ArchConfig) -> Dict:
    """Partition specs of :func:`init_attn`'s leaves. The flat projection
    columns (H * hd) divide the model axis even where the head count does
    not, so weights always shard; only the activation layout
    (:func:`_heads_spec`) is gated."""
    m = "model"
    p = {"wq": (None, m), "wk": (None, m), "wv": (None, m), "wo": (m, None)}
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def _divisible_model(n: int) -> bool:
    try:
        return n % shd.model_parallel_size() == 0
    except RuntimeError:
        return True


def _heads_spec(cfg: ArchConfig, n_heads: Optional[int] = None) -> Tuple:
    """Head-axis sharding of q/k/v (B, S, heads, hd), only where the head
    count divides the model axis (qwen3's 40, qwen2-vl's 12 and xlstm's 4
    heads replicate on the pod meshes)."""
    n = cfg.n_heads if n_heads is None else n_heads
    m = "model" if (cfg.shard_heads and _divisible_model(n)) else None
    return shd.batch_spec(None, m, None)


def cache_spec(cfg: ArchConfig, seq_shard: bool) -> Tuple:
    """Cache rows (B, S, KV, hd): batch over the data axes, the sequence
    over data instead where the batch cannot cover it (SP, long contexts),
    KV heads over model where they divide it."""
    names = ()
    try:
        names = shd.axis_names()
    except RuntimeError:
        pass
    model = ("model" if ("model" in names and cfg.shard_heads
                         and _divisible_model(cfg.n_kv)) else None)
    if seq_shard:
        return (None, "data", model, None)
    b = shd.batch_axes()
    lead = b if len(b) > 1 else (b[0] if b else None)
    return (lead, None, model, None)


def _rotate(t: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
            positions3: Optional[torch.Tensor]) -> torch.Tensor:
    """q or k (B, S, heads, hd) rotated by the config's position encoding:
    RoPE at ``positions`` (B, S), M-RoPE at ``positions3`` (3, B, S), or
    none."""
    if cfg.rope_kind == "mrope":
        if positions3 is None:
            raise ValueError("mrope requires (3, B, S) positions3")
        return L.apply_mrope(t, positions3, cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope_kind == "rope":
        return L.apply_rope(t, positions, cfg.rope_theta)
    if cfg.rope_kind != "none":
        raise ValueError(f"rope_kind {cfg.rope_kind!r}: expected rope, mrope or none")
    return t


def _project_q(p: Dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
               positions3: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S, _ = x.shape
    q = L.pdot(x, p["wq"], cfg).reshape(B, S, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = L.rms_head_norm(q, p["q_norm"])
    return _rotate(q, cfg, positions, positions3)


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                 positions3: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """q (B, S, H, hd), k and v (B, S, KV, hd): the projections, qk_norm,
    then the position encoding of q and k."""
    B, S, _ = x.shape
    KV, hd = cfg.n_kv, cfg.hd
    q = _project_q(p, x, cfg, positions, positions3)
    k = L.pdot(x, p["wk"], cfg).reshape(B, S, KV, hd)
    v = L.pdot(x, p["wv"], cfg).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        k = L.rms_head_norm(k, p["k_norm"])
    return q, _rotate(k, cfg, positions, positions3), v


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


def _layout(k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V rows (B, S, KV, hd) as the one-query contraction's f32 operands,
    contiguous, one copy each: K transposed (B, KV, hd, S) and V
    (B, KV, S, hd)."""
    B, S, KV, hd = k.shape
    kt = k.new_empty((B, KV, hd, S), dtype=torch.float32)
    vg = v.new_empty((B, KV, S, hd), dtype=torch.float32)
    kt.copy_(k.permute(0, 2, 3, 1))
    vg.copy_(v.permute(0, 2, 1, 3))
    return kt, vg


# rows per call of the one-query contraction: decode, verify and prefill
# calls all have exactly this many, zero-padded (:func:`_attend`)
ATTEND_ROWS = 64


def _attend(q: torch.Tensor, kt: torch.Tensor, vg: torch.Tensor, valid: torch.Tensor,
            cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    """The one-query contraction every plain route shares: f32 scores of q
    (B, 1, H, hd) against K (``kt``, :func:`_layout`), each KV head's H/KV
    query heads in one product (no head expansion), masked where ``valid``
    (B, 1, 1, S) is False, a full-row softmax, and the f32 value
    contraction against ``vg``, cast to ``dtype``: (B, 1, H, hd).

    The rows run in calls of exactly ATTEND_ROWS, the last padded with zero
    queries masked everywhere, so every call of a decode step, a verify
    position or a prefill has one shape: cuBLAS picks its kernel, and with
    it the order of a row's sums, by the call's shape (on the H100 a row's
    bits change with the row count; scripts/torch_row_invariance.py
    ``decode_rows``), and a prefill row keeps the bits of the decode step
    at its position."""
    B, _, H, hd = q.shape
    KV, S = kt.shape[1], kt.shape[3]
    rep, m = H // KV, ATTEND_ROWS
    pad = -B % m
    valid = valid.expand(B, 1, 1, S)
    if pad:
        q, kt, vg, valid = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                            for t in (q, kt, vg, valid))
    out = []
    for lo in range(0, B + pad, m):
        sc = torch.bmm(q[lo:lo + m].to(torch.float32).reshape(m * KV, rep, hd),
                       kt[lo:lo + m].reshape(m * KV, hd, S))
        sc = sc.reshape(m, KV, rep, S) * (cfg.hd ** -0.5)
        w = torch.softmax(torch.where(valid[lo:lo + m], sc, torch.full_like(sc, NEG_INF)),
                          dim=-1)
        o = torch.bmm(w.reshape(m * KV, rep, S), vg[lo:lo + m].reshape(m * KV, S, hd))
        out.append(o.reshape(m, 1, H, hd))
    return torch.cat(out)[:B].to(dtype)


class DecodeRows(NamedTuple):
    """The decode step whose bits a prefill row keeps: its key length (the
    cache row's, ``max_seq_len``) and, on the kernel route, the pool's block
    size (None: the plain contraction)."""

    length: int
    block_size: Optional[int] = None


def _pad_keys(x: torch.Tensor, length: int) -> torch.Tensor:
    """K/V rows (B, S, KV, hd) zero-padded to ``length`` positions."""
    B, S = x.shape[:2]
    return torch.cat([x, x.new_zeros((B, length - S) + x.shape[2:])], dim=1)


def decode_row_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, rows: DecodeRows) -> Tuple[torch.Tensor, ...]:
    """The paged-attention kernel's operands for prefill queries as one-query
    decode rows (``rows.block_size`` set): query j of row b of q
    (B, Sq, H, hd) becomes kernel row b * Sq + j with horizon
    ``positions[b, j]``; row b's K/V (B, S, KV, hd), zero-padded to
    ``rows.length`` positions, are the blocks of a scratch pool after a
    zeroed null block, and every kernel row of b has b's table, decode's
    width ``rows.length // rows.block_size`` (the kernel's plan reads only
    the table width, block size and heads). Returns ``(q (B*Sq, H, hd) f32,
    pool_k, pool_v, tables (B*Sq, width), horizons (B*Sq,))``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    bs = rows.block_size
    width = rows.length // bs

    def pool(x):
        return torch.cat([x.new_zeros((1, bs, KV, hd)),
                          _pad_keys(x, rows.length).reshape(B * width, bs, KV, hd)])
    tables = 1 + torch.arange(B * width, dtype=torch.int32, device=q.device).reshape(B, width)
    return (q.reshape(B * Sq, H, hd).to(torch.float32).contiguous(), pool(k), pool(v),
            tables.repeat_interleave(Sq, dim=0),
            positions.to(torch.int32).reshape(B * Sq).contiguous())


def _decode_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, rows: DecodeRows, cfg: ArchConfig,
                 dtype: torch.dtype) -> torch.Tensor:
    """Every prefill query as a one-query decode contraction: query j of row
    b of q (B, Sq, H, hd) attends positions ``<= positions[b, j]`` of that
    row's K/V (B, S, KV, hd), zero-padded to the decode row's
    ``rows.length`` keys, through the call decode makes, so each query's
    sums run in the order of the decode step at its position and a stream
    re-admitted by prefill (a drain handoff, a lost host) continues exactly.

    On the kernel route (``rows.block_size``) that call is the
    paged-attention kernel (:func:`decode_row_operands`). Otherwise it is
    :func:`_attend` on one query per row against ``rows.length`` keys,
    ATTEND_ROWS queries at a time, over K/V laid out once per call
    (:func:`_layout`, the values decode's call lays out). Returns
    (B, Sq, H, hd) in ``dtype``."""
    B, Sq, H, hd = q.shape
    if k.shape[1] > rows.length:
        raise ValueError(f"{k.shape[1]} prefill positions exceed the decode row's "
                         f"{rows.length}")
    if rows.block_size is not None:
        o = _paged_kernel(*decode_row_operands(q, k, v, positions, rows))
        return o.reshape(B, Sq, H, hd).to(dtype)
    n, m = B * Sq, ATTEND_ROWS
    kt, vg = _layout(_pad_keys(k, rows.length), _pad_keys(v, rows.length))
    qf = q.reshape(n, 1, H, hd)
    valid = (torch.arange(rows.length, device=q.device)[None, None, None, :]
             <= positions.reshape(n, 1, 1, 1))
    b = torch.arange(n, device=q.device) // Sq
    out = [_attend(qf[lo:lo + m], kt[b[lo:lo + m]], vg[b[lo:lo + m]], valid[lo:lo + m],
                   cfg, dtype)
           for lo in range(0, n, m)]
    return torch.cat(out).reshape(B, Sq, H, hd)


def _out(p: Dict, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S = o.shape[:2]
    return L.pdot(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"], cfg)


def prefill_attention_with_kv(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                              positions: torch.Tensor,
                              positions3: Optional[torch.Tensor] = None,
                              int8_kv: bool = False,
                              decode_rows: Optional[DecodeRows] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """Full-sequence causal attention that also returns this layer's K/V rows
    as the cache stores them: ``(out, k_entry, v_entry)`` in the cache dtype,
    (B, S, KV, hd) each, or ``(out, k_q, v_q, k_scale, v_scale)`` on the
    int8-KV path (scales (B, S, KV)). Attends against the cache-dtype K/V,
    the same math decode reads back, each query as a one-query decode
    contraction (:func:`_decode_rows`) of ``decode_rows``, by default the
    plain one over the S prefill positions. M-RoPE configs take
    ``positions3`` (3, B, S); the causal mask reads ``positions``."""
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, positions3)
    if int8_kv:
        entries = _quantize_kv(k_new, v_new)
        k = _dequant(entries[0], entries[2], x.dtype)
        v = _dequant(entries[1], entries[3], x.dtype)
    else:
        entries = (k_new.to(L.cdtype(cfg)), v_new.to(L.cdtype(cfg)))
        k, v = entries
    o = _decode_rows(q, k, v, positions, decode_rows or DecodeRows(x.shape[1]), cfg, x.dtype)
    return (_out(p, o, cfg),) + tuple(entries)


def chunked_prefill_attention_with_kv(
        p: Dict, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
        chunk_start: int, k_acc: torch.Tensor, v_acc: torch.Tensor,
        k_sc_acc: Optional[torch.Tensor] = None,
        v_sc_acc: Optional[torch.Tensor] = None,
        int8_kv: bool = False,
        decode_rows: Optional[DecodeRows] = None) -> torch.Tensor:
    """One chunk of the chunked prefill-with-cache: write this chunk's K/V
    (x: (B, W, D)) into the cache-layout accumulators (B, S, KV, hd) at
    ``chunk_start``, IN PLACE (the caller owns them), and attend the chunk's
    queries over every accumulated row under the absolute causal mask.

    Returns the attention output (B, W, D). Scores are (B, H, W, S) per
    chunk instead of (B, H, S, S). Each query's softmax row is the
    single-shot path's row: rows not written yet lie in later chunks, past
    every query here, so they are masked to weight 0. Each query runs as a
    one-query decode contraction of ``decode_rows`` (by default the plain
    one over the accumulators' S positions), as in the fused path."""
    W = x.shape[1]
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
    o = _decode_rows(q, k, v, positions, decode_rows or DecodeRows(k_acc.shape[1]), cfg,
                     x.dtype)
    return _out(p, o, cfg)


# ---------------------------------------------------------------------------
# full-sequence attention: the encoder-decoder's encoder, decoder and cross
# ---------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: each KV head repeated for its query heads, (B, S, KV, hd) ->
    (B, S, H, hd)."""
    rep = n_heads // k.shape[2]
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    """Materialized scores, as the reference's: the q . k product in the
    compute dtype (an f32 sum rounded once to it), scaled and softmaxed in
    f32, the weights cast to v's dtype, the value product rounded to it.
    q (B, Sq, H, hd), k and v (B, Sk, H, hd)."""
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    f32 = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)).to(q.dtype).to(f32)
    s = s * (hd ** -0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(f32), v.to(f32)).to(v.dtype)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, chunk: int) -> torch.Tensor:
    """The online-softmax scan over K/V chunks of ``chunk`` positions, all
    in f32 (the reference's ``impl="f32"``): per chunk the scores of the
    pre-scaled queries, the running max ``m``, the rescaled sum ``l`` and
    output ``o``; then ``o / max(l, 1e-30)`` cast to q's dtype. K/V are
    zero-padded to whole chunks, the padding masked."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    f32 = torch.float32
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad, H, hd))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, H, hd))], dim=1)
    qf = q.to(f32) * (hd ** -0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=f32, device=q.device)
    o = torch.zeros((B, Sq, H, hd), dtype=f32, device=q.device)
    for c in range(n_chunks):
        kb, vb = (t[:, c * chunk:(c + 1) * chunk].to(f32) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kpos = c * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = (kpos < Sk) if not causal else ((kpos <= qpos) & (kpos < Sk))
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = (o * corr[..., 0].transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, vb))
        m = m_new
    o = o / torch.clamp_min(l[..., 0].transpose(1, 2)[..., None], 1e-30)
    return o.to(q.dtype)


def attention(p: Dict, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
              positions3: Optional[torch.Tensor] = None, causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full-sequence attention, the reference's ``attention``: x (B, S, D)
    projected, its K/V (or ``kv``, the cross-attention's K/V from
    :func:`project_kv_for_cross`, which makes it non-causal) expanded to
    the query heads, then the plain form, or the online-softmax form when
    ``max(S, Sk)`` exceeds ``cfg.attn_chunk``. Returns (B, S, D)."""
    B, S, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions, positions3)
    else:
        q, (k, v) = _project_q(p, x, cfg, positions, positions3), kv
        causal = False
    k, v = _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads)
    if max(S, k.shape[1]) > cfg.attn_chunk:
        if cfg.attn_impl != "f32":
            raise ValueError(f"attn_impl {cfg.attn_impl!r}: the port runs the f32 "
                             f"online softmax")
        o = _chunked_attention(q, k, v, causal, cfg.attn_chunk)
    else:
        o = _plain_attention(q, k, v, causal)
    return _out(p, o, cfg)


def project_kv_for_cross(p: Dict, enc_out: torch.Tensor,
                         cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K/V (B, Se, KV, hd) from the encoder's output:
    the wk and wv projections, no position encoding."""
    B, S, _ = enc_out.shape
    k = L.pdot(enc_out, p["wk"], cfg).reshape(B, S, cfg.n_kv, cfg.hd)
    v = L.pdot(enc_out, p["wv"], cfg).reshape(B, S, cfg.n_kv, cfg.hd)
    return k, v


def cross_decode_attention(p: Dict, x: torch.Tensor, cross_k: torch.Tensor,
                           cross_v: torch.Tensor, positions: torch.Tensor,
                           cfg: ArchConfig) -> torch.Tensor:
    """The encdec decode step's cross-attention: the query of x (B, 1, D)
    at ``positions`` (B, 1) attends every position of the cross cache rows
    (B, Se, KV, hd), which it does not write: the reference's
    ``decode_attention(..., index=Se - 1, update_cache=False)``, whose K/V
    projections of x are dropped, so none is made here. Decode's one-query
    contraction. Returns (B, 1, D)."""
    q = _project_q(p, x, cfg, positions)
    valid = torch.ones((1, 1, 1, cross_k.shape[1]), dtype=torch.bool, device=x.device)
    o = _attend(q, *_layout(cross_k, cross_v), valid, cfg, x.dtype)
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
                     cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     positions3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention against contiguous cache rows (B, S, KV, hd) with
    a per-row ``index`` (B,): row b writes its new K/V at ``index[b]`` and
    attends positions ``<= index[b]``. Rows whose index ran past the rows
    (idle serving slots) write nothing. Writes land IN PLACE (the JAX engine
    donates the cache for the same effect); the input index is never
    modified, so a re-issued step rewrites the same cells with the same
    values. ``cache_scales`` (B, S, KV) x 2 selects the int8 KV cache;
    ``positions3`` (3, B, 1) the M-RoPE positions. x: (B, 1, D); returns the
    attention output (B, 1, D)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None], positions3)
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
    o = _attend(q, *_layout(k, v), valid, cfg, x.dtype)
    return _out(p, o, cfg)


def paged_decode_attention(p: Dict, x: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           index: torch.Tensor, cfg: ArchConfig, *,
                           cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           use_kernel: bool = True,
                           positions3: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    route for int8, not a fallback. ``positions3`` (3, B, 1): the M-RoPE
    positions. x: (B, 1, D); returns (B, 1, D)."""
    B = x.shape[0]
    bs = pool_k.shape[1]
    S = tables.shape[1] * bs
    rows = torch.arange(B, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None], positions3)
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
        o = _attend(q, *_layout(k, v), valid, cfg, x.dtype)
    return _out(p, o, cfg)


# ---------------------------------------------------------------------------
# speculative verify: a window of W queries per row
# ---------------------------------------------------------------------------

def _attend_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, cfg: ArchConfig,
                   dtype: torch.dtype) -> torch.Tensor:
    """The verify window's contraction as W one-query contractions of
    exactly decode's shapes: query j of q (B, W, H, hd) attends keys
    ``kpos <= positions[:, j]`` of K/V (B, S, KV, hd),
    through the call :func:`decode_attention` makes. A row's score and
    value sums are then reduced in decode's order whatever W is (on the
    H100, cuBLAS may sum a row of a multi-row call in another order than
    the same row alone), so window position j keeps the bits of the decode
    step it stands for. Returns (B, W, H, hd) in ``dtype``."""
    kt, vg = _layout(k, v)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    return torch.cat([
        _attend(q[:, j:j + 1].contiguous(), kt, vg,
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
    o = _attend_window(q, k, v, positions, cfg, x.dtype)
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
    o = _attend_window(q, k, v, positions, cfg, x.dtype)
    return _out(p, o, cfg)
