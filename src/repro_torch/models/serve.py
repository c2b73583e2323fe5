"""Serving path: cache construction, fused, chunked and suffix
prefill-with-cache, contiguous decode, block-native paged decode and the
speculative verify window on both layouts — the port of
``repro.models.serve``'s dense subset, float and int8 KV.

Cache dicts (dense family):
  contiguous  {"k", "v": (L, B, S, KV, hd), "index": (B,)}
  paged       {"k", "v": (L, NB, bs, KV, hd), "index": (B,), "tables": (B, MB)}
plus {"k_scale", "v_scale"} (the same shapes without hd, f32) with the int8
KV cache, whose entries are int8.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M


def _kv_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.int8 if cfg.kv_cache_dtype == "int8" else L.cdtype(cfg)


def _with_scales(cfg: ArchConfig, cache: Dict, shape, device) -> Dict:
    """Add the int8 KV cache's dequant scales (``shape`` without hd), parked
    at 1e-12 so a pristine entry dequantizes to exactly 0. Two allocations:
    one buffer under both names would alias the leaves."""
    if cfg.kv_cache_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.full(shape, 1e-12, dtype=torch.float32, device=device)
    return cache


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(f"the port's serving cache is a dense-family layout, not "
                         f"{cfg.family} (other families: ROADMAP queue 1 item 11)")


def init_cache(cfg: ArchConfig, batch: int, seq: int, *,
               per_slot_index: bool = False, device=None) -> Dict:
    """Contiguous serving cache: K/V rows (L, B, S, KV, hd) in the cache
    dtype (+ int8 scales), and the index: (B,) per slot with
    ``per_slot_index`` (the continuous-batching layout), else ()."""
    _check_dense(cfg)
    cache = A.init_cache(cfg, cfg.n_layers, batch, seq, _kv_dtype(cfg), device=device)
    if per_slot_index:
        cache["index"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return _with_scales(cfg, cache, (cfg.n_layers, batch, seq, cfg.n_kv), device)


def init_paged_cache(cfg: ArchConfig, n_slots: int, n_blocks: int,
                     block_size: int, blocks_per_slot: int, device=None) -> Dict:
    """Block-paged serving cache: K/V pools (L, NB, bs, KV, hd) in the cache
    dtype (+ int8 scales (L, NB, bs, KV)), addressed through per-slot block
    tables (B, MB); per-slot index (B,). Block 0 is the reserved null block
    (serving/store.py)."""
    _check_dense(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv, cfg.hd)
    cache = {
        "k": torch.zeros(shape, dtype=_kv_dtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=_kv_dtype(cfg), device=device),
        "index": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "tables": torch.zeros((n_slots, blocks_per_slot), dtype=torch.int32,
                              device=device),
    }
    return _with_scales(cfg, cache, shape[:-1], device)


# ===========================================================================
# prefill-with-cache: one forward that seeds serving slots
# ===========================================================================

def prefill_with_cache(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                       decode_rows: Optional[A.DecodeRows] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Fused admission prefill: one full-sequence forward over right-padded
    prompts returning (logits, kv) with kv in cache layout, ready to scatter
    into leased slots (serving/store.py ``write_slots``). ``decode_rows``:
    the decode row whose one-query contraction each query runs
    (models/attention.py; by default the plain one over the S positions)."""
    return M.forward(params, cfg, tokens, decode_rows=decode_rows)


def prefill_with_cache_chunked(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                               last_index: torch.Tensor, chunk: int,
                               decode_rows: Optional[A.DecodeRows] = None
                               ) -> Tuple[torch.Tensor, Dict]:
    """Chunked admission prefill: the right-padded bucket (B, S) goes
    through the stack ``chunk`` tokens at a time, each chunk attending over
    everything written so far (models/attention.py
    ``chunked_prefill_attention_with_kv``). Returns ``(row, kv)``: each row's
    last-prompt-position logits (B, V_pad) in f32 and the K/V in cache
    layout, bitwise the single-shot path's. Peak score memory is
    (B, H, chunk, S), linear in S. The vocab projection runs once per row,
    on the carried ``last_index`` hidden state, never on (B, S, V)."""
    if tokens.shape[1] % chunk:
        raise ValueError(f"chunk {chunk} must divide the bucket length {tokens.shape[1]}")
    return _chunked_prefill(params, cfg, tokens, last_index, None, 0, chunk, decode_rows)


def prefill_with_cache_suffix(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                              last_index: torch.Tensor, chunk: int, kv0: Dict,
                              start_chunk: int, width: Optional[int] = None,
                              decode_rows: Optional[A.DecodeRows] = None
                              ) -> Tuple[torch.Tensor, Dict]:
    """Suffix admission prefill (shared-prefix cache hits): the chunked scan
    resumed at position ``start_chunk * chunk`` (``chunk``: the paged block
    size). ``kv0`` (L, B, S, ...) holds the cached prefix entries gathered
    from the leased blocks (serving/store.py ``gather_prefix_rows``), the
    very bits a cold admission wrote there. The rest of the bucket runs in
    pieces of ``width`` positions (None: one piece), each by the chunk body
    of the cold scan; a row's math does not depend on which piece carries
    it, so row and K/V equal a cold admission's bit for bit. The JAX
    package scans block-size pieces, one compiled program for every start;
    here one piece issues one pass of the layer stack from the host instead
    of one per block. ``kv0`` is copied, never written: a re-issued step
    starts from the same accumulators. The engine keeps ``last_index`` at
    or after the start."""
    return _chunked_prefill(params, cfg, tokens, last_index, kv0, start_chunk * chunk,
                            width or tokens.shape[1] - start_chunk * chunk, decode_rows)


def _chunked_prefill(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                     last_index: torch.Tensor, kv0: Optional[Dict], start: int,
                     width: int, decode_rows: Optional[A.DecodeRows] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """The chunked and suffix prefill's shared body: zeroed (cold) or
    ``kv0``-seeded accumulators, then positions ``start..S - 1`` in pieces of
    ``width`` (the last may be shorter), one chunk body for both."""
    _check_dense(cfg)
    B, S = tokens.shape
    int8_kv = cfg.kv_cache_dtype == "int8"
    names = M.kv_names(cfg)
    dev = tokens.device
    if kv0 is None:
        kv = init_cache(cfg, B, S, device=dev)
        del kv["index"]
    else:
        kv = {n: kv0[n].clone() for n in names}
    last_x = torch.zeros((B, cfg.d_model), dtype=L.cdtype(cfg), device=dev)
    rows = torch.arange(B, device=dev)
    for lo in range(start, S, width):
        w = min(width, S - lo)
        positions = (lo + torch.arange(w, dtype=torch.int32, device=dev)).expand(B, w)
        x = M.embed_tokens(params, cfg, tokens[:, lo:lo + w])
        for i in range(cfg.n_layers):
            lp = M.layer_params(params["layers"], i)
            h = L.apply_norm(lp["ln1"], x, cfg)
            accs = {n: kv[n][i] for n in names}
            x = x + A.chunked_prefill_attention_with_kv(
                lp["attn"], h, cfg, positions=positions, chunk_start=lo,
                k_acc=accs["k"], v_acc=accs["v"], k_sc_acc=accs.get("k_scale"),
                v_sc_acc=accs.get("v_scale"), int8_kv=int8_kv, decode_rows=decode_rows)
            h = L.apply_norm(lp["ln2"], x, cfg)
            x = x + L.apply_mlp(lp["mlp"], h, cfg)
        # carry each row's last-prompt-position hidden state
        rel = last_index.long() - lo
        in_piece = (rel >= 0) & (rel < w)
        row = x[rows, torch.clamp(rel, 0, w - 1)]
        last_x = torch.where(in_piece[:, None], row, last_x)
    logits = M._logits(params, cfg, last_x[:, None, :])
    return logits[:, 0, :].to(torch.float32), kv


# ===========================================================================
# decode: one token against the cache
# ===========================================================================

def _decode_layers(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                   attend) -> torch.Tensor:
    """The decode stack shared by the contiguous and paged layouts:
    ``attend(layer_params, h, i, scales)`` runs layer i's attention (writing
    its cache leaves in place). Returns the logits (B, T, V_pad) of tokens
    (B, T): one position per slot at decode, the window at verify (the
    RMSNorm's row sums do not depend on T: layers.apply_norm)."""
    int8_kv = "k_scale" in cache
    x = M.embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = M.layer_params(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg)
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if int8_kv else None
        x = x + attend(lp["attn"], h, i, scales)
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], h, cfg)
    return M._head(params, cfg, L.apply_norm(params["final_ln"], x, cfg))


def decode(params: Dict, cfg: ArchConfig, cache: Dict,
           tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode against contiguous rows with a per-slot index.
    ``tokens`` is (B, 1). Every layer writes the new token's K/V at its
    row's index, in place, and attends positions up to it. Returns
    ``(logits, cache)``: the same leaf tensors and a NEW index tensor
    ``index + 1`` (the input index is never modified, so a re-issued step
    sees the same positions)."""
    _check_dense(cfg)
    index = cache["index"]

    def attend(lp, h, i, scales):
        return A.decode_attention(lp, h, cache["k"][i], cache["v"][i], index, cfg,
                                  cache_scales=scales)
    return _decode_layers(params, cfg, cache, tokens, attend), dict(cache, index=index + 1)


def decode_paged(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor, *,
                 use_kernel: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Block-native single-token decode over the paged pool. ``tokens`` is
    (B, 1). Each layer writes the new token's K/V into its pool cell through
    the tables, in place, and attends block-natively: through the
    paged-attention kernel with ``use_kernel`` and float KV, else by the
    plain per-layer gather and contraction (models/attention.py
    ``paged_decode_attention``). Returns ``(logits, cache)``: the same pool
    tensors and a NEW index tensor ``index + 1``."""
    _check_dense(cfg)
    index, tables = cache["index"], cache["tables"]

    def attend(lp, h, i, scales):
        return A.paged_decode_attention(lp, h, cache["k"][i], cache["v"][i], tables,
                                        index, cfg, cache_scales=scales,
                                        use_kernel=use_kernel)
    return _decode_layers(params, cfg, cache, tokens, attend), dict(cache, index=index + 1)


# ===========================================================================
# speculative verify: score a k+1-token window in one forward
# ===========================================================================

def _window_positions(cache: Dict, tokens: torch.Tensor, window: int) -> torch.Tensor:
    B, W = tokens.shape
    if W != window:
        raise ValueError(f"verify window of {W} tokens, the step was built for {window}")
    return cache["index"][:, None] + torch.arange(W, dtype=torch.int32, device=tokens.device)


def verify_window(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                  window: int) -> Tuple[torch.Tensor, Dict]:
    """Speculative-verify forward over contiguous rows: ``tokens`` (B, W) is
    each row's last emitted token and W-1 draft proposals, all scored in one
    pass of the stack. Each layer writes the W new K/V entries into the
    rows, in place, and attends with a per-query causal horizon
    (models/attention.py ``verify_decode_attention``); the attention
    contractions run at decode's one-position shapes and the RMSNorms' row
    sums are row-count invariant, so position j's logits are the bits
    :func:`decode` gives after accepting j tokens.
    Dense family only (MoE targets: ROADMAP queue 1 item 11). Returns
    ``(logits (B, W, V_pad), cache)`` with a NEW index ``index + W``; the
    engine sets each slot's true position through the store's rollback."""
    _check_dense(cfg)
    positions = _window_positions(cache, tokens, window)

    def attend(lp, h, i, scales):
        return A.verify_decode_attention(lp, h, cache["k"][i], cache["v"][i], positions,
                                         cfg, cache_scales=scales)
    return (_decode_layers(params, cfg, cache, tokens, attend),
            dict(cache, index=cache["index"] + window))


def verify_window_paged(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                        window: int) -> Tuple[torch.Tensor, Dict]:
    """Block-native speculative verify: :func:`verify_window` through the
    paged pool and the block tables (models/attention.py
    ``paged_verify_attention``); window cells past a slot's extent go to
    the null block. Same logits, same index contract."""
    _check_dense(cfg)
    positions = _window_positions(cache, tokens, window)
    tables = cache["tables"]

    def attend(lp, h, i, scales):
        return A.paged_verify_attention(lp, h, cache["k"][i], cache["v"][i], tables,
                                        positions, cfg, cache_scales=scales)
    return (_decode_layers(params, cfg, cache, tokens, attend),
            dict(cache, index=cache["index"] + window))
