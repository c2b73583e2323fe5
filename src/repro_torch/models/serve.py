"""Serving path: cache construction, fused, chunked and suffix
prefill-with-cache, contiguous decode, block-native paged decode and the
speculative verify window on both layouts — the port of
``repro.models.serve`` for the dense, MoE and vlm families, float and int8
KV (the vlm's M-RoPE positions threaded through prefill and decode, as the
reference threads them: not through the chunked scan or the verify
window) — the recurrent families' caches, decode and masked-scan admission
(``prefill_recurrent``: the hybrid and the xlstm), and the encdec's cache
and decode. MoE layers route with the reference's capacity mode on each
path: the ``active`` idle mask at decode, row-isolated at every prefill
and verify.

Cache dicts:
  contiguous  {"k", "v": (L, B, S, KV, hd), "index": (B,)}
  paged       {"k", "v": (L, NB, bs, KV, hd), "index": (B,), "tables": (B, MB)}
plus {"k_scale", "v_scale"} (the same shapes without hd, f32) with the int8
KV cache, whose entries are int8; for the hybrid
  recurrent   {"k", "v": (G, B, S, KV, hd) one per shared-block application,
               "groups": {"conv": (G * attn_every, B, 3, C) in the compute
               dtype, "ssm": (G * attn_every, B, H, P, N) f32},
               "tail": the same for the tail layers, or None, "index": (B,)}
for the ssm family (xlstm), every leaf f32, one row per pair
  recurrent   {"mlstm_C": (L/2, B, H, hd, hd), "mlstm_n": (L/2, B, H, hd),
               "mlstm_m": (L/2, B, H), "slstm_c", "slstm_n", "slstm_h",
               "slstm_m": (L/2, B, D), "index": (B,)}
and for encdec, in the compute dtype with a scalar index
  encdec      {"k", "v": (L, B, S, KV, hd), "cross_k", "cross_v":
               (L, B, max(1, S // enc_len_ratio), KV, hd), "index": ()}
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

MLSTM_LEAVES = ("mlstm_C", "mlstm_n", "mlstm_m")
SLSTM_LEAVES = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")


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


def init_cache(cfg: ArchConfig, batch: int, seq: int, *,
               per_slot_index: bool = False, device=None) -> Dict:
    """Contiguous serving cache: K/V rows (L, B, S, KV, hd) in the cache
    dtype (+ int8 scales), or the family's recurrent or encdec cache
    (module doc), and the index: (B,) per slot with ``per_slot_index``
    (the continuous-batching layout), else (). The encdec's scalar-index
    cross cache is not slot-batched, as in the reference."""
    M.check_family(cfg)
    if per_slot_index and cfg.family == "encdec":
        raise ValueError(f"per-slot cache indices unsupported for {cfg.family}")
    if cfg.family == "hybrid":
        cache = _init_hybrid_cache(cfg, batch, seq, device)
    elif cfg.family == "ssm":
        cache = _init_xlstm_cache(cfg, batch, device)
    elif cfg.family == "encdec":
        dt = L.cdtype(cfg)
        cache = A.init_cache(cfg, cfg.n_layers, batch, seq, dt, device=device)
        cross = A.init_cache(cfg, cfg.n_layers, batch, max(1, seq // cfg.enc_len_ratio),
                             dt, device=device)
        cache.update(cross_k=cross["k"], cross_v=cross["v"])
    else:
        cache = A.init_cache(cfg, cfg.n_layers, batch, seq, _kv_dtype(cfg), device=device)
        _with_scales(cfg, cache, (cfg.n_layers, batch, seq, cfg.n_kv), device)
    if per_slot_index:
        cache["index"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _init_xlstm_cache(cfg: ArchConfig, batch: int, device) -> Dict:
    """Every pair's pristine mLSTM and sLSTM state rows (models/xlstm.py)
    and a scalar index."""
    n = cfg.n_layers // 2
    states = XL.mlstm_state(batch, cfg, device) + XL.slstm_state(batch, cfg, device)
    cache = {name: t[None].repeat((n,) + (1,) * t.ndim)
             for name, t in zip(MLSTM_LEAVES + SLSTM_LEAVES, states)}
    cache["index"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _init_hybrid_cache(cfg: ArchConfig, batch: int, seq: int, device) -> Dict:
    """The hybrid's cache: K/V rows per shared-block application in the
    compute dtype (the int8 KV cache is a dense-family layout, as in the
    reference), and each mamba layer's conv state (compute dtype) and ssm
    state (f32), all zero."""
    G, rem = M.hybrid_layout(cfg)
    dt = L.cdtype(cfg)
    H, Pd, N = SSM.n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state

    def states(n):
        return {"conv": torch.zeros((n, batch, SSM.CONV_W - 1, SSM.conv_channels(cfg)),
                                    dtype=dt, device=device),
                "ssm": torch.zeros((n, batch, H, Pd, N), dtype=torch.float32,
                                   device=device)}
    cache = A.init_cache(cfg, G, batch, seq, dt, device=device)
    cache["groups"] = states(G * cfg.attn_every)
    cache["tail"] = states(rem) if rem else None
    return cache


def init_paged_cache(cfg: ArchConfig, n_slots: int, n_blocks: int,
                     block_size: int, blocks_per_slot: int, device=None) -> Dict:
    """Block-paged serving cache: K/V pools (L, NB, bs, KV, hd) in the cache
    dtype (+ int8 scales (L, NB, bs, KV)), addressed through per-slot block
    tables (B, MB); per-slot index (B,). Block 0 is the reserved null block
    (serving/store.py)."""
    M.check_family(cfg)
    if cfg.family not in M.DENSE_FAMILIES:
        raise ValueError(f"paged KV cache is a dense-family layout, not {cfg.family}")
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

def prefill_with_cache(params: Dict, cfg: ArchConfig, tokens: Optional[torch.Tensor],
                       decode_rows: Optional[A.DecodeRows] = None, *,
                       embeds: Optional[torch.Tensor] = None,
                       positions3: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Fused admission prefill (dense, MoE, vlm): one full-sequence forward
    over right-padded prompts, ``tokens`` (B, S) or the vlm's ``embeds``
    (B, S, D) with ``positions3`` (3, B, S), returning (logits, kv) with
    kv in cache layout, ready to scatter into leased slots
    (serving/store.py ``write_slots``). ``decode_rows``: the decode row
    whose one-query contraction each query runs (models/attention.py; by
    default the plain one over the S positions)."""
    if cfg.family not in M.DENSE_FAMILIES:
        raise ValueError(f"prefill-with-cache is a dense-family path, not {cfg.family}")
    return M.forward(params, cfg, tokens, embeds=embeds, positions3=positions3,
                     decode_rows=decode_rows)


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
    M.check_family(cfg)
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
        with tracing.span("fwd.embed"):
            x = M.embed_tokens(params, cfg, tokens[:, lo:lo + w])
        for i in range(cfg.n_layers):
            with tracing.span("fwd.layer", i=i):
                lp = M.layer_params(params["layers"], i)
                with tracing.span("fwd.attn"):
                    h = L.apply_norm(lp["ln1"], x, cfg)
                    accs = {n: kv[n][i] for n in names}
                    x = x + A.chunked_prefill_attention_with_kv(
                        lp["attn"], h, cfg, positions=positions, chunk_start=lo,
                        k_acc=accs["k"], v_acc=accs["v"], k_sc_acc=accs.get("k_scale"),
                        v_sc_acc=accs.get("v_scale"), int8_kv=int8_kv,
                        decode_rows=decode_rows)
                with tracing.span("fwd.ffn"):
                    h = L.apply_norm(lp["ln2"], x, cfg)
                    x = x + M.ffn(lp, h, cfg, row_isolated=True)
        # carry each row's last-prompt-position hidden state
        rel = last_index.long() - lo
        in_piece = (rel >= 0) & (rel < w)
        row = x[rows, torch.clamp(rel, 0, w - 1)]
        last_x = torch.where(in_piece[:, None], row, last_x)
    with tracing.span("fwd.head"):
        logits = M._logits(params, cfg, last_x[:, None, :])
    return logits[:, 0, :].to(torch.float32), kv


# ===========================================================================
# decode: one token against the cache
# ===========================================================================

def _decode_layers(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                   attend, active: Optional[torch.Tensor] = None,
                   row_isolated: bool = False) -> torch.Tensor:
    """The decode stack shared by the contiguous and paged layouts:
    ``attend(layer_params, h, i, scales)`` runs layer i's attention (writing
    its cache leaves in place). Returns the logits (B, T, V_pad) of tokens
    (B, T): one position per slot at decode, the window at verify (the
    norms' row sums do not depend on T: layers.apply_norm). MoE layers take
    ``active`` (decode) or ``row_isolated`` (verify)."""
    int8_kv = "k_scale" in cache
    with tracing.span("fwd.embed"):
        x = M.embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        with tracing.span("fwd.layer", i=i):
            lp = M.layer_params(params["layers"], i)
            with tracing.span("fwd.attn"):
                h = L.apply_norm(lp["ln1"], x, cfg)
                scales = (cache["k_scale"][i], cache["v_scale"][i]) if int8_kv else None
                x = x + attend(lp["attn"], h, i, scales)
            with tracing.span("fwd.ffn"):
                h = L.apply_norm(lp["ln2"], x, cfg)
                x = x + M.ffn(lp, h, cfg, active=active, row_isolated=row_isolated)
    with tracing.span("fwd.head"):
        return M._head(params, cfg, L.apply_norm(params["final_ln"], x, cfg))


def _hybrid_decode(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """The hybrid's one-token decode body: each shared-block application
    writes the new token's K/V at its row's index, in place, and attends
    its rows; each mamba layer's conv and ssm states go into NEW state
    tensors, so the input cache's states stay as they were and a re-issued
    step computes the same result. ``keep`` (B,) bool (the masked admission
    scan) freezes the rows where it is False: their K/V writes are dropped
    (the attention's index is pushed past the rows) and their states and
    index carried over. Returns ``(logits, cache)``: the same K/V tensors,
    new state tensors and a new index."""
    hp = params["hybrid"]
    index = cache["index"]
    G, rem = M.hybrid_layout(cfg)
    att_index = index if keep is None else torch.where(
        keep, index, torch.full_like(index, cache["k"].shape[2]))
    parts = [part for part in ("groups", "tail") if cache.get(part) is not None]
    states = {part: {n: torch.empty_like(t) for n, t in cache[part].items()}
              for part in parts}

    def mamba(lp, x, part, i):
        old = cache[part]
        x, new = M.mamba_layer(lp, x, cfg, conv_state=old["conv"][i],
                               ssm_state=old["ssm"][i], decode=True)
        for name, t in zip(("conv", "ssm"), new):
            if keep is not None:
                t = torch.where(keep.reshape((-1,) + (1,) * (t.ndim - 1)), t, old[name][i])
            states[part][name][i].copy_(t)
        return x

    x = M.embed_tokens(params, cfg, tokens)
    for g in range(G):
        x = M.shared_block(hp, g, x, cfg, lambda ap, h, g=g: A.decode_attention(
            ap, h, cache["k"][g], cache["v"][g], att_index, cfg))
        for j in range(cfg.attn_every):
            x = mamba(M.layer_params(hp["groups"], (g, j)), x, "groups",
                      g * cfg.attn_every + j)
    for j in range(rem):
        x = mamba(M.layer_params(hp["tail"], j), x, "tail", j)
    new_index = index + 1 if keep is None else torch.where(keep, index + 1, index)
    return M._logits(params, cfg, x), dict(cache, index=new_index, **states)


def _xlstm_decode(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                  keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """The xlstm's one-token decode body: every pair's mLSTM and sLSTM step
    (models/xlstm.py) from its state rows, the new states written into NEW
    state tensors, so a re-issued step computes the same result. ``keep``
    (B,) bool (the masked admission scan) freezes the rows where it is
    False: their states and index are carried over. Returns ``(logits,
    cache)``."""
    pairs = params["xlstm"]["pairs"]
    index = cache["index"]
    names = MLSTM_LEAVES + SLSTM_LEAVES
    new = {n: torch.empty_like(cache[n]) for n in names}
    x = M.embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers // 2):
        state = (tuple(cache[n][i] for n in MLSTM_LEAVES),
                 tuple(cache[n][i] for n in SLSTM_LEAVES))
        x, (ms, ss) = M.xlstm_pair(M.layer_params(pairs, i), x, cfg, state, decode=True)
        for name, t in zip(names, ms + ss):
            if keep is not None:
                t = torch.where(keep.reshape((-1,) + (1,) * (t.ndim - 1)), t, cache[name][i])
            new[name][i].copy_(t)
    new_index = index + 1 if keep is None else torch.where(keep, index + 1, index)
    return M._logits(params, cfg, x), dict(cache, index=new_index, **new)


_RECURRENT_DECODE = {"hybrid": _hybrid_decode, "ssm": _xlstm_decode}


def prefill_recurrent(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                      last_index: torch.Tensor, max_seq_len: int
                      ) -> Tuple[torch.Tensor, Dict]:
    """Admission for the recurrent families (hybrid, ssm): the right-padded
    prompt bucket (B, Sb) replayed through the family's decode body one
    position at a time over a fresh B-row cache of ``max_seq_len``
    positions. Rows whose prompt ended (t > last_index[i]) are frozen (the
    body's ``keep``: :func:`_hybrid_decode`, :func:`_xlstm_decode`), so pad
    tokens never touch them. Returns ``(row, cache)``: each row's logits at
    its last prompt position (B, V_pad) f32 and its post-prompt state, ready
    to copy into leased slot rows.

    Each step is the math of a B-row decode step, and every op of the body
    keeps a row's bits whatever the row count (models/ssm.py,
    models/xlstm.py), so the states and first tokens are bitwise a replay
    of each prompt alone through the one-row decode step."""
    M.check_family(cfg)
    if cfg.family not in _RECURRENT_DECODE:
        raise ValueError(f"the masked-scan admission is a recurrent-family path, "
                         f"not {cfg.family}")
    body = _RECURRENT_DECODE[cfg.family]
    B, Sb = tokens.shape
    cache = init_cache(cfg, B, max_seq_len, per_slot_index=True, device=tokens.device)
    row = torch.zeros((B, cfg.vocab_padded), dtype=torch.float32, device=tokens.device)
    for t in range(Sb):
        logits, cache = body(params, cfg, cache, tokens[:, t:t + 1], keep=t <= last_index)
        row = torch.where((t == last_index)[:, None], logits[:, -1].to(torch.float32), row)
    return row, cache


def _mrope_positions(cfg: ArchConfig, index: torch.Tensor,
                     positions3: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A decode step's M-RoPE positions: ``positions3`` (3, B, 1), or by
    default each row's index on all three sections (text tokens after the
    prompt), as the reference sets them; None without M-RoPE."""
    if cfg.rope_kind != "mrope" or positions3 is not None:
        return positions3
    return index[None, :, None].expand(3, index.shape[0], 1)


def _encdec_decode(params: Dict, cfg: ArchConfig, cache: Dict,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """The encdec's one-token decode against its scalar-index cache: each
    decoder layer's self-attention writes the token's K/V at the index, in
    place (the scalar broadcast over the rows: decode's per-row attention),
    and attends up to it; its cross-attention reads every position of the
    cross cache (models/attention.py ``cross_decode_attention``; the
    reference's step never writes that cache, nor does this one). Returns
    ``(logits, cache)`` with a NEW index ``index + 1``."""
    index = cache["index"]
    if index.ndim:
        raise ValueError(f"per-slot cache indices unsupported for {cfg.family}")
    B = tokens.shape[0]
    rows_index = index.expand(B)
    positions = rows_index[:, None]
    x = M.embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = M.layer_params(params["decoder"], i)
        x = x + A.decode_attention(lp["self_attn"], L.apply_norm(lp["ln1"], x, cfg),
                                   cache["k"][i], cache["v"][i], rows_index, cfg)
        x = x + A.cross_decode_attention(lp["cross_attn"], L.apply_norm(lp["ln_x"], x, cfg),
                                         cache["cross_k"][i], cache["cross_v"][i],
                                         positions, cfg)
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return M._logits(params, cfg, x), dict(cache, index=index + 1)


def decode(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
           active: Optional[torch.Tensor] = None,
           positions3: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode against contiguous rows with a per-slot index.
    ``tokens`` is (B, 1); ``active`` (B,) bool masks idle slots out of the
    MoE capacity cumsum (the engine passes it on every step); ``positions3``
    (3, B, 1) the M-RoPE positions (by default the index on all three
    sections). Every layer writes the new token's K/V at its row's index,
    in place, and attends positions up to it. Returns ``(logits, cache)``:
    the same leaf tensors and a NEW index tensor ``index + 1`` (the input
    index is never modified, so a re-issued step sees the same positions).
    The recurrent families decode their state caches
    (:func:`_hybrid_decode`, :func:`_xlstm_decode`: new state tensors, K/V
    in place), the encdec its scalar-index cache (:func:`_encdec_decode`)."""
    M.check_family(cfg)
    if cfg.family in _RECURRENT_DECODE:
        return _RECURRENT_DECODE[cfg.family](params, cfg, cache, tokens)
    if cfg.family == "encdec":
        return _encdec_decode(params, cfg, cache, tokens)
    index = cache["index"]
    p3 = _mrope_positions(cfg, index, positions3)

    def attend(lp, h, i, scales):
        return A.decode_attention(lp, h, cache["k"][i], cache["v"][i], index, cfg,
                                  cache_scales=scales, positions3=p3)
    return (_decode_layers(params, cfg, cache, tokens, attend, active=active),
            dict(cache, index=index + 1))


def decode_paged(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor, *,
                 use_kernel: bool = True, active: Optional[torch.Tensor] = None,
                 positions3: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Block-native single-token decode over the paged pool (dense, MoE,
    vlm). ``tokens`` is (B, 1); ``active`` and ``positions3`` as in
    :func:`decode`. Each layer writes the new token's K/V into its pool
    cell through the tables, in place, and attends block-natively: through
    the paged-attention kernel with ``use_kernel`` and float KV, else by
    the plain per-layer gather and contraction (models/attention.py
    ``paged_decode_attention``). Returns ``(logits, cache)``: the same pool
    tensors and a NEW index tensor ``index + 1``."""
    M.check_family(cfg)
    if cfg.family not in M.DENSE_FAMILIES:
        raise ValueError(f"paged decode is a dense-family path, not {cfg.family}")
    index, tables = cache["index"], cache["tables"]
    p3 = _mrope_positions(cfg, index, positions3)

    def attend(lp, h, i, scales):
        return A.paged_decode_attention(lp, h, cache["k"][i], cache["v"][i], tables,
                                        index, cfg, cache_scales=scales,
                                        use_kernel=use_kernel, positions3=p3)
    return (_decode_layers(params, cfg, cache, tokens, attend, active=active),
            dict(cache, index=index + 1))


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
    :func:`decode` gives after accepting j tokens. MoE layers route the
    window row-isolated (dropless, so a position's experts and their
    outputs are decode's). Returns
    ``(logits (B, W, V_pad), cache)`` with a NEW index ``index + W``; the
    engine sets each slot's true position through the store's rollback."""
    M.check_family(cfg)
    positions = _window_positions(cache, tokens, window)

    def attend(lp, h, i, scales):
        return A.verify_decode_attention(lp, h, cache["k"][i], cache["v"][i], positions,
                                         cfg, cache_scales=scales)
    return (_decode_layers(params, cfg, cache, tokens, attend, row_isolated=True),
            dict(cache, index=cache["index"] + window))


def verify_window_paged(params: Dict, cfg: ArchConfig, cache: Dict, tokens: torch.Tensor,
                        window: int) -> Tuple[torch.Tensor, Dict]:
    """Block-native speculative verify: :func:`verify_window` through the
    paged pool and the block tables (models/attention.py
    ``paged_verify_attention``); window cells past a slot's extent go to
    the null block. Same logits, same index contract."""
    M.check_family(cfg)
    positions = _window_positions(cache, tokens, window)
    tables = cache["tables"]

    def attend(lp, h, i, scales):
        return A.paged_verify_attention(lp, h, cache["k"][i], cache["v"][i], tables,
                                        positions, cfg, cache_scales=scales)
    return (_decode_layers(params, cfg, cache, tokens, attend, row_isolated=True),
            dict(cache, index=cache["index"] + window))
