"""Serving path: the paged KV pool, fused prefill-with-cache, and
block-native paged decode — the port of ``repro.models.serve``'s float-KV
dense subset.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M


def init_paged_cache(cfg: ArchConfig, n_slots: int, n_blocks: int,
                     block_size: int, blocks_per_slot: int, device=None) -> Dict:
    """Block-paged serving cache: K/V pools (L, NB, bs, KV, hd) in the cache
    dtype, addressed through per-slot block tables (B, MB); per-slot index
    (B,). Block 0 is the reserved null block (serving/store.py)."""
    if cfg.family != "dense":
        raise ValueError(f"paged KV cache is a dense-family layout, not {cfg.family}")
    if cfg.kv_cache_dtype != "bfloat16":
        raise ValueError("int8 KV cache is not ported yet (ROADMAP queue 1 item 9)")
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=L.cdtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=L.cdtype(cfg), device=device),
        "index": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "tables": torch.zeros((n_slots, blocks_per_slot), dtype=torch.int32,
                              device=device),
    }


def prefill_with_cache(params: Dict, cfg: ArchConfig,
                       tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Fused admission prefill: one full-sequence forward over right-padded
    prompts returning (logits, kv) with kv in cache layout, ready to scatter
    into leased slots (serving/store.py ``write_slots``)."""
    return M.forward(params, cfg, tokens)


def decode_paged(params: Dict, cfg: ArchConfig, cache: Dict,
                 tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Block-native single-token decode over the paged pool. ``tokens`` is
    (B, 1). Each layer writes the new token's K/V into its pool cell through
    the tables, in place, and attends block-natively. Returns ``(logits,
    cache)``: the same pool tensors and a NEW index tensor ``index + 1`` (the
    input index is never modified, so a re-issued step sees the same
    positions)."""
    index = cache["index"]
    tables = cache["tables"]
    x = M.embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = M.layer_params(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg)
        x = x + A.paged_decode_attention(lp["attn"], h, cache["k"][i],
                                         cache["v"][i], tables, index, cfg)
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], h, cfg)
    return M._logits(params, cfg, x), dict(cache, index=index + 1)
