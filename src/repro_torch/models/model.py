"""Dense decoder-only LM: init, fused-prefill forward, logits.

The port of ``repro.models.model``'s dense family. Params are a nested dict
with the JAX package's tree and shapes: ``embed`` (V_pad, D),
``final_ln``, ``lm_head`` (D, V_pad) and ``layers`` whose leaves carry a
leading stacked-layer axis (L, ...). Layers run as a Python loop over that
axis (the JAX package scans it).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _stack(make, n: int):
    """Stack n per-layer param dicts along a new leading axis."""
    layers = [make() for _ in range(n)]

    def join(*leaves):
        if isinstance(leaves[0], dict):
            return {k: join(*(l[k] for l in leaves)) for k in leaves[0]}
        return torch.stack(leaves)
    return join(*layers)


def init_model(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Dense-family params with the JAX package's shapes and distributions:
    embed N(0, 0.02^2), projections LeCun-normal, norm scales 1. Random bits
    come from ``gen`` (a ``torch.Generator`` on ``device``); they cannot and
    do not replay JAX's PRNG."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet "
                         f"(ROADMAP queue 1 item 11)")
    D = cfg.d_model

    def norm():
        return {"scale": torch.ones((D,), dtype=torch.float32, device=device)}

    def layer():
        return {
            "ln1": norm(),
            "attn": A.init_attn(gen, cfg, D, device=device),
            "ln2": norm(),
            "mlp": {
                "wi": L.dense_init(gen, (D, cfg.d_ff), device=device),
                "wg": L.dense_init(gen, (D, cfg.d_ff), device=device),
                "wo": L.dense_init(gen, (cfg.d_ff, D), device=device),
            },
        }

    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab_padded, D), generator=gen,
                             dtype=torch.float32, device=device) * 0.02,
        "final_ln": norm(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (D, cfg.vocab_padded), device=device)
    params["layers"] = _stack(layer, cfg.n_layers)
    return params


def layer_params(layers: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked layer params (QTensors included)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _logits(params: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return _head(params, cfg, L.apply_norm(params["final_ln"], x, cfg))


def _head(params: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The vocab projection of final-norm hidden states ``x``."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.pdot(x, w, cfg)
    if cfg.vocab_padded != cfg.vocab:
        # padded vocab columns masked to -inf: argmax never selects them
        mask = torch.where(torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab,
                           0.0, -1e30)
        logits = logits + mask.to(logits.dtype)
    return logits


def embed_tokens(params: Dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(L.cdtype(cfg))


def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            return_hidden: bool = False) -> Tuple[torch.Tensor, Any]:
    """Full-sequence forward over right-padded prompts ``tokens`` (B, S): the
    reference's ``forward(return_kv=True)``, the fused serving admission.
    Returns ``(logits, kv)``: logits (B, S, V_pad) and the per-layer K/V in
    decode-cache layout, {"k", "v": (L, B, S, KV, hd)} plus
    {"k_scale", "v_scale": (L, B, S, KV)} with the int8 KV cache.

    ``return_hidden`` returns ``(logits, hidden)`` instead: the final-norm
    hidden states (B, S, D) the logits are projected from (the embedding
    surface of the non-generative serve step), no K/V. The logits are the
    same bits either way."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    int8_kv = cfg.kv_cache_dtype == "int8"
    names = kv_names(cfg)
    x = embed_tokens(params, cfg, tokens)
    entries = []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg)
        o, *kv = A.prefill_attention_with_kv(lp["attn"], h, cfg, positions=positions,
                                             int8_kv=int8_kv)
        x = x + o
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], h, cfg)
        if not return_hidden:
            entries.append(kv)
    if return_hidden:
        hidden = L.apply_norm(params["final_ln"], x, cfg)
        return _head(params, cfg, hidden), hidden
    return _logits(params, cfg, x), {n: torch.stack([e[j] for e in entries])
                                     for j, n in enumerate(names)}


def kv_names(cfg: ArchConfig) -> Tuple[str, ...]:
    """The K/V cache leaves of ``cfg``: k, v, and the int8 KV cache's scales."""
    if cfg.kv_cache_dtype == "int8":
        return ("k", "v", "k_scale", "v_scale")
    if cfg.kv_cache_dtype != "bfloat16":
        raise ValueError(f"kv_cache_dtype {cfg.kv_cache_dtype!r}: expected bfloat16 or int8")
    return ("k", "v")


def count_qtensors(params) -> int:
    if isinstance(params, dict):
        return sum(count_qtensors(v) for v in params.values())
    return int(isinstance(params, tz.QTensor))
