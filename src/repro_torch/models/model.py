"""Decoder-only LM of the dense and MoE families: init (also streamed and
quantized layer by layer), fused-prefill forward, logits.

The port of ``repro.models.model``'s dense and moe families. Params are a
nested dict with the JAX package's tree and shapes: ``embed`` (V_pad, D),
``final_ln``, ``lm_head`` (D, V_pad) and ``layers`` whose leaves carry a
leading stacked-layer axis (L, ...); a layer holds ``ln1``, ``attn``,
``ln2`` and ``mlp`` (dense) or ``moe`` (models/moe.py). Layers run as a
Python loop over that axis (the JAX package scans it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

FAMILIES = ("dense", "moe")


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the port does not serve or build yet."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported yet (ported: "
                         f"{FAMILIES}; the others: ROADMAP queue 1 item 11)")


def _init_layer(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    """One layer's params, drawn in order: attention (wq, wk, wv, wo), then
    the MLP (wi, wg, wo) or the MoE block (router, wi, wg, wo, shared)."""
    D = cfg.d_model
    p = {"ln1": L.init_norm(cfg, D, device=device),
         "attn": A.init_attn(gen, cfg, D, device=device),
         "ln2": L.init_norm(cfg, D, device=device)}
    if cfg.family == "moe":
        p["moe"] = MOE.init_moe(gen, cfg, D, device=device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, D, cfg.d_ff, device=device)
    return p


def _init_top(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen,
                             dtype=torch.float32, device=device) * 0.02,
        "final_ln": L.init_norm(cfg, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_padded),
                                         device=device)
    return params


def init_model(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Dense- and MoE-family params in f32 with the JAX package's shapes and
    distributions: embed N(0, 0.02^2), projections LeCun-normal, norm
    scales 1 (LayerNorm biases 0). Random bits come from ``gen`` (a
    ``torch.Generator`` on ``device``); they cannot and do not replay JAX's
    PRNG."""
    check_family(cfg)
    params = _init_top(cfg, gen, device)
    layers = [_init_layer(cfg, gen, device) for _ in range(cfg.n_layers)]

    def join(*leaves):
        if isinstance(leaves[0], dict):
            return {k: join(*(l[k] for l in leaves)) for k in leaves[0]}
        return torch.stack(leaves)
    params["layers"] = join(*layers)
    return params


def init_model_quantized(cfg: ArchConfig, gen: torch.Generator,
                         predicate: Optional[Callable] = None, device=None) -> Dict:
    """The streamed build: :func:`init_model`'s draws in its order, each
    layer quantized (``tz.quantize_params`` with ``predicate``) before the
    next is drawn, its int8 codes and scales copied into stacked buffers
    allocated once. Quantization reduces over axis -2 and keeps every
    leading axis, so the result is bitwise ``tz.quantize_params(
    init_model(...), predicate)``, while the peak memory stays near the
    W8A8 model plus one layer in f32 (deepseek-moe-16b: about 17.5 GB, where
    its f32 experts alone are 62 GB, and stacking them copies them again)."""
    check_family(cfg)
    params = tz.quantize_params(_init_top(cfg, gen, device), predicate)
    stacked = None
    for i in range(cfg.n_layers):
        layer = tz.quantize_params({"layers": _init_layer(cfg, gen, device)},
                                   predicate)["layers"]
        if stacked is None:
            stacked = _alloc_stacked(layer, cfg.n_layers)
        _copy_layer(stacked, layer, i)
        del layer
    params["layers"] = stacked
    return params


def _alloc_stacked(layer, n: int):
    if isinstance(layer, dict):
        return {k: _alloc_stacked(v, n) for k, v in layer.items()}
    if isinstance(layer, tz.QTensor):
        q, s = (_alloc_stacked(t, n) for t in (layer.q, layer.scale))
        return tz.QTensor(q, s, tuple(q.shape))
    return layer.new_empty((n,) + tuple(layer.shape))


def _copy_layer(stacked, layer, i: int) -> None:
    if isinstance(layer, dict):
        for k, v in layer.items():
            _copy_layer(stacked[k], v, i)
    elif isinstance(layer, tz.QTensor):
        stacked.q[i].copy_(layer.q)
        stacked.scale[i].copy_(layer.scale)
    else:
        stacked[i].copy_(layer)


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


def ffn(lp: Dict, h: torch.Tensor, cfg: ArchConfig, *,
        active: Optional[torch.Tensor] = None, row_isolated: bool = False) -> torch.Tensor:
    """A layer's feed-forward block on normed ``h``: the MLP, or the MoE
    block in the capacity mode its caller names (models/moe.py; the aux
    loss is dropped, serving has no use for it)."""
    if cfg.family == "moe":
        return MOE.apply_moe(lp["moe"], h, cfg, active=active, row_isolated=row_isolated)[0]
    return L.apply_mlp(lp["mlp"], h, cfg)


def embed_tokens(params: Dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(L.cdtype(cfg))


def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            return_hidden: bool = False,
            decode_rows: Optional[A.DecodeRows] = None) -> Tuple[torch.Tensor, Any]:
    """Full-sequence forward over right-padded prompts ``tokens`` (B, S): the
    reference's ``forward(return_kv=True)``, the fused serving admission.
    Returns ``(logits, kv)``: logits (B, S, V_pad) and the per-layer K/V in
    decode-cache layout, {"k", "v": (L, B, S, KV, hd)} plus
    {"k_scale", "v_scale": (L, B, S, KV)} with the int8 KV cache.

    ``return_hidden`` returns ``(logits, hidden)`` instead: the final-norm
    hidden states (B, S, D) the logits are projected from (the embedding
    surface of the non-generative serve step), no K/V. MoE layers route
    row-isolated on the K/V path and with the shared, dropping capacity on
    the ``return_hidden`` path, as the reference's training forward does, so
    there (and only for MoE) the logits are not the K/V path's bits. Each
    query attends as a one-query contraction of
    ``decode_rows``, the decode row whose bits it keeps (by default the
    plain one over the S positions; models/attention.py
    ``prefill_attention_with_kv``)."""
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
                                             int8_kv=int8_kv, decode_rows=decode_rows)
        x = x + o
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = x + ffn(lp, h, cfg, row_isolated=not return_hidden)
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
