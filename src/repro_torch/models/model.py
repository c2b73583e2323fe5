"""Decoder-only LM of the dense, MoE and hybrid families: init (also
streamed and quantized layer by layer), fused-prefill forward, logits.

The port of ``repro.models.model``'s dense, moe and hybrid families. Params
are a nested dict with the JAX package's tree and shapes: ``embed``
(V_pad, D), ``final_ln``, ``lm_head`` (D, V_pad), and

  * dense and moe: ``layers`` whose leaves carry a leading stacked-layer
    axis (L, ...); a layer holds ``ln1``, ``attn``, ``ln2`` and ``mlp``
    (dense) or ``moe`` (models/moe.py);
  * hybrid (zamba2): ``hybrid`` = {``groups`` (G, attn_every, ...) mamba
    layers (``ln``, ``mamba``: models/ssm.py), ``shared`` one attention +
    MLP block applied before each group, ``lora`` (G, ...) its per
    application W_q adapter (``qA`` (D, LORA_RANK), ``qB``), ``tail``
    (rem, ...) the remainder mamba layers, or None}.

Layers run as a Python loop over the stacked axis (the JAX package scans
it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

FAMILIES = ("dense", "moe", "hybrid")
LORA_RANK = 16  # zamba2's per-application adapter rank


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


def hybrid_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, tail layers): ``n_layers // attn_every`` applications of the
    shared block, each before ``attn_every`` mamba layers, then the rest."""
    groups = cfg.n_layers // cfg.attn_every
    return groups, cfg.n_layers - groups * cfg.attn_every


def _init_mamba_layer(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    return {"ln": L.init_norm(cfg, cfg.d_model, device=device),
            "mamba": SSM.init_mamba2(gen, cfg, device=device)}


def _init_shared(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    D = cfg.d_model
    return {"ln1": L.init_norm(cfg, D, device=device),
            "attn": A.init_attn(gen, cfg, D, device=device),
            "ln2": L.init_norm(cfg, D, device=device),
            "mlp": L.init_mlp(gen, cfg, D, cfg.d_ff, device=device)}


def _init_lora(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    """One application's W_q adapter: qA N(0, 0.02^2), qB zeros."""
    return {"qA": torch.randn((cfg.d_model, LORA_RANK), generator=gen,
                              dtype=torch.float32, device=device) * 0.02,
            "qB": torch.zeros((LORA_RANK, cfg.n_heads * cfg.hd), dtype=torch.float32,
                              device=device)}


def _stream(n: int, draw: Callable, prep: Callable):
    """``n`` draws, each passed through ``prep`` and copied into stacked
    buffers (n, ...) allocated at the first: one drawn layer alive at a
    time."""
    stacked = None
    for i in range(n):
        layer = prep(draw())
        if stacked is None:
            stacked = _alloc_stacked(layer, n)
        _copy_layer(stacked, layer, i)
        del layer
    return stacked


def _split_lead(tree, lead: Tuple[int, int]):
    """Stacked leaves (G * E, ...) viewed as (G, E, ...)."""
    if isinstance(tree, dict):
        return {k: _split_lead(v, lead) for k, v in tree.items()}
    if isinstance(tree, tz.QTensor):
        q = tree.q.reshape(lead + tuple(tree.q.shape[1:]))
        return tz.QTensor(q, tree.scale.reshape(lead + tuple(tree.scale.shape[1:])),
                          tuple(q.shape))
    return tree.reshape(lead + tuple(tree.shape[1:]))


def _init_hybrid(cfg: ArchConfig, gen: torch.Generator, device,
                 prep: Callable[[str, Dict], Dict]) -> Dict:
    """zamba2's tree, drawn in order: the shared block (attention, then the
    MLP), every group's mamba layers, every application's adapter, the tail
    layers. ``prep(part, tree)`` maps each drawn piece (identity, or the
    streamed build's quantization) before it is stacked."""
    G, rem = hybrid_layout(cfg)
    shared = prep("shared", _init_shared(cfg, gen, device))
    groups = _stream(G * cfg.attn_every, lambda: _init_mamba_layer(cfg, gen, device),
                     lambda t: prep("groups", t))
    lora = _stream(G, lambda: _init_lora(cfg, gen, device), lambda t: prep("lora", t))
    tail = (_stream(rem, lambda: _init_mamba_layer(cfg, gen, device),
                    lambda t: prep("tail", t)) if rem else None)
    return {"groups": _split_lead(groups, (G, cfg.attn_every)), "shared": shared,
            "lora": lora, "tail": tail}


def init_model(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Params in f32 with the JAX package's shapes and distributions: embed
    N(0, 0.02^2), projections LeCun-normal, norm scales 1 (LayerNorm biases
    0); the hybrid family's mamba and adapter leaves as models/ssm.py and
    :func:`_init_lora` draw them. Random bits come from ``gen`` (a
    ``torch.Generator`` on ``device``); they cannot and do not replay JAX's
    PRNG."""
    check_family(cfg)
    params = _init_top(cfg, gen, device)
    if cfg.family == "hybrid":
        params["hybrid"] = _init_hybrid(cfg, gen, device, lambda part, t: t)
        return params
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
    its f32 experts alone are 62 GB, and stacking them copies them again;
    zamba2-7b: about 7.1 GB, where its f32 model is 27 GB)."""
    check_family(cfg)
    params = tz.quantize_params(_init_top(cfg, gen, device), predicate)
    if cfg.family == "hybrid":
        # each piece quantized under its full path, as the whole tree would be
        params["hybrid"] = _init_hybrid(
            cfg, gen, device, lambda part, t: tz.quantize_params(
                {"hybrid": {part: t}}, predicate)["hybrid"][part])
        return params
    params["layers"] = _stream(
        cfg.n_layers, lambda: _init_layer(cfg, gen, device),
        lambda t: tz.quantize_params({"layers": t}, predicate)["layers"])
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


def layer_params(layers: Dict, i) -> Dict:
    """Layer ``i``'s slice of the stacked layer params (QTensors included);
    ``i`` an int, or a tuple indexing several leading axes (the hybrid's
    (group, layer))."""
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
    """Full-sequence forward over right-padded prompts ``tokens`` (B, S): for
    the dense and MoE families the reference's ``forward(return_kv=True)``,
    the fused serving admission; for the hybrid, its ``forward`` (the
    embedding forward; the hybrid admits by ``serve.prefill_recurrent``),
    returning ``(logits, None)`` or, with ``return_hidden``, ``(logits,
    hidden)``.
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
    if cfg.family == "hybrid":
        hidden = L.apply_norm(params["final_ln"], _hybrid_forward(
            params, cfg, embed_tokens(params, cfg, tokens), positions, decode_rows), cfg)
        return _head(params, cfg, hidden), (hidden if return_hidden else None)
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


def shared_attn_params(hp: Dict, g: int) -> Dict:
    """The shared block's attention params for application ``g``: W_q is
    the float matrix ``wq.dequantize() + qA @ qB`` (the Tensorizer's int8
    W_q dequantized, plus the application's f32 LoRA product), made on
    every use as the reference makes it."""
    attn = hp["shared"]["attn"]
    wq = attn["wq"]
    if isinstance(wq, tz.QTensor):
        wq = wq.dequantize()
    lora = layer_params(hp["lora"], g)
    return dict(attn, wq=wq + lora["qA"] @ lora["qB"])


def shared_block(hp: Dict, g: int, x: torch.Tensor, cfg: ArchConfig,
                 attend: Callable) -> torch.Tensor:
    """Application ``g`` of the hybrid's shared block on x (B, T, D):
    pre-norm attention (``attend(attn_params, h)`` runs it) and the
    pre-norm MLP, each added to the residual."""
    sp = hp["shared"]
    x = x + attend(shared_attn_params(hp, g), L.apply_norm(sp["ln1"], x, cfg))
    return x + L.apply_mlp(sp["mlp"], L.apply_norm(sp["ln2"], x, cfg), cfg)


def mamba_layer(lp: Dict, x: torch.Tensor, cfg: ArchConfig, conv_state=None,
                ssm_state=None, decode: bool = False):
    """A pre-norm mamba2 layer on x (B, T, D): ``(x + y, (conv, ssm))``."""
    y, states = SSM.apply_mamba2(lp["mamba"], L.apply_norm(lp["ln"], x, cfg), cfg,
                                 conv_state=conv_state, ssm_state=ssm_state, decode=decode)
    return x + y, states


def _hybrid_forward(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor,
                    decode_rows: Optional[A.DecodeRows]) -> torch.Tensor:
    """zamba2's full-sequence pass (the embedding forward): each group's
    shared-block application, causal attention whose queries run as the
    prefill's one-query contractions (``decode_rows``; no cache is kept),
    then its mamba layers in the chunked SSD form; then the tail layers.
    Returns the final residual stream (B, S, D)."""
    hp = params["hybrid"]
    G, rem = hybrid_layout(cfg)

    def attend(ap, h):
        return A.prefill_attention_with_kv(ap, h, cfg, positions=positions,
                                           decode_rows=decode_rows)[0]
    for g in range(G):
        x = shared_block(hp, g, x, cfg, attend)
        for j in range(cfg.attn_every):
            x = mamba_layer(layer_params(hp["groups"], (g, j)), x, cfg)[0]
    for j in range(rem):
        x = mamba_layer(layer_params(hp["tail"], j), x, cfg)[0]
    return x


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
