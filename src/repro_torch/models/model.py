"""The LM of every family: init (also streamed and quantized layer by
layer), the full-sequence forward (the dense families' fused prefill),
logits, and the differentiable training forward (``train_forward``).

The port of ``repro.models.model``. Params are a nested dict with the JAX
package's tree and shapes: ``embed`` (V_pad, D), ``final_ln``, ``lm_head``
(D, V_pad), and

  * dense, moe and vlm: ``layers`` whose leaves carry a leading
    stacked-layer axis (L, ...); a layer holds ``ln1``, ``attn``, ``ln2``
    and ``mlp`` (dense, vlm) or ``moe`` (models/moe.py);
  * encdec (seamless): ``encoder`` (L_enc, ...) layers of ``ln1``,
    ``attn``, ``ln2``, ``mlp``; ``decoder`` (L, ...) layers of ``ln1``,
    ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``; and
    ``enc_final_ln``;
  * hybrid (zamba2): ``hybrid`` = {``groups`` (G, attn_every, ...) mamba
    layers (``ln``, ``mamba``: models/ssm.py), ``shared`` one attention +
    MLP block applied before each group, ``lora`` (G, ...) its per
    application W_q adapter (``qA`` (D, LORA_RANK), ``qB``), ``tail``
    (rem, ...) the remainder mamba layers, or None};
  * ssm (xlstm): ``xlstm`` = {``pairs`` (L / 2, ...) of ``ln_m``,
    ``mlstm``, ``ln_s``, ``slstm`` (models/xlstm.py)}.

Layers run as a Python loop over the stacked axis (the JAX package scans
it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid", "ssm")
DENSE_FAMILIES = ("dense", "moe", "vlm")   # one stack of attention + FFN layers
LORA_RANK = 16  # zamba2's per-application adapter rank


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the JAX package does not build either."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (expected one of {FAMILIES})")


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


def _init_pair(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    """One xlstm pair: its mLSTM block, then its sLSTM block."""
    D = cfg.d_model
    return {"ln_m": L.init_norm(cfg, D, device=device),
            "mlstm": XL.init_mlstm(gen, cfg, device=device),
            "ln_s": L.init_norm(cfg, D, device=device),
            "slstm": XL.init_slstm(gen, cfg, device=device)}


def _init_enc_layer(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    D = cfg.d_model
    return {"ln1": L.init_norm(cfg, D, device=device),
            "attn": A.init_attn(gen, cfg, D, device=device),
            "ln2": L.init_norm(cfg, D, device=device),
            "mlp": L.init_mlp(gen, cfg, D, cfg.d_ff, device=device)}


def _init_dec_layer(cfg: ArchConfig, gen: torch.Generator, device) -> Dict:
    """An encdec decoder layer: self-attention, cross-attention (whose wk
    and wv project the encoder's output), the MLP."""
    D = cfg.d_model
    return {"ln1": L.init_norm(cfg, D, device=device),
            "self_attn": A.init_attn(gen, cfg, D, device=device),
            "ln_x": L.init_norm(cfg, D, device=device),
            "cross_attn": A.init_attn(gen, cfg, D, device=device),
            "ln2": L.init_norm(cfg, D, device=device),
            "mlp": L.init_mlp(gen, cfg, D, cfg.d_ff, device=device)}


def _init_body(cfg: ArchConfig, gen: torch.Generator, device,
               prep: Callable[[Tuple[str, ...], Dict], Dict]) -> Dict:
    """The family's layer trees, drawn layer by layer after the top-level
    leaves; ``prep(path, tree)`` maps each drawn piece (identity, or the
    streamed build's quantization under its full path) before it is
    stacked."""
    def stack(path, n, draw):
        return _stream(n, lambda: draw(cfg, gen, device), lambda t: prep(path, t))
    if cfg.family == "hybrid":
        return {"hybrid": _init_hybrid(cfg, gen, device,
                                       lambda part, t: prep(("hybrid", part), t))}
    if cfg.family == "ssm":
        return {"xlstm": {"pairs": stack(("xlstm", "pairs"), cfg.n_layers // 2,
                                         _init_pair)}}
    if cfg.family == "encdec":
        return {"encoder": stack(("encoder",), cfg.n_enc_layers, _init_enc_layer),
                "decoder": stack(("decoder",), cfg.n_layers, _init_dec_layer),
                "enc_final_ln": L.init_norm(cfg, cfg.d_model, device=device)}
    return {"layers": stack(("layers",), cfg.n_layers, _init_layer)}


def init_model(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Params in f32 with the JAX package's shapes and distributions: embed
    N(0, 0.02^2), projections LeCun-normal, norm scales 1 (LayerNorm biases
    0); the hybrid family's mamba and adapter leaves as models/ssm.py and
    :func:`_init_lora` draw them, the xlstm blocks' as models/xlstm.py
    does. Random bits come from ``gen`` (a ``torch.Generator`` on
    ``device``); they cannot and do not replay JAX's PRNG."""
    check_family(cfg)
    params = _init_top(cfg, gen, device)
    params.update(_init_body(cfg, gen, device, lambda path, t: t))
    return params


def init_model_quantized(cfg: ArchConfig, gen: torch.Generator,
                         predicate: Optional[Callable] = None, device=None) -> Dict:
    """The streamed build: :func:`init_model`'s draws in its order, each
    layer quantized (``tz.quantize_params`` with ``predicate``, under its
    full path) before the next is drawn, its int8 codes and scales copied
    into stacked buffers allocated once. Quantization reduces over axis -2
    and keeps every leading axis, so the result is bitwise
    ``tz.quantize_params(init_model(...), predicate)``, while the peak
    memory stays near the W8A8 model plus one layer in f32 (deepseek-moe-16b:
    about 17.5 GB, where its f32 experts alone are 62 GB, and stacking them
    copies them again; zamba2-7b: about 7.1 GB, where its f32 model is 27
    GB)."""
    check_family(cfg)
    params = tz.quantize_params(_init_top(cfg, gen, device), predicate)

    def prep(path, tree):
        nested = tree
        for k in reversed(path):
            nested = {k: nested}
        out = tz.quantize_params(nested, predicate)
        for k in path:
            out = out[k]
        return out
    params.update(_init_body(cfg, gen, device, prep))
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


# ---------------------------------------------------------------------------
# partition specs (the dry run's per-device accounting, models/steps.py)
# ---------------------------------------------------------------------------

def _norm_specs(cfg: ArchConfig) -> Dict:
    p = {"scale": (None,)}
    if cfg.norm == "layernorm":
        p["bias"] = (None,)
    return p


def _prepend(spec_tree, axis_entry=None):
    """Every spec of a tree with a leading (stacked-layer) axis added."""
    if isinstance(spec_tree, dict):
        return {k: _prepend(v, axis_entry) for k, v in spec_tree.items()}
    return (axis_entry,) + tuple(spec_tree)


def param_specs(cfg: ArchConfig) -> Dict:
    """The partition spec of every leaf of :func:`init_model`'s tree (a
    tuple per leaf, the reference's ``param_specs``)."""
    specs: Dict[str, Any] = {"embed": ("model", None), "final_ln": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
    if cfg.family in DENSE_FAMILIES:
        layer = {"ln1": _norm_specs(cfg), "attn": A.attn_specs(cfg), "ln2": _norm_specs(cfg)}
        if cfg.family == "moe":
            layer["moe"] = MOE.moe_specs(cfg)
        else:
            layer["mlp"] = L.mlp_specs(cfg)
        specs["layers"] = _prepend(layer)
    elif cfg.family == "encdec":
        enc = {"ln1": _norm_specs(cfg), "attn": A.attn_specs(cfg),
               "ln2": _norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        dec = {"ln1": _norm_specs(cfg), "self_attn": A.attn_specs(cfg),
               "ln_x": _norm_specs(cfg), "cross_attn": A.attn_specs(cfg),
               "ln2": _norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        specs["encoder"] = _prepend(enc)
        specs["decoder"] = _prepend(dec)
        specs["enc_final_ln"] = _norm_specs(cfg)
    elif cfg.family == "hybrid":
        mamba = {"ln": _norm_specs(cfg), "mamba": SSM.mamba2_specs(cfg)}
        specs["hybrid"] = {
            "groups": _prepend(_prepend(mamba)),        # (G, attn_every, ...)
            "shared": {"ln1": _norm_specs(cfg), "attn": A.attn_specs(cfg),
                       "ln2": _norm_specs(cfg), "mlp": L.mlp_specs(cfg)},
            "lora": _prepend({"qA": (None, None), "qB": (None, "model")}),
            "tail": _prepend(mamba) if cfg.n_layers % cfg.attn_every else None,
        }
    elif cfg.family == "ssm":
        pair = {"ln_m": _norm_specs(cfg), "mlstm": XL.mlstm_specs(cfg),
                "ln_s": _norm_specs(cfg), "slstm": XL.slstm_specs(cfg)}
        specs["xlstm"] = {"pairs": _prepend(pair)}
    return specs


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


def forward(params: Dict, cfg: ArchConfig, tokens: Optional[torch.Tensor], *,
            embeds: Optional[torch.Tensor] = None,
            positions3: Optional[torch.Tensor] = None,
            return_hidden: bool = False,
            decode_rows: Optional[A.DecodeRows] = None) -> Tuple[torch.Tensor, Any]:
    """Full-sequence forward over right-padded prompts ``tokens`` (B, S),
    or over precomputed ``embeds`` (B, S, D) (the vlm's patch embeddings,
    ``tokens`` None; M-RoPE configs take ``positions3`` (3, B, S), the
    (t, h, w) position ids). For encdec, ``embeds`` (B, Se, D) are the
    encoder's frame embeddings and ``tokens`` the decoder's.

    For the dense, MoE and vlm families this is the reference's
    ``forward(return_kv=True)``, the fused serving admission: it returns
    ``(logits, kv)``, logits (B, S, V_pad) and the per-layer K/V in
    decode-cache layout, {"k", "v": (L, B, S, KV, hd)} plus {"k_scale",
    "v_scale": (L, B, S, KV)} with the int8 KV cache. Each query attends as
    a one-query contraction of ``decode_rows``, the decode row whose bits it
    keeps (by default the plain one over the S positions; models/attention.py
    ``prefill_attention_with_kv``).

    For the hybrid and ssm families, and with ``return_hidden`` for every
    family but encdec, it is the reference's ``forward``: ``(logits,
    hidden)``, the final-norm hidden states (B, S, D) the logits are
    projected from (the embedding surface of the non-generative serve
    step; None without ``return_hidden``), no K/V. The recurrent families
    admit by ``serve.prefill_recurrent``; the hybrid's attention runs its
    queries as the prefill's one-query contractions, the xlstm its blocks'
    full-sequence forms. MoE layers route row-isolated on the K/V path and
    with the shared, dropping capacity on the ``return_hidden`` path, as the
    reference's training forward does, so there (and only for MoE) the
    logits are not the K/V path's bits. For encdec it is
    ``_encdec_forward``: ``(logits, None)``."""
    check_family(cfg)
    src = tokens if embeds is None else embeds
    B, S = src.shape[:2]
    dev = src.device
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if cfg.family == "encdec":
        if return_hidden:
            raise ValueError("return_hidden is a decoder-only path, not encdec")
        return _encdec_forward(params, cfg, embeds, tokens), None
    with tracing.span("fwd.embed"):
        x = embed_tokens(params, cfg, tokens) if embeds is None else embeds.to(L.cdtype(cfg))
    if cfg.family in ("hybrid", "ssm"):
        body = _hybrid_forward if cfg.family == "hybrid" else _xlstm_forward
        hidden = L.apply_norm(params["final_ln"], body(params, cfg, x, positions,
                                                       decode_rows), cfg)
        return _head(params, cfg, hidden), (hidden if return_hidden else None)
    int8_kv = cfg.kv_cache_dtype == "int8"
    names = kv_names(cfg)
    entries = []
    for i in range(cfg.n_layers):
        with tracing.span("fwd.layer", i=i):
            lp = layer_params(params["layers"], i)
            with tracing.span("fwd.attn"):
                h = L.apply_norm(lp["ln1"], x, cfg)
                o, *kv = A.prefill_attention_with_kv(lp["attn"], h, cfg, positions=positions,
                                                     positions3=positions3, int8_kv=int8_kv,
                                                     decode_rows=decode_rows)
                x = x + o
            with tracing.span("fwd.ffn"):
                h = L.apply_norm(lp["ln2"], x, cfg)
                x = x + ffn(lp, h, cfg, row_isolated=not return_hidden)
        if not return_hidden:
            entries.append(kv)
    with tracing.span("fwd.head"):
        if return_hidden:
            hidden = L.apply_norm(params["final_ln"], x, cfg)
            return _head(params, cfg, hidden), hidden
        logits = _logits(params, cfg, x)
    return logits, {n: torch.stack([e[j] for e in entries]) for j, n in enumerate(names)}


def xlstm_pair(lp: Dict, x: torch.Tensor, cfg: ArchConfig, state=None,
               decode: bool = False):
    """A pre-norm mLSTM block, then a pre-norm sLSTM block, each added to
    the residual stream x (B, T, D). ``state`` is ((C, n, m), (c, n, h,
    m)) or None (pristine). Returns ``(x, (mlstm_state, slstm_state))``."""
    ms, ss = state if state is not None else (None, None)
    y, ms = XL.apply_mlstm(lp["mlstm"], L.apply_norm(lp["ln_m"], x, cfg), cfg,
                           state=ms, decode=decode)
    x = x + y
    y, ss = XL.apply_slstm(lp["slstm"], L.apply_norm(lp["ln_s"], x, cfg), cfg,
                           state=ss, decode=decode)
    return x + y, (ms, ss)


def _xlstm_forward(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, decode_rows) -> torch.Tensor:
    """xlstm's full-sequence pass: every pair from a pristine state, the
    mLSTM in its chunked form. Returns the final residual stream."""
    pairs = params["xlstm"]["pairs"]
    for i in range(cfg.n_layers // 2):
        x = xlstm_pair(layer_params(pairs, i), x, cfg)[0]
    return x


def _encdec_forward(params: Dict, cfg: ArchConfig, frames: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """seamless's forward: the bidirectional encoder over the frame
    embeddings (B, Se, D), its final norm, then the causal decoder over
    ``tokens`` (B, S), each layer cross-attending the encoder's output
    through K/V projected by its cross-attention's wk and wv. Attention is
    the full-sequence kind (models/attention.py ``attention``). Returns the
    logits (B, S, V_pad)."""
    x = frames.to(L.cdtype(cfg))
    B, Se = x.shape[:2]
    enc_pos = torch.arange(Se, dtype=torch.int32, device=x.device).expand(B, Se)
    for i in range(cfg.n_enc_layers):
        lp = layer_params(params["encoder"], i)
        x = x + A.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                            positions=enc_pos, causal=False)
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    enc_out = L.apply_norm(params["enc_final_ln"], x, cfg)
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for i in range(cfg.n_layers):
        lp = layer_params(params["decoder"], i)
        x = x + A.attention(lp["self_attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                            positions=positions)
        kv = A.project_kv_for_cross(lp["cross_attn"], enc_out, cfg)
        x = x + A.attention(lp["cross_attn"], L.apply_norm(lp["ln_x"], x, cfg), cfg,
                            positions=positions, kv=kv)
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    return _logits(params, cfg, x)


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
                    positions: torch.Tensor, decode_rows) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _unstack(tree, n: int) -> List:
    """A stacked tree (every leaf (n, ...)) as n per-layer trees of views,
    by one ``unbind`` per leaf: its backward stacks the layers' grads in
    one op, where indexing layer i would give each layer a full-size zero
    grad of the stacked leaf to add."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tz.QTensor):
        return [tz.QTensor(q, s, tuple(q.shape))
                for q, s in zip(_unstack(tree.q, n), _unstack(tree.scale, n))]
    layers = torch.unbind(tree, 0)
    if len(layers) != n:
        raise ValueError(f"stacked leaf has {len(layers)} layers, expected {n}")
    return list(layers)


def _remat(fn: Callable, cfg: ArchConfig, *args):
    """``fn(*args)``; with ``cfg.remat`` under activation checkpointing
    (the reference's ``jax.checkpoint`` of each layer body): only the
    body's inputs are kept, and the backward runs the body again."""
    if cfg.remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _train_dense_layer(lp: Dict, x: torch.Tensor, cfg: ArchConfig,
                       positions: torch.Tensor, positions3: Optional[torch.Tensor]):
    """The reference's ``_dense_layer_fwd``: full-sequence attention (plain,
    or the online softmax above ``attn_chunk``), then the MLP or the MoE
    block's shared, dropping capacity. Returns ``(x, aux)``."""
    x = x + A.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                        positions=positions, positions3=positions3)
    h = L.apply_norm(lp["ln2"], x, cfg)
    if cfg.family == "moe":
        y, aux = MOE.apply_moe(lp["moe"], h, cfg)
    else:
        y, aux = L.apply_mlp(lp["mlp"], h, cfg), x.new_zeros((), dtype=torch.float32)
    return x + y, aux


def _train_hybrid(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The reference's ``_hybrid_forward``: each group (the shared block,
    whose attention is the full-sequence kind with the application's LoRA
    merged into W_q, then its mamba layers) as one remat body, then each
    tail layer."""
    hp = params["hybrid"]
    G, rem = hybrid_layout(cfg)
    shared = {"shared": hp["shared"], "lora": _unstack(hp["lora"], G)}
    groups = [_unstack(g, cfg.attn_every) for g in _unstack(hp["groups"], G)]

    def attend(ap, h):
        return A.attention(ap, h, cfg, positions=positions)

    def group(x, g, layers):
        x = shared_block(shared, g, x, cfg, attend)
        for lp in layers:
            x = mamba_layer(lp, x, cfg)[0]
        return x
    for g in range(G):
        x = _remat(group, cfg, x, g, groups[g])
    for lp in (_unstack(hp["tail"], rem) if hp.get("tail") is not None else []):
        x = _remat(lambda x, lp: mamba_layer(lp, x, cfg)[0], cfg, x, lp)
    return x


def _train_encdec(params: Dict, cfg: ArchConfig, frames: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The reference's ``_encdec_forward`` with a remat body per layer: the
    bidirectional encoder over ``frames``, its final norm, then the causal
    decoder over ``tokens`` (their f32 rows gathered, then cast, as the
    reference's decoder does), cross-attending the encoder's output.
    Returns the logits."""
    x = frames.to(L.cdtype(cfg))
    B, Se = x.shape[:2]
    enc_pos = torch.arange(Se, dtype=torch.int32, device=x.device).expand(B, Se)

    def enc(x, lp):
        x = x + A.attention(lp["attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                            positions=enc_pos, causal=False)
        return x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    for lp in _unstack(params["encoder"], cfg.n_enc_layers):
        x = _remat(enc, cfg, x, lp)
    enc_out = L.apply_norm(params["enc_final_ln"], x, cfg)

    x = torch.nn.functional.embedding(tokens.long(), params["embed"]).to(L.cdtype(cfg))
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    def dec(x, lp, enc_out):
        x = x + A.attention(lp["self_attn"], L.apply_norm(lp["ln1"], x, cfg), cfg,
                            positions=positions)
        kv = A.project_kv_for_cross(lp["cross_attn"], enc_out, cfg)
        x = x + A.attention(lp["cross_attn"], L.apply_norm(lp["ln_x"], x, cfg), cfg,
                            positions=positions, kv=kv)
        return x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), cfg)
    for lp in _unstack(params["decoder"], cfg.n_layers):
        x = _remat(dec, cfg, x, lp, enc_out)
    return _logits(params, cfg, x)


def train_forward(params: Dict, cfg: ArchConfig, batch: Dict) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """The training forward, the reference's ``forward(params, cfg, batch)``
    without ``return_kv``: differentiable, over the same param trees.
    ``batch`` holds ``tokens`` (B, S), or ``embeds`` (B, S, D) (the vlm,
    with ``positions3`` (3, B, S) under M-RoPE); the encdec takes both,
    ``embeds`` its encoder's frames and ``tokens`` its decoder's input.
    Returns ``(logits (B, S, V_pad), aux)``, aux the MoE load-balance loss
    summed over layers (0 for the other families).

    Attention is the full-sequence kind (``attention.attention``), not the
    serving routes' one-query contractions, and MoE layers route with the
    shared, dropping capacity. Token rows come from ``F.embedding`` of the
    table cast to the compute dtype (the reference casts, then gathers):
    its CUDA backward adds a repeated token's rows in a fixed order, so a
    step's grads repeat bitwise. Every layer body runs under :func:`_remat`
    when ``cfg.remat``."""
    check_family(cfg)
    if cfg.family == "encdec":
        return (_train_encdec(params, cfg, batch["embeds"], batch["tokens"]),
                params["embed"].new_zeros((), dtype=torch.float32))
    if "embeds" in batch:
        x = batch["embeds"].to(L.cdtype(cfg))
    else:
        x = torch.nn.functional.embedding(batch["tokens"].long(),
                                          params["embed"].to(L.cdtype(cfg)))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux = x.new_zeros((), dtype=torch.float32)
    if cfg.family in DENSE_FAMILIES:
        positions3 = batch.get("positions3")
        for lp in _unstack(params["layers"], cfg.n_layers):
            x, a = _remat(_train_dense_layer, cfg, lp, x, cfg, positions, positions3)
            aux = aux + a
    elif cfg.family == "hybrid":
        x = _train_hybrid(params, cfg, x, positions)
    else:
        for lp in _unstack(params["xlstm"]["pairs"], cfg.n_layers // 2):
            x = _remat(lambda x, lp: xlstm_pair(lp, x, cfg)[0], cfg, x, lp)
    return _logits(params, cfg, x), aux
