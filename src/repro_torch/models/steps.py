"""Step functions: plain callables (PyTorch runs eagerly, so there is
nothing to jit). ``make_train_step`` is the training step (forward, CE
loss, backward, grad clip, AdamW); the rest are the serving steps.

Every admission and decode step takes an optional trailing ``sampling``
(stacked ``serving/sampling.py`` params on the step's device). Without it
the step is the greedy argmax and returns ``(tokens, kv_or_cache)``; with
it the token choice is the batched, batch-invariant sampler and the step
returns ``(tokens, kv_or_cache, logprob_info)``: the chosen token's
logprob and the top alternatives, from the same logits row. The
randomness counter is the emitted token's absolute position:
``last_index + 1`` at admission, the post-step cache index at decode.

Every step leaves its inputs as they were, or rewrites in place only cells
it writes with the same values on every run, so an OPQ backup re-issue of
a step has no effect."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core import tensorizer as tz
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.attention import DecodeRows, cache_spec
from repro_torch.models import serve as SV
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.serving import sampling as SMP

AUX_WEIGHT = 0.01


def _emit(cfg: ArchConfig, row: torch.Tensor, payload, sampling: Optional[Dict],
          positions):
    """The token of each logits row and the step's return tuple."""
    tok = SMP.choose_tokens(row, sampling, positions)
    if sampling is None:
        return tok, payload
    return tok, payload, SMP.logprob_info(row, tok, cfg.vocab)


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """The next-token distribution of a full-sequence forward, every
    family, the reference's ``make_prefill_step``: its ``forward`` without
    K/V (``model.train_forward`` without autograd: plain attention, or the
    online softmax above ``attn_chunk``; MoE's shared, dropping capacity).
    ``prefill_step(params, tokens, embeds=None, positions3=None)`` -> the
    last position's logits (B, V_pad) (the vlm's embeds and M-RoPE
    positions, the encdec's decoder tokens and frame embeddings)."""
    def prefill_step(params: Dict, tokens: Optional[torch.Tensor],
                     embeds: Optional[torch.Tensor] = None,
                     positions3: Optional[torch.Tensor] = None):
        batch = {k: v for k, v in (("tokens", tokens), ("embeds", embeds),
                                   ("positions3", positions3)) if v is not None}
        with torch.no_grad():
            logits = M.train_forward(params, cfg, batch)[0]
        return logits[:, -1, :]
    return prefill_step


def make_prefill_with_cache_step(cfg: ArchConfig,
                                 decode_rows: Optional[DecodeRows] = None) -> Callable:
    """Fused admission step: right-padded prompt bucket (B, S) and each row's
    last prompt position in; ``(first_tokens (B,), kv)`` out (plus the
    logprob info with ``sampling``). ``decode_rows``: the decode row whose
    one-query contraction each query runs, for decode's bits in every row."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor,
                     sampling: Optional[Dict] = None):
        logits, kv = SV.prefill_with_cache(params, cfg, tokens, decode_rows)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return _emit(cfg, logits[rows, last_index.long()], kv, sampling, last_index + 1)
    return prefill_step


def make_recurrent_prefill_step(cfg: ArchConfig, max_seq_len: int) -> Callable:
    """Admission step of the recurrent families: the fused step's
    contract, ``(first_tokens (B,), cache)`` with the post-prompt state rows
    of a ``max_seq_len`` cache, by the masked replay of the decode body over
    the bucket (models/serve.py ``prefill_recurrent``)."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor,
                     sampling: Optional[Dict] = None):
        row, cache = SV.prefill_recurrent(params, cfg, tokens, last_index, max_seq_len)
        return _emit(cfg, row, cache, sampling, last_index + 1)
    return prefill_step


def make_chunked_prefill_step(cfg: ArchConfig, chunk: int,
                              decode_rows: Optional[DecodeRows] = None) -> Callable:
    """Chunked admission step (long prompts): the fused step's contract,
    scanning the bucket ``chunk`` tokens at a time (models/serve.py
    ``prefill_with_cache_chunked``)."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor,
                     sampling: Optional[Dict] = None):
        row, kv = SV.prefill_with_cache_chunked(params, cfg, tokens, last_index, chunk,
                                                decode_rows)
        return _emit(cfg, row, kv, sampling, last_index + 1)
    return prefill_step


def make_suffix_prefill_step(cfg: ArchConfig, chunk: int, width: Optional[int] = None,
                             decode_rows: Optional[DecodeRows] = None) -> Callable:
    """Suffix admission step (shared-prefix cache hits): the chunked scan
    resumed at ``start_chunk`` (a Python int) blocks of ``chunk`` over
    accumulators seeded with ``kv0``, the cached prefix rows, the rest of the
    bucket in pieces of ``width`` (models/serve.py
    ``prefill_with_cache_suffix``)."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor,
                     kv0: Dict, start_chunk: int, sampling: Optional[Dict] = None):
        row, kv = SV.prefill_with_cache_suffix(params, cfg, tokens, last_index,
                                               chunk, kv0, start_chunk, width, decode_rows)
        return _emit(cfg, row, kv, sampling, last_index + 1)
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """Contiguous decode step: ``(params, cache, tokens (B, 1))`` ->
    ``(next_tokens (B,), cache)``; the contiguous store and the paged gather
    bridge both run it. The rows are written in place where the JAX engine
    donates the cache; the index comes back as a new tensor. ``active``
    (B,) bool, the engine's busy slots, masks idle slots out of the MoE
    capacity cumsum (models/moe.py); ``positions3`` (3, B, 1) the M-RoPE
    positions (by default the index on all three sections)."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                    sampling: Optional[Dict] = None,
                    active: Optional[torch.Tensor] = None,
                    positions3: Optional[torch.Tensor] = None):
        logits, cache = SV.decode(params, cfg, cache, tokens, active=active,
                                  positions3=positions3)
        return _emit(cfg, logits[:, -1], cache, sampling, cache["index"])
    return decode_step


def make_paged_decode_step(cfg: ArchConfig, use_kernel: bool = True) -> Callable:
    """Block-native decode step: ``(params, cache, tokens (B, 1))`` ->
    ``(next_tokens (B,), cache)``, through the paged-attention kernel with
    ``use_kernel`` (float KV) or the plain gather and contraction; ``active``
    as in :func:`make_decode_step`."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                    sampling: Optional[Dict] = None,
                    active: Optional[torch.Tensor] = None):
        logits, cache = SV.decode_paged(params, cfg, cache, tokens, use_kernel=use_kernel,
                                        active=active)
        return _emit(cfg, logits[:, -1], cache, sampling, cache["index"])
    return decode_step


def make_verify_step(cfg: ArchConfig, window: int) -> Callable:
    """Speculative-verify step: ``tokens`` (B, W) is each slot's last
    emitted token and W-1 draft proposals, scored by the target in one
    forward (models/serve.py ``verify_window``). Returns ``(greedy (B, W),
    cache, logprob_info over every window position)``: position j's greedy
    token is what sequential decode would emit after accepting j window
    tokens, bit for bit."""
    def verify_step(params: Dict, cache: Dict, tokens: torch.Tensor):
        logits, cache = SV.verify_window(params, cfg, cache, tokens, window)
        greedy = torch.argmax(logits.to(torch.float32), dim=-1)
        return greedy, cache, SMP.logprob_info(logits, greedy, cfg.vocab)
    return verify_step


def make_paged_verify_step(cfg: ArchConfig, window: int) -> Callable:
    """Block-native speculative-verify step: ``make_verify_step``'s contract
    over the paged pool and block tables (models/serve.py
    ``verify_window_paged``)."""
    def verify_step(params: Dict, cache: Dict, tokens: torch.Tensor):
        logits, cache = SV.verify_window_paged(params, cfg, cache, tokens, window)
        greedy = torch.argmax(logits.to(torch.float32), dim=-1)
        return greedy, cache, SMP.logprob_info(logits, greedy, cfg.vocab)
    return verify_step


def make_embed_step(cfg: ArchConfig,
                    decode_rows: Optional[DecodeRows] = None) -> Callable:
    """Non-generative forward (embeddings, classification): the fused
    prefill's bucketed forward (its ``decode_rows`` too; the hybrid's
    forward runs its mamba layers in the chunked SSD form), returning each
    row's last-position final-norm hidden state and its last-position
    logits row, both f32; no cache."""
    def embed_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor):
        logits, hidden = M.forward(params, cfg, tokens, return_hidden=True,
                                   decode_rows=decode_rows)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        idx = last_index.long()
        return hidden[rows, idx].to(torch.float32), logits[rows, idx].to(torch.float32)
    return embed_step


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE, logsumexp in f32 over the padded vocab (the padded
    columns sit near -1e30 and add nothing)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_fn(params: Dict, cfg: ArchConfig, batch: Dict):
    """``(loss, {"ce", "aux"})``: next-token CE (position t predicts label
    t + 1) plus ``AUX_WEIGHT`` times the MoE load-balance loss."""
    logits, aux = M.train_forward(params, cfg, batch)
    ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def _cast_grads(grads, dtype_str: str):
    """Every grad leaf in ``dtype_str`` (``cfg.grad_allreduce_dtype``: the
    data-parallel reduction's dtype; AdamW's math stays f32)."""
    dt = getattr(torch, dtype_str)
    return T.tree_map(lambda g: g.to(dt), grads)


def forward_for_grads(params: Dict, cfg: ArchConfig, batch: Dict):
    """``loss_fn`` with autograd recording: the params (f32 leaves) are
    marked as requiring grad. Returns ``(loss, {"ce", "aux"})``, the loss
    still attached to its graph for ``grads_of``."""
    for p in T.leaves(params):
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, cfg, batch)
    return loss, {k: v.detach() for k, v in metrics.items()}


def grads_of(loss: torch.Tensor, params: Dict) -> Dict:
    """The grads of ``loss`` in the tree of ``params``, by one backward. A
    leaf the forward does not reach (the vlm's token table) gets zeros, as
    the reference's grad does."""
    flat, spec = T.flatten(params)
    return T.unflatten(spec, torch.autograd.grad(loss, flat, allow_unused=True,
                                                 materialize_grads=True))


def apply_update(params: Dict, grads: Dict, opt_state, step, cfg: ArchConfig):
    """The update half of the step, in place: the grads cast to
    ``cfg.grad_allreduce_dtype``, clipped to global norm ``cfg.grad_clip``,
    the cosine lr of ``step`` (an int or an int32 tensor; 0 at step 0),
    then AdamW with ``cfg.weight_decay``. Returns ``(params, opt_state,
    {"gnorm", "lr"})``."""
    grads = _cast_grads(grads, cfg.grad_allreduce_dtype)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = cosine_schedule(torch.as_tensor(step, device=T.leaves(params)[0].device),
                         peak=cfg.learning_rate)
    params, opt_state = adamw_update(params, grads, opt_state, lr,
                                     weight_decay=cfg.weight_decay)
    return params, opt_state, {"gnorm": gnorm, "lr": lr}


def make_train_step(cfg: ArchConfig) -> Callable:
    """``train_step(params, opt_state, batch, step)`` ->
    ``(params, opt_state, metrics)``: ``forward_for_grads``, ``grads_of``
    and ``apply_update``, the params and moments updated in place.
    ``metrics``: ``loss``, ``ce``, ``aux``, ``gnorm`` and ``lr``, 0-d f32
    tensors on the params' device."""
    def train_step(params: Dict, opt_state, batch: Dict, step):
        loss, metrics = forward_for_grads(params, cfg, batch)
        grads = grads_of(loss, params)
        params, opt_state, upd = apply_update(params, grads, opt_state, step, cfg)
        return params, opt_state, {"loss": loss.detach(), **metrics, **upd}
    return train_step


# ---------------------------------------------------------------------------
# dry-run input specs: meta tensors (never allocated) and their partition
# specs, the reference's ShapeDtypeStructs with shardings
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _fit(shape, spec: Tuple) -> Tuple:
    """Drop sharding on dims the axis sizes don't divide (e.g. batch=1
    cells); one entry per dim."""
    mesh = shd.current_mesh()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        axes = e if isinstance(e, (tuple, list)) else (e,) if e else ()
        size = math.prod(mesh.shape[a] for a in axes)
        out.append(e if (size and dim % size == 0) else None)
    return tuple(out)


def shard_shape(shape, spec: Tuple) -> Tuple[int, ...]:
    """The per-device shape of a leaf of ``shape`` under a fitted ``spec``
    on the current mesh."""
    mesh = shd.current_mesh()
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = e if isinstance(e, (tuple, list)) else (e,) if e else ()
        out.append(dim // math.prod(mesh.shape[a] for a in axes))
    return tuple(out)


def _lead() -> Any:
    b = shd.batch_axes()
    return b if len(b) > 1 else (b[0] if b else None)


def batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[Dict, Dict]:
    """A cell's model inputs on meta and their specs (batch over the data
    axes): decode ``tokens`` (B, 1) (+ ``positions3`` (3, B, 1) for
    M-RoPE); train and prefill ``tokens`` (B, S), or the frontend stubs'
    ``embeds`` (the encdec's frames (B, S / enc_len_ratio, D) beside its
    decoder tokens), M-RoPE ``positions3``; train adds ``labels``."""
    B, S = shape.global_batch, shape.seq_len
    lead = _lead()
    out: Dict[str, torch.Tensor] = {}
    specs: Dict[str, Tuple] = {}

    def put(name, shp, dtype, spec):
        out[name] = torch.empty(shp, dtype=dtype, device=META)
        specs[name] = _fit(shp, shd.scrub(spec))

    def tok(name, shp):
        put(name, shp, torch.int32, (lead,) + (None,) * (len(shp) - 1))
    if shape.kind == "decode":
        tok("tokens", (B, 1))
        if cfg.rope_kind == "mrope":
            put("positions3", (3, B, 1), torch.int32, (None, lead, None))
        return out, specs
    if cfg.input_mode == "embeds":
        dt = L.cdtype(cfg)
        if cfg.is_encdec:
            put("embeds", (B, max(1, S // cfg.enc_len_ratio), cfg.d_model), dt,
                (lead, None, None))
            tok("tokens", (B, S))
        else:
            put("embeds", (B, S, cfg.d_model), dt, (lead, None, None))
        if cfg.rope_kind == "mrope":
            put("positions3", (3, B, S), torch.int32, (None, lead, None))
    else:
        tok("tokens", (B, S))
    if shape.kind == "train":
        tok("labels", (B, S))
    return out, specs


def _walk_specs(tree, spec_of, path=()):
    """The parallel tree of ``spec_of(path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: _walk_specs(v, spec_of, path + (k,)) for k, v in tree.items()}
    if tree is None:
        return None
    return spec_of(path, tree)


def cache_specs(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[Dict, Dict]:
    """``serve.init_cache``'s cache for the cell on meta and its specs: K/V
    rows by ``attention.cache_spec`` (the sequence over data where the
    batch cannot cover the data axes), every other leaf of two or more dims
    batch over the data axes at dim 1."""
    cache = SV.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
    seq_shard = shape.global_batch < shd.data_parallel_size()
    kv_spec = (None,) + cache_spec(cfg, seq_shard)

    def spec_of(path, leaf):
        if path[-1] in ("k", "v", "cross_k", "cross_v"):
            return _fit(leaf.shape, shd.scrub(kv_spec))
        if leaf.ndim >= 2:
            return _fit(leaf.shape, shd.scrub((None, _lead()) + (None,) * (leaf.ndim - 2)))
        return ()
    return cache, _walk_specs(cache, spec_of)


def param_sds(cfg: ArchConfig) -> Tuple[Dict, Dict]:
    """``init_model``'s tree on meta (nothing drawn: the generator is None
    there) and its fitted ``param_specs``. With ``cfg.quantize == "serve"``
    the tree mirrors the serving build, ``tensorizer.quantize_params``
    under the serve CLI's predicate: projection weights become QTensors of
    int8 ``q`` and f32 per-channel ``scale``, whose spec is a QTensor of
    the two specs (the scale's size-1 dims unsharded)."""
    params = M.init_model(cfg, None, device=META)
    specs = M.param_specs(cfg)
    if cfg.quantize == "serve":
        from repro_torch.launch.serve import quant_predicate
        params = tz.quantize_params(params, quant_predicate)

    def attach(leaf, spec):
        if isinstance(leaf, dict):
            return {k: attach(leaf[k], spec[k]) for k in leaf}
        if leaf is None:
            return None
        if isinstance(leaf, tz.QTensor):
            full = list(spec) + [None] * (leaf.scale.ndim - len(spec))
            sspec = tuple(e if d > 1 else None for d, e in zip(leaf.scale.shape, full))
            return tz.QTensor(_fit(leaf.q.shape, shd.scrub(spec)),
                              _fit(leaf.scale.shape, shd.scrub(sspec)), leaf.meta_shape)
        return _fit(leaf.shape, shd.scrub(spec))
    return params, attach(params, specs)


def opt_sds(cfg: ArchConfig, params: Dict, param_specs: Dict) -> Tuple[Any, Any]:
    """AdamW's state for ``params`` on meta and its specs: each moment as
    its parameter; with ``cfg.zero1`` its first unsharded dim that the data
    axis divides goes over data (ZeRO-1)."""
    mesh = shd.current_mesh()
    state = adamw_init(params)

    def spec_of(leaf, spec):
        if leaf.ndim == 0:
            return ()
        if cfg.zero1:
            entries = list(spec) + [None] * (leaf.ndim - len(spec))
            flat = [a for e in entries for a in (e if isinstance(e, tuple) else (e,))]
            if "data" not in flat:
                for i, e in enumerate(entries):
                    if e is None and leaf.shape[i] % mesh.shape["data"] == 0 and leaf.shape[i] > 1:
                        entries[i] = "data"
                        break
            spec = tuple(entries)
        return spec
    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k]) for k in t}
        return None if t is None else spec_of(t, spec)
    return state, type(state)(step=(), mu=walk(state.mu, param_specs),
                              nu=walk(state.nu, param_specs))
