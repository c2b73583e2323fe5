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

from typing import Callable, Dict, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.attention import DecodeRows
from repro_torch.models import serve as SV
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule
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
    family: ``prefill_step(params, tokens, embeds=None, positions3=None)``
    -> the last position's logits (B, V_pad) (``model.forward``'s inputs:
    the vlm's embeds and M-RoPE positions, the encdec's decoder tokens and
    frame embeddings)."""
    def prefill_step(params: Dict, tokens: Optional[torch.Tensor],
                     embeds: Optional[torch.Tensor] = None,
                     positions3: Optional[torch.Tensor] = None):
        logits = M.forward(params, cfg, tokens, embeds=embeds, positions3=positions3)[0]
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
    capacity cumsum (models/moe.py)."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                    sampling: Optional[Dict] = None,
                    active: Optional[torch.Tensor] = None):
        logits, cache = SV.decode(params, cfg, cache, tokens, active=active)
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
