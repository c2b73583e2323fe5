"""Serving step functions: plain callables (PyTorch runs eagerly, so there
is nothing to jit).

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

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.attention import DecodeRows
from repro_torch.models import serve as SV
from repro_torch.serving import sampling as SMP


def _emit(cfg: ArchConfig, row: torch.Tensor, payload, sampling: Optional[Dict],
          positions):
    """The token of each logits row and the step's return tuple."""
    tok = SMP.choose_tokens(row, sampling, positions)
    if sampling is None:
        return tok, payload
    return tok, payload, SMP.logprob_info(row, tok, cfg.vocab)


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
    donates the cache; the index comes back as a new tensor."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                    sampling: Optional[Dict] = None):
        logits, cache = SV.decode(params, cfg, cache, tokens)
        return _emit(cfg, logits[:, -1], cache, sampling, cache["index"])
    return decode_step


def make_paged_decode_step(cfg: ArchConfig, use_kernel: bool = True) -> Callable:
    """Block-native decode step: ``(params, cache, tokens (B, 1))`` ->
    ``(next_tokens (B,), cache)``, through the paged-attention kernel with
    ``use_kernel`` (float KV) or the plain gather and contraction."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                    sampling: Optional[Dict] = None):
        logits, cache = SV.decode_paged(params, cfg, cache, tokens, use_kernel=use_kernel)
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
    prefill's bucketed forward (its ``decode_rows`` too), returning each
    row's last-position final-norm hidden state and its last-position
    logits row, both f32; no cache."""
    def embed_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor):
        logits, hidden = M.forward(params, cfg, tokens, return_hidden=True,
                                   decode_rows=decode_rows)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        idx = last_index.long()
        return hidden[rows, idx].to(torch.float32), logits[rows, idx].to(torch.float32)
    return embed_step
