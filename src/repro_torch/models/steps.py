"""Serving step functions: plain callables (PyTorch runs eagerly, so there
is nothing to jit). Greedy argmax only; sampling is ROADMAP queue 1 item 9.

Every step leaves its inputs as they were, or rewrites in place only cells
it writes with the same values on every run, so an OPQ backup re-issue of
a step has no effect."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serve as SV


def _greedy(row: torch.Tensor) -> torch.Tensor:
    return torch.argmax(row.to(torch.float32), dim=-1)


def make_prefill_with_cache_step(cfg: ArchConfig) -> Callable:
    """Fused admission step: right-padded prompt bucket (B, S) and each row's
    last prompt position in; ``(first_tokens (B,), kv)`` out."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor):
        logits, kv = SV.prefill_with_cache(params, cfg, tokens)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return _greedy(logits[rows, last_index.long()]), kv
    return prefill_step


def make_chunked_prefill_step(cfg: ArchConfig, chunk: int) -> Callable:
    """Chunked admission step (long prompts): the fused step's contract,
    scanning the bucket ``chunk`` tokens at a time (models/serve.py
    ``prefill_with_cache_chunked``)."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor):
        row, kv = SV.prefill_with_cache_chunked(params, cfg, tokens, last_index, chunk)
        return _greedy(row), kv
    return prefill_step


def make_suffix_prefill_step(cfg: ArchConfig, chunk: int,
                             width: Optional[int] = None) -> Callable:
    """Suffix admission step (shared-prefix cache hits): the chunked scan
    resumed at ``start_chunk`` (a Python int) blocks of ``chunk`` over
    accumulators seeded with ``kv0``, the cached prefix rows, the rest of the
    bucket in pieces of ``width`` (models/serve.py
    ``prefill_with_cache_suffix``)."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor,
                     kv0: Dict, start_chunk: int):
        row, kv = SV.prefill_with_cache_suffix(params, cfg, tokens, last_index,
                                               chunk, kv0, start_chunk, width)
        return _greedy(row), kv
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """Contiguous decode step: ``(params, cache, tokens (B, 1))`` ->
    ``(next_tokens (B,), cache)``; the contiguous store and the paged gather
    bridge both run it. The rows are written in place where the JAX engine
    donates the cache; the index comes back as a new tensor."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor):
        logits, cache = SV.decode(params, cfg, cache, tokens)
        return _greedy(logits[:, -1]), cache
    return decode_step


def make_paged_decode_step(cfg: ArchConfig, use_kernel: bool = True) -> Callable:
    """Block-native decode step: ``(params, cache, tokens (B, 1))`` ->
    ``(next_tokens (B,), cache)``, through the paged-attention kernel with
    ``use_kernel`` (float KV) or the plain gather and contraction."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor):
        logits, cache = SV.decode_paged(params, cfg, cache, tokens, use_kernel=use_kernel)
        return _greedy(logits[:, -1]), cache
    return decode_step
