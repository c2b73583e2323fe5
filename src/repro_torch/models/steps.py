"""Serving step functions: plain callables (PyTorch runs eagerly, so there
is nothing to jit). Greedy argmax only; sampling is ROADMAP queue 1 item 9."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serve as SV


def make_prefill_with_cache_step(cfg: ArchConfig) -> Callable:
    """Fused admission step: right-padded prompt bucket (B, S) and each row's
    last prompt position in; ``(first_tokens (B,), kv)`` out."""
    def prefill_step(params: Dict, tokens: torch.Tensor, last_index: torch.Tensor):
        logits, kv = SV.prefill_with_cache(params, cfg, tokens)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        row = logits[rows, last_index.long()]
        return torch.argmax(row.to(torch.float32), dim=-1), kv
    return prefill_step


def make_paged_decode_step(cfg: ArchConfig) -> Callable:
    """Block-native decode step: ``(params, cache, tokens (B, 1))`` ->
    ``(next_tokens (B,), cache)``. The pool is written in place where the JAX
    engine donates the cache (serving/engine.py there)."""
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor):
        logits, cache = SV.decode_paged(params, cfg, cache, tokens)
        return torch.argmax(logits[:, -1].to(torch.float32), dim=-1), cache
    return decode_step
