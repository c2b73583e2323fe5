"""Serving telemetry: per-request latency records, engine counters, and the
one-line cache-memory summary — the port of ``repro.serving.metrics``'s
single-host subset.

TTFT (arrival -> first token) splits into queue_wait_s (arrival ->
admission) and prefill_s (admission -> first token: the fused prefill plus
the seed write). ``tokens_generated`` reconciles with the sum of every
request's ``n_generated``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional


def now() -> float:
    return time.monotonic()


@dataclasses.dataclass
class RequestMetrics:
    arrival_s: float
    prompt_len: int = 0
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    n_generated: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_s is None:
            return None
        return self.admitted_s - self.arrival_s

    @property
    def prefill_s(self) -> Optional[float]:
        if self.admitted_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.admitted_s

    @property
    def decode_tok_s(self) -> Optional[float]:
        """Post-first-token generation rate for this request."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        dt = self.finish_s - self.first_token_s
        return (self.n_generated - 1) / dt if dt > 0 else float("inf")


@dataclasses.dataclass
class EngineMetrics:
    submitted: int = 0
    rejected: int = 0
    admissions_deferred: int = 0               # store lease refusals
    completed: int = 0
    tokens_generated: int = 0                  # prefill first tokens + decode
    decode_steps: int = 0
    prefill_batches: int = 0
    prefill_tokens: int = 0                    # unpadded prompt tokens
    prefill_wait_s: float = 0.0                # wall time blocked on prefills
    seed_write_s: float = 0.0                  # wall time in admission writes
    steps: int = 0
    queue_depth_sum: int = 0
    occupancy_sum: int = 0
    first_token_s: Optional[float] = None
    last_token_s: Optional[float] = None

    def observe_step(self, queue_depth: int, n_active: int) -> None:
        self.steps += 1
        self.queue_depth_sum += queue_depth
        self.occupancy_sum += n_active

    def observe_tokens(self, n: int) -> None:
        t = now()
        if self.first_token_s is None:
            self.first_token_s = t
        self.last_token_s = t
        self.tokens_generated += n

    def sustained_tok_s(self) -> float:
        if self.first_token_s is None or self.last_token_s is None:
            return 0.0
        dt = self.last_token_s - self.first_token_s
        return self.tokens_generated / dt if dt > 0 else float("inf")

    def summary(self) -> Dict[str, float]:
        return {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "admissions_deferred": self.admissions_deferred,
            "completed": self.completed,
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "prefill_batches": self.prefill_batches,
            "prefill_tokens": self.prefill_tokens,
            "prefill_wait_s": self.prefill_wait_s,
            "seed_write_s": self.seed_write_s,
            "sustained_tok_s": self.sustained_tok_s(),
            "mean_queue_depth": self.queue_depth_sum / max(self.steps, 1),
            "mean_occupancy": self.occupancy_sum / max(self.steps, 1),
        }


def format_memory_stats(ms: Dict) -> str:
    """One-line cache-memory summary from ``PagedKVStore.memory_stats()``."""
    kib = ms.get("bytes", 0) / 1024.0
    return (f"paged: {kib:.1f} KiB pool | block={ms['block_size']} tok | "
            f"{ms['blocks_used']}/{ms['blocks_total']} blocks used "
            f"({ms['blocks_free']} free) | block-native decode (no transient view)")
