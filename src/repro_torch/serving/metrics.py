"""Serving telemetry: per-request latency records, engine counters, the
per-transport RPC counters of the fleet, and the one-line summaries — the
port of ``repro.serving.metrics``.

TTFT (arrival -> first token) splits into queue_wait_s (arrival ->
admission) and prefill_s (admission -> first token: the fused prefill plus
the seed write). ``tokens_generated`` reconciles with the sum of every
request's ``n_generated``; the speculative counters reconcile with it
(``accepted_tokens`` = emitted - 1 per slot-round).
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
    evicted: int = 0                           # queued requests pulled by a
                                               # router drain (re-placed
                                               # elsewhere, never admitted)
    preempted: int = 0                         # in-flight requests handed off
                                               # by a router drain
    completed: int = 0
    tokens_generated: int = 0                  # prefill first tokens + every
                                               # token decode emitted (a
                                               # speculative round emits
                                               # 1..k+1 per slot)
    decode_steps: int = 0                      # target decode-path forwards
                                               # (plain steps + verify rounds)
    spec_rounds: int = 0                       # draft-verify rounds
    draft_steps: int = 0                       # draft decode dispatches
    proposed_tokens: int = 0                   # draft proposals verified
                                               # (spec_k per active slot-round)
    accepted_tokens: int = 0                   # proposals the target confirmed
                                               # (emitted - 1 per slot-round)
    accept_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
                                               # {tokens emitted in a
                                               # slot-round: rounds}
    sampled_tokens: int = 0                    # tokens of non-greedy requests
    stop_hits: int = 0                         # stop-sequence finishes
    embed_requests: int = 0                    # non-generative forwards
    prefill_batches: int = 0
    prefill_tokens: int = 0                    # unpadded prompt tokens
    prefill_chunks: int = 0                    # block-size prefill chunks
                                               # computed (prefix-cache
                                               # engines: cached chunks skip)
    prefix_hits: int = 0                       # leases that matched cached
                                               # prefix blocks (or a COW fork)
    prefix_blocks_reused: int = 0              # whole cached blocks leased by
                                               # refcount instead of prefilled
    prefix_tokens_reused: int = 0              # prompt positions whose
                                               # prefill was skipped
    exported_slots: int = 0                    # in-flight requests extracted
                                               # with their cache blocks
                                               # (disaggregation)
    exported_blocks: int = 0                   # pool blocks serialized out
    imported_slots: int = 0                    # requests admitted from a
                                               # shipped payload (no prefill)
    imported_blocks: int = 0                   # pool blocks adopted verbatim
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
            "evicted": self.evicted,
            "preempted": self.preempted,
            "completed": self.completed,
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "spec_rounds": self.spec_rounds,
            "draft_steps": self.draft_steps,
            "proposed_tokens": self.proposed_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": self.accepted_tokens / max(self.proposed_tokens, 1),
            "accept_hist": dict(sorted(self.accept_hist.items())),
            "sampled_tokens": self.sampled_tokens,
            "stop_hits": self.stop_hits,
            "embed_requests": self.embed_requests,
            "prefill_batches": self.prefill_batches,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "prefix_hits": self.prefix_hits,
            "prefix_blocks_reused": self.prefix_blocks_reused,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "exported_slots": self.exported_slots,
            "exported_blocks": self.exported_blocks,
            "imported_slots": self.imported_slots,
            "imported_blocks": self.imported_blocks,
            "prefill_wait_s": self.prefill_wait_s,
            "seed_write_s": self.seed_write_s,
            "sustained_tok_s": self.sustained_tok_s(),
            "mean_queue_depth": self.queue_depth_sum / max(self.steps, 1),
            "mean_occupancy": self.occupancy_sum / max(self.steps, 1),
        }


@dataclasses.dataclass
class TransportMetrics:
    """Per-transport RPC telemetry (serving/transport.py): every Router->host
    call is one RPC, across a process boundary or not (in-process calls are
    timed the same way, the baseline of the subprocess overhead)."""

    rpcs: int = 0
    retries: int = 0                           # idempotent calls re-sent
                                               # after a timeout or drop
    errors: int = 0                            # calls that raised
                                               # TransportError
    rpc_wait_s: float = 0.0                    # wall time inside RPCs

    def observe(self, dt: float) -> None:
        self.rpcs += 1
        self.rpc_wait_s += dt

    def summary(self) -> Dict[str, float]:
        return {
            "rpcs": self.rpcs,
            "retries": self.retries,
            "errors": self.errors,
            "rpc_wait_s": self.rpc_wait_s,
            "mean_rpc_us": 1e6 * self.rpc_wait_s / max(self.rpcs, 1),
        }


def format_transport_stats(stats: Dict) -> str:
    """One-line fleet-transport summary from ``Router.stats()``: RPC volume
    and latency, and the loss and recovery counters."""
    r = stats["router"]
    per_host = r.get("transport", [])
    kinds = {t["kind"] for t in per_host}
    rpcs = sum(t["rpcs"] for t in per_host)
    retries = sum(t["retries"] for t in per_host)
    errors = sum(t["errors"] for t in per_host)
    mean_us = 1e6 * sum(t["rpc_wait_s"] for t in per_host) / rpcs if rpcs else 0.0
    lost = f" | lost={r['lost']}" if r.get("lost") else ""
    return (f"transport[{'/'.join(sorted(kinds))}]: {rpcs} rpcs "
            f"({mean_us:.0f} us mean) | {retries} retries, {errors} errors | "
            f"{r.get('hosts_lost', 0)} hosts lost -> "
            f"{r.get('recovered', 0)} streams recovered{lost}")


def format_router_stats(stats: Dict) -> str:
    """One-line fleet summary from ``Router.stats()``: the placement ledger
    (placed/affinity_hits, the cross-host analog of OPQ's per-lane counts),
    drain and handoff activity, and the disaggregation ships."""
    r = stats["router"]
    f = stats["fleet"]
    drained = f" | draining={r['draining']}" if r.get("draining") else ""
    ships = ""
    if r.get("roles"):
        ships = (f" | disagg: {r.get('ships', 0)} ships "
                 f"({r.get('shipped_blocks', 0)} blocks, "
                 f"{r.get('ship_fallbacks', 0)} fallbacks)")
    return (f"{r['hosts']} hosts | {r['placed']} placed "
            f"({r['affinity_hits']} affinity hits, {r['spills']} spills) | "
            f"{r['drains']} drains -> {r['handoffs']} handoffs + "
            f"{r['requeued']} requeued{ships} | fleet: {f['completed']} done, "
            f"{f['tokens_generated']} tok, {f['sustained_tok_s']:.1f} tok/s"
            f"{drained}")


def format_spec_stats(s: Dict) -> str:
    """One-line speculative-decode summary from ``EngineMetrics.summary()``:
    target dispatches against the tokens they bought, and the histogram of
    tokens emitted per slot-round."""
    hist = " ".join(f"{length}:{count}" for length, count in s["accept_hist"].items())
    spt = s["decode_steps"] / max(s["tokens_generated"] - s["completed"], 1)
    return (f"speculative: {s['spec_rounds']} rounds + {s['draft_steps']} "
            f"draft steps | {s['accepted_tokens']}/{s['proposed_tokens']} "
            f"proposals accepted ({s['acceptance_rate']:.2f}) | "
            f"{spt:.2f} target steps/decode-token | "
            f"accepted-length hist {{{hist}}}")


def format_sampling_stats(s: Dict) -> str:
    """One-line sampling summary from ``EngineMetrics.summary()``."""
    return (f"sampling: {s['sampled_tokens']}/{s['tokens_generated']} tokens "
            f"sampled | {s['stop_hits']} stop-sequence finishes | "
            f"{s['embed_requests']} embed requests")


def format_memory_stats(ms: Dict) -> str:
    """One-line cache-memory summary from ``SlotStore.memory_stats()``."""
    kib = ms.get("bytes", 0) / 1024.0
    if ms.get("backend") == "paged":
        if ms.get("native"):
            tail = "block-native decode (no transient view)"
        else:
            tail = f"+{ms.get('decode_view_bytes', 0) / 1024.0:.1f} KiB transient decode view"
        if "prefix_cached_blocks" in ms:
            tail += (f" | prefix: {ms['prefix_hits']} hits, "
                     f"{ms['prefix_blocks_reused']} blocks reused, "
                     f"{ms['prefix_cached_blocks']} cached, "
                     f"{ms['prefix_evictions']} evicted, "
                     f"{ms['cow_forks']} COW forks")
        return (f"paged: {kib:.1f} KiB pool | block={ms['block_size']} tok | "
                f"{ms['blocks_used']}/{ms['blocks_total']} blocks used "
                f"({ms['blocks_free']} free) | {tail}")
    per_slot = ms.get("bytes_per_slot", 0) / 1024.0
    return (f"{ms.get('backend', '?')}: {kib:.1f} KiB "
            f"({per_slot:.1f} KiB/slot x {ms.get('slots', 0)} slots)")
