"""Continuous-batching inference engine over the OPQ runtime — the port of
``repro.serving.engine`` for the slice it serves: greedy decode of a dense
model, float or int8 KV, through every SlotStore route of the reference
(contiguous rows; the paged pool through the gather bridge, block-natively
in plain torch, or block-natively through the paged-attention kernel), with
chunked prefill for long prompts and the shared-prefix radix cache.

Requests enter a bounded FIFO (admission control); a slot scheduler joins
them into a fixed-width in-flight decode batch and retires them as they
finish, with no full-batch barrier. Admission is one bucketed prefill
dispatch per bucket batch (first token + per-layer K/V in cache layout) and
one batched write into the leased slots: the fused single-shot step, the
chunked scan for buckets wider than ``prefill_chunk``, or, for prefix-cache
hits, the suffix scan over the chunks the cached prefix does not cover.
Every device step is an OPQ instruction, so buffer affinity and backup
re-issue apply to serving traffic; the per-flag instruction counts are the
dispatch audit trail.

Decode is greedy and batch-invariant: every slot computes the math of a
single-request decode at its own position (per-row activation scales,
per-slot index), so staggered arrivals give the tokens each request would
get alone.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.opq import OPQ, Buffer
from repro_torch.models import steps as ST
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics, now
from repro_torch.serving.scheduler import Scheduler, default_buckets
from repro_torch.serving.store import SlotStore, make_store


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                     # (L,) int32
    max_new_tokens: int
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    metrics: RequestMetrics = None
    finish_reason: Optional[str] = None    # "length" | "eos"

    @property
    def last_token(self) -> int:
        return self.tokens[-1]

    @property
    def done(self) -> bool:
        return self.state == RequestState.DONE


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Per-engine serving knobs, the JAX package's fields; see
    ``repro.serving.engine.EngineConfig`` for each field's meaning. The port
    serves every field but ``speculative``/``spec_k``/``draft``, which raise
    a ValueError naming the ROADMAP item that ports them, and
    ``cache_backend="recurrent"`` (item 11)."""

    max_slots: int = 4
    max_queue: int = 64
    max_seq_len: int = 64
    buckets: Optional[Tuple[int, ...]] = None
    eos_id: Optional[int] = None
    use_opq: bool = True
    cache_backend: str = "auto"
    block_size: int = 16
    n_blocks: Optional[int] = None
    paged_native: bool = False
    paged_kernel: bool = False
    prefill_chunk: Optional[int] = None
    prefix_cache: bool = False
    speculative: bool = False
    spec_k: int = 4
    draft: Optional[ArchConfig] = None


def _check_config(cfg: ArchConfig, ecfg: EngineConfig) -> None:
    """The reference's construction checks, and the options still to port."""
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise ValueError(
            f"the port serves token-input dense archs, got family={cfg.family} "
            f"input_mode={cfg.input_mode} (other families: ROADMAP queue 1 item 11)")
    if ecfg.speculative or ecfg.draft is not None:
        raise ValueError("speculative decode is not ported (ROADMAP queue 1 item 9)")
    if ecfg.paged_kernel and not ecfg.paged_native:
        raise ValueError("paged_kernel requires paged_native=True")
    if ecfg.paged_native and ecfg.cache_backend != "paged":
        raise ValueError(f"paged_native requires cache_backend='paged', got "
                         f"{ecfg.cache_backend!r}")
    if ecfg.prefix_cache and ecfg.cache_backend != "paged":
        raise ValueError(f"prefix_cache (shared-prefix radix cache) requires "
                         f"cache_backend='paged', got {ecfg.cache_backend!r}")


def _buckets(ecfg: EngineConfig) -> Tuple[Tuple[int, ...], frozenset]:
    """The prefill buckets and the subset admitted by the chunked scan. With
    ``prefill_chunk`` W, buckets at most W wide keep the fused step and the
    rest become multiples of W up to ``max_seq_len``, which lifts the
    admissible prompt length past the widest fused bucket."""
    buckets = ecfg.buckets or default_buckets(ecfg.max_seq_len)
    chunk = ecfg.prefill_chunk
    chunked: Tuple[int, ...] = ()
    if chunk:
        if not 1 <= chunk <= ecfg.max_seq_len:
            raise ValueError(f"prefill_chunk {chunk} must be in [1, max_seq_len "
                             f"{ecfg.max_seq_len}]")
        fused = tuple(b for b in buckets if b <= chunk)
        chunked = tuple(k * chunk for k in range(1, ecfg.max_seq_len // chunk + 1)
                        if k * chunk > max(fused, default=0))
        buckets = tuple(sorted(set(fused) | set(chunked)))
    if max(buckets) > ecfg.max_seq_len:
        raise ValueError(
            f"largest prefill bucket {max(buckets)} exceeds "
            f"max_seq_len {ecfg.max_seq_len} (the slot-row length)")
    if ecfg.prefix_cache:
        bad = [b for b in buckets if b % ecfg.block_size]
        if bad:
            # the suffix scan runs block-size-wide chunks: a bucket must be a
            # whole number of them to resume mid-prompt
            raise ValueError(f"prefix_cache requires block_size {ecfg.block_size} "
                             f"to divide every prefill bucket (got {bad})")
    return tuple(buckets), frozenset(chunked)


class _Ready:
    """Completed-future shim for the OPQ-disabled direct-dispatch path."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class QueueFull(Exception):
    """Raised by submit(strict=True) when admission control rejects."""


class Engine:
    """Typical use::

        engine = Engine(cfg, params, EngineConfig(max_slots=4, max_seq_len=64,
                        cache_backend="paged", paged_native=True,
                        paged_kernel=True, prefix_cache=True))
        engine.submit(prompt_ids, max_new_tokens=16)
        done = engine.run_until_complete()

    ``device`` defaults to the CUDA card; ``device="cpu"`` runs the kernels'
    plain versions (tests)."""

    def __init__(self, cfg: ArchConfig, params, engine_cfg: EngineConfig = None,
                 *, device=None, opq: Optional[OPQ] = None):
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        _check_config(cfg, self.ecfg)
        self.device = resolve_device(device)
        buckets, self._chunked_buckets = _buckets(self.ecfg)
        self.scheduler = Scheduler(self.ecfg.max_slots, buckets)
        self.store: SlotStore = make_store(
            cfg, self.ecfg.max_slots, self.ecfg.max_seq_len,
            backend=self.ecfg.cache_backend, block_size=self.ecfg.block_size,
            n_blocks=self.ecfg.n_blocks, native=self.ecfg.paged_native,
            prefix_cache=self.ecfg.prefix_cache, device=self.device)
        self._prefill = ST.make_prefill_with_cache_step(cfg)
        chunk = self.ecfg.prefill_chunk
        self._prefill_chunked = ST.make_chunked_prefill_step(cfg, chunk) if chunk else None
        # the suffix of a prefix-cache hit runs in one piece, or in pieces
        # of prefill_chunk when that bounds the score memory
        self._prefill_suffix = (ST.make_suffix_prefill_step(cfg, self.ecfg.block_size, chunk)
                                if self.ecfg.prefix_cache else None)
        self._decode = (ST.make_paged_decode_step(cfg, use_kernel=self.ecfg.paged_kernel)
                        if self.ecfg.paged_native else ST.make_decode_step(cfg))
        self._owns_opq = opq is None and self.ecfg.use_opq
        self.opq = ((OPQ([self.device]) if self._owns_opq else opq)
                    if self.ecfg.use_opq else None)
        self._params_buf = Buffer(params, name="params")
        self._req_ids = itertools.count()
        self.metrics = EngineMetrics()
        self._deferred_ids: set = set()
        self.completed: List[Request] = []

    # ------------------------------------------------------------ OPQ bridge

    def _resident(self, tree, name: str) -> Buffer:
        return Buffer.resident(tree, self.device, name=name)

    def _dispatch(self, fn, *bufs: Buffer, flags: str = ""):
        return self._dispatch_async(fn, *bufs, flags=flags).result()

    def _dispatch_async(self, fn, *bufs: Buffer, flags: str = ""):
        """Issue one instruction through the OPQ scheduler, or run it eagerly
        when the runtime is disabled."""
        if self.opq is None:
            return _Ready(fn(*(b.to_device(self.device) for b in bufs)))
        return self.opq.invoke_operator(fn, *bufs, flags=flags)

    # ------------------------------------------------------------- admission

    def would_accept(self, prompt_len: int, max_new_tokens: int) -> bool:
        """The submit-time admission predicate, side-effect free."""
        return not (self.scheduler.queue_depth >= self.ecfg.max_queue
                    or prompt_len < 1
                    or max_new_tokens < 1
                    or prompt_len + max_new_tokens > self.ecfg.max_seq_len
                    or prompt_len > max(self.scheduler.buckets)
                    or not self.store.fits(prompt_len, max_new_tokens))

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               sampling=None, strict: bool = False) -> Optional[Request]:
        """Admission control at the door: a bounded queue and a per-slot
        sequence budget. Returns the Request, or None when rejected
        (QueueFull when ``strict``). Only greedy decoding is ported: a
        ``sampling`` argument that is not greedy raises."""
        if sampling is not None and not getattr(sampling, "greedy", False):
            raise ValueError("non-greedy sampling is not ported "
                             "(ROADMAP queue 1 item 9)")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if not self.would_accept(len(prompt), max_new_tokens):
            self.metrics.rejected += 1
            if strict:
                raise QueueFull(
                    f"rejected: queue_depth={self.scheduler.queue_depth}, "
                    f"prompt={len(prompt)} + gen={max_new_tokens} vs "
                    f"max_seq_len={self.ecfg.max_seq_len}")
            return None
        req = Request(id=next(self._req_ids), prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      metrics=RequestMetrics(arrival_s=now(), prompt_len=len(prompt)))
        self.scheduler.enqueue(req)
        self.metrics.submitted += 1
        return req

    # ----------------------------------------------------------- engine step

    def _try_lease(self, slot: int, req: Request) -> bool:
        """Reserve store capacity before the scheduler commits the slot;
        False (pool dry) leaves the request at the queue head — backpressure.
        Deferral is counted once per request. With the prefix cache the
        lease walks the trie with the prompt, and a hit is counted here."""
        ok = self.store.lease(slot, len(req.prompt), req.max_new_tokens,
                              tokens=req.prompt if self.ecfg.prefix_cache else None)
        if not ok:
            if req.id not in self._deferred_ids:
                self._deferred_ids.add(req.id)
                self.metrics.admissions_deferred += 1
            return ok
        self._deferred_ids.discard(req.id)
        if self.ecfg.prefix_cache:
            info = self.store.prefix_lease_info(slot)
            if info["hit"]:
                self.metrics.prefix_hits += 1
                self.metrics.prefix_blocks_reused += info["shared_blocks"]
                self.metrics.prefix_tokens_reused += info["prefill_start"]
        return ok

    def _prefix_group_key(self, slot: int, req: Request) -> int:
        """Admission group key under the prefix cache: the slot's suffix
        start CHUNK. A batched suffix prefill can skip only what every row
        skips, so rows with different cached depths dispatch apart."""
        return self.store.prefix_lease_info(slot)["prefill_start"] // self.ecfg.block_size

    def _admit(self) -> int:
        """Admission: one dispatched prefill per bucket group — the fused
        step, the chunked scan for buckets wider than ``prefill_chunk``, or
        the suffix scan from the group's start chunk for prefix-cache hits —
        and one batched write into the leased slots. All groups of a round
        are dispatched before the first wait. Returns the number admitted."""
        pending = []
        admitted = 0
        prefix = self.ecfg.prefix_cache
        bs = self.ecfg.block_size
        for bucket, pairs in self.scheduler.plan_admissions(
                self._try_lease, self._prefix_group_key if prefix else None):
            admitted += len(pairs)
            toks = np.zeros((len(pairs), bucket), np.int32)
            last = np.zeros((len(pairs),), np.int32)
            for i, (slot, req) in enumerate(pairs):
                toks[i, :len(req.prompt)] = req.prompt
                last[i] = len(req.prompt) - 1
                req.metrics.admitted_s = now()
            # the scheduler grouped rows by start chunk: no row recomputes a
            # cached position and none skips one it needs
            start_chunk = self._prefix_group_key(*pairs[0]) if prefix else 0
            bufs = (self._params_buf, Buffer(toks, name=f"prefill{bucket}"), Buffer(last))
            if start_chunk > 0:
                kv0 = self.store.gather_prefix_rows([slot for slot, _ in pairs], bucket)
                fut = self._dispatch_async(
                    lambda p, t, li, k0, fn=self._prefill_suffix, sc=start_chunk:
                    fn(p, t, li, k0, sc),
                    *bufs, self._resident(kv0, "prefix-kv0"),
                    flags=f"prefill_prefix/{bucket}")
                self.metrics.prefill_chunks += bucket // bs - start_chunk
            else:
                chunked = bucket in self._chunked_buckets
                fut = self._dispatch_async(
                    self._prefill_chunked if chunked else self._prefill, *bufs,
                    flags=f"prefill_chunked/{bucket}" if chunked else f"prefill/{bucket}")
                if prefix:
                    # cold groups compute every block-size chunk
                    self.metrics.prefill_chunks += bucket // bs
            pending.append((pairs, last, fut))
        for pairs, last, fut in pending:
            t0 = now()
            first, kv = fut.result()
            first = first.cpu().numpy()
            self.metrics.prefill_wait_s += now() - t0
            self.metrics.prefill_batches += 1
            self.metrics.prefill_tokens += int(last.sum()) + len(pairs)
            t0 = now()
            self.store.write_slots([slot for slot, _ in pairs], kv,
                                   [len(req.prompt) for _, req in pairs])
            self.metrics.seed_write_s += now() - t0
            for i, (slot, req) in enumerate(pairs):
                req.state = RequestState.RUNNING
                req.tokens.append(int(first[i]))
                req.metrics.first_token_s = now()
                req.metrics.n_generated = 1
                self.metrics.observe_tokens(1)
                if self._finished(req):
                    self._retire(slot)
        return admitted

    def _decode_once(self) -> None:
        toks, _ = self.scheduler.decode_batch()
        next_tok, cache = self._dispatch(
            self._decode, self._params_buf,
            self._resident(self.store.decode_cache(), "kv-cache"),
            Buffer(toks, name="decode-tokens"),
            flags="decode")
        self.store.swap(cache)
        self.metrics.decode_steps += 1
        next_np = next_tok.cpu().numpy()
        produced = 0
        for slot, req in list(self.scheduler.active.items()):
            req.tokens.append(int(next_np[slot]))
            req.metrics.n_generated += 1
            produced += 1
            if self._finished(req):
                self._retire(slot)
        self.metrics.observe_tokens(produced)

    def _finished(self, req: Request) -> bool:
        if req.metrics.n_generated >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        if self.ecfg.eos_id is not None and req.last_token == self.ecfg.eos_id:
            req.finish_reason = "eos"
            return True
        return False

    def _retire(self, slot: int) -> None:
        req = self.scheduler.retire(slot)
        self.store.reset(slot)
        req.state = RequestState.DONE
        req.metrics.finish_s = now()
        self.metrics.completed += 1
        self.completed.append(req)

    def step(self) -> None:
        """One engine iteration: join waiting requests into free slots, then
        one batched decode step for whatever is in flight."""
        admitted = self._admit()
        if admitted == 0 and not self.scheduler.active and self.scheduler.waiting:
            head = self.scheduler.waiting[0]
            raise RuntimeError(
                f"admission livelock: request {head.id} "
                f"(prompt={len(head.prompt)} tok, max_new_tokens="
                f"{head.max_new_tokens}) was deferred by the store's lease with "
                f"zero active slots; store: {self.store.memory_stats()}")
        n_active = self.scheduler.n_active
        if n_active:
            self._decode_once()
        self.metrics.observe_step(self.scheduler.queue_depth, n_active)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def run_until_complete(self, max_steps: int = 100_000) -> List[Request]:
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return self.completed

    # --------------------------------------------------------------- summary

    def stats(self) -> Dict:
        out = dict(self.metrics.summary())
        out["cache"] = self.store.memory_stats()
        if self.opq is not None:
            out["opq"] = dict(self.opq.stats)
            out["opq"]["flags"] = dict(self.opq.flag_counts)
        return out

    def close(self) -> None:
        if self._owns_opq and self.opq is not None:
            self.opq.shutdown()
