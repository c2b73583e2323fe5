"""Continuous-batching inference engine over the OPQ runtime — the port of
``repro.serving.engine`` for the slice it serves: greedy decode of a dense
model, admitted by fused prefill-with-cache, decoded block-natively on the
paged KV pool through the paged-attention kernel.

Requests enter a bounded FIFO (admission control); a slot scheduler joins
them into a fixed-width in-flight decode batch and retires them as they
finish, with no full-batch barrier. Admission is one bucketed prefill forward
per bucket batch (first token + per-layer K/V in cache layout) and one
batched write into the leased blocks. Every device step is an OPQ
instruction, so buffer affinity and backup re-issue apply to serving
traffic; the per-flag instruction counts are the dispatch audit trail.

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
from repro_torch.serving.store import PagedKVStore


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
    """Per-engine serving knobs, the JAX package's fields. This port serves
    ``cache_backend="paged"`` with ``paged_native=True`` and
    ``paged_kernel=True``; the other options raise a ValueError naming the
    ROADMAP item that ports them. See ``repro.serving.engine.EngineConfig``
    for each field's meaning."""

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


def _check_ported(cfg: ArchConfig, ecfg: EngineConfig) -> None:
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise ValueError(
            f"the port serves token-input dense archs, got family={cfg.family} "
            f"input_mode={cfg.input_mode} (other families: ROADMAP queue 1 item 11)")
    if ecfg.cache_backend != "paged":
        raise ValueError(
            f"cache_backend={ecfg.cache_backend!r} is not ported: the port serves "
            f"cache_backend='paged' (contiguous and recurrent stores: ROADMAP "
            f"queue 1 item 7)")
    if not ecfg.paged_native:
        raise ValueError(
            "paged_native=False (the gather-bridge decode) is not ported: set "
            "paged_native=True (ROADMAP queue 1 item 7)")
    if not ecfg.paged_kernel:
        raise ValueError(
            "paged_kernel=False is not ported: block-native decode runs through "
            "the paged-attention kernel, set paged_kernel=True (ROADMAP queue 1 item 7)")
    if cfg.kv_cache_dtype != "bfloat16":
        raise ValueError("int8 KV cache is not ported (ROADMAP queue 1 item 9)")
    if ecfg.prefill_chunk:
        raise ValueError("prefill_chunk (chunked prefill) is not ported "
                         "(ROADMAP queue 1 item 9)")
    if ecfg.prefix_cache:
        raise ValueError("prefix_cache is not ported (ROADMAP queue 1 item 9)")
    if ecfg.speculative or ecfg.draft is not None:
        raise ValueError("speculative decode is not ported (ROADMAP queue 1 item 9)")


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
                        paged_kernel=True))
        engine.submit(prompt_ids, max_new_tokens=16)
        done = engine.run_until_complete()

    ``device`` defaults to the CUDA card; ``device="cpu"`` runs the kernels'
    plain versions (tests)."""

    def __init__(self, cfg: ArchConfig, params, engine_cfg: EngineConfig = None,
                 *, device=None, opq: Optional[OPQ] = None):
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        _check_ported(cfg, self.ecfg)
        self.device = resolve_device(device)
        buckets = self.ecfg.buckets or default_buckets(self.ecfg.max_seq_len)
        if max(buckets) > self.ecfg.max_seq_len:
            raise ValueError(
                f"largest prefill bucket {max(buckets)} exceeds "
                f"max_seq_len {self.ecfg.max_seq_len} (the slot-row length)")
        self.scheduler = Scheduler(self.ecfg.max_slots, buckets)
        self.store = PagedKVStore(cfg, self.ecfg.max_slots, self.ecfg.max_seq_len,
                                  block_size=self.ecfg.block_size,
                                  n_blocks=self.ecfg.n_blocks, device=self.device)
        self._prefill = ST.make_prefill_with_cache_step(cfg)
        self._decode = ST.make_paged_decode_step(cfg)
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
        """Reserve blocks before the scheduler commits the slot; False (pool
        dry) leaves the request at the queue head — backpressure. Deferral
        is counted once per request."""
        ok = self.store.lease(slot, len(req.prompt), req.max_new_tokens)
        if not ok:
            if req.id not in self._deferred_ids:
                self._deferred_ids.add(req.id)
                self.metrics.admissions_deferred += 1
            return ok
        self._deferred_ids.discard(req.id)
        return ok

    def _admit(self) -> int:
        """Fused admission: one dispatched prefill per bucket batch and one
        batched write into the leased blocks. All buckets of a round are
        dispatched before the first wait. Returns the number admitted."""
        pending = []
        admitted = 0
        for bucket, pairs in self.scheduler.plan_admissions(self._try_lease):
            admitted += len(pairs)
            toks = np.zeros((len(pairs), bucket), np.int32)
            last = np.zeros((len(pairs),), np.int32)
            for i, (slot, req) in enumerate(pairs):
                toks[i, :len(req.prompt)] = req.prompt
                last[i] = len(req.prompt) - 1
                req.metrics.admitted_s = now()
            fut = self._dispatch_async(
                self._prefill, self._params_buf, Buffer(toks, name=f"prefill{bucket}"),
                Buffer(last), flags=f"prefill/{bucket}")
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
