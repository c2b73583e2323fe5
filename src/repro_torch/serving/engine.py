"""Continuous-batching inference engine over the OPQ runtime — the port of
``repro.serving.engine``'s single-host engine for a dense or MoE model,
float or int8 KV, or a recurrent model (the hybrid zamba2, the ssm xlstm)
on the recurrent state store,
through every SlotStore route of the reference (contiguous rows;
the paged pool through the gather bridge, block-natively in plain torch, or
block-natively through the paged-attention kernel), with chunked prefill
for long prompts, the shared-prefix radix cache, per-request sampling,
stop sequences and logprobs, greedy speculative decode with a dense, MoE
or recurrent draft, and the non-generative ``embed`` forward. Token-input
archs only, as in the reference: the vlm and encdec families are refused.

Requests enter a bounded FIFO (admission control); a slot scheduler joins
them into a fixed-width in-flight decode batch and retires them as they
finish, with no full-batch barrier. Admission is one bucketed prefill
dispatch per bucket batch (first token + per-layer K/V in cache layout) and
one batched write into the leased slots: the fused single-shot step, the
chunked scan for buckets wider than ``prefill_chunk``, or, for prefix-cache
hits, the suffix scan over the chunks the cached prefix does not cover; for
a recurrent model, the masked replay of its decode body over the bucket.
Every device step is an OPQ instruction, so buffer affinity and backup
re-issue apply to serving traffic; the per-flag instruction counts are the
dispatch audit trail. On the card the block-native decode step replays as
one CUDA graph where its family allows (models/decode_graph.py).

Decode is batch-invariant: every slot computes the math of a
single-request decode at its own position (per-row activation scales,
per-slot index), so staggered arrivals give the tokens each request would
get alone. Sampled requests stay so: their noise is a function of (seed,
position) only (serving/sampling.py). Speculative decode proposes
``spec_k`` tokens per slot with a draft model and verifies the window in
one target forward whose position j has the bits of the plain decode
step after j accepted tokens, so greedy acceptance emits plain decode's
stream, bit for bit. Every prefill query attends as a one-query decode
contraction, so a prefill row keeps the bits of the decode step at its
position.

The fleet (serving/router.py) drives an engine through its drain hooks:
``lease_headroom``, ``evict_queued`` and ``preempt`` (a continuation
elsewhere re-admits ``prompt + tokens so far`` by fused prefill and
continues the stream exactly), and for prefill/decode disaggregation
``extract_seeded``, ``release_exported`` and ``submit_seeded``, which
ship a stream's exact cache blocks instead (paged store, not speculative).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device, tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.opq import OPQ, Buffer
from repro_torch.models import steps as ST
from repro_torch.models.attention import DecodeRows
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics, now
from repro_torch.serving.sampling import (
    GREEDY, TOP_LOGPROBS, SamplingParams, sampling_to_wire, stack_params, stop_match,
)
from repro_torch.serving.scheduler import Scheduler, bucket_for, default_buckets
from repro_torch.serving.store import RECURRENT_FAMILIES, SlotStore, make_store


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    PREEMPTED = "preempted"    # pulled mid-flight by a drain or a ship: the
                               # tokens so far stand, a continuation
                               # elsewhere carries the rest


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                     # (L,) int32
    max_new_tokens: int
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    # emission time (metrics.now) of each entry of ``tokens``: the
    # inter-token gaps of a free-running worker, whose polls arrive in bursts
    token_ts: List[float] = dataclasses.field(default_factory=list)
    metrics: RequestMetrics = None
    sampling: Optional[SamplingParams] = None   # None == greedy
    # tokens generated in earlier segments of this logical stream: stop
    # sequences match against stop_history + tokens
    stop_history: Tuple[int, ...] = ()
    finish_reason: Optional[str] = None    # "length" | "eos" | "stop"
    # logprob capture: None == off; N records the chosen token's logprob and
    # its top-N alternatives per emitted token (N <= sampling.TOP_LOGPROBS)
    want_logprobs: Optional[int] = None
    logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[List[Tuple[int, float]]] = dataclasses.field(default_factory=list)

    @property
    def last_token(self) -> int:
        return self.tokens[-1]

    @property
    def done(self) -> bool:
        return self.state == RequestState.DONE

    def to_wire(self) -> Dict:
        """The request as plain JSON-able data (serving/transport.py): enough
        to re-admit the stream as a continuation elsewhere. Metrics stay
        host-local."""
        return {
            "id": self.id,
            "prompt": [int(t) for t in self.prompt],
            "max_new_tokens": self.max_new_tokens,
            "state": self.state.value,
            "tokens": [int(t) for t in self.tokens],
            "sampling": sampling_to_wire(self.sampling),
            "stop_history": [int(t) for t in self.stop_history],
            "finish_reason": self.finish_reason,
            "want_logprobs": self.want_logprobs,
            "logprobs": [float(v) for v in self.logprobs],
            "top_logprobs": [[[int(t), float(v)] for t, v in row]
                             for row in self.top_logprobs],
        }


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Per-engine serving knobs, the JAX package's fields; see
    ``repro.serving.engine.EngineConfig`` for each field's meaning. The port
    serves every field for a dense or MoE target, and a recurrent (hybrid
    or ssm) target on ``cache_backend="recurrent"`` (what "auto" picks for
    it), with the reference's refusals."""

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


SERVED_FAMILIES = ("dense", "moe") + RECURRENT_FAMILIES


def _check_config(cfg: ArchConfig, ecfg: EngineConfig, draft_params) -> None:
    """The reference's construction checks, with its messages."""
    recurrent = cfg.family in RECURRENT_FAMILIES
    if cfg.family not in SERVED_FAMILIES or cfg.input_mode != "tokens":
        raise ValueError(f"serving engine supports token-input dense/moe/ssm/hybrid "
                         f"archs, got family={cfg.family} input_mode={cfg.input_mode}")
    if ecfg.speculative:
        if ecfg.draft is None or draft_params is None:
            raise ValueError("speculative decode needs a draft model: set "
                             "EngineConfig.draft and pass Engine(..., draft_params=...)")
        if ecfg.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {ecfg.spec_k}")
        if recurrent:
            raise ValueError(
                f"speculative decode verifies through the K/V-window path, so the "
                f"TARGET must be a dense-family arch, got {cfg.family} (a recurrent "
                f"model can be the draft, not the target)")
        if ecfg.paged_kernel:
            raise ValueError(
                "speculative decode does not route through the paged-attention "
                "kernel (a one-query decode shape; the verify window is "
                "multi-query): drop paged_kernel")
        d = ecfg.draft
        if d.vocab != cfg.vocab:
            raise ValueError(f"draft vocab {d.vocab} != target vocab {cfg.vocab}: "
                             f"draft proposals must be target token ids")
        if d.input_mode != "tokens" or d.family not in SERVED_FAMILIES:
            raise ValueError(f"draft must be a token-input dense/moe/ssm/hybrid arch, "
                             f"got family={d.family} input_mode={d.input_mode}")
    elif ecfg.draft is not None:
        raise ValueError("EngineConfig.draft is set but speculative=False: enable "
                         "speculative or drop the draft config")
    if ecfg.paged_kernel and not ecfg.paged_native:
        raise ValueError("paged_kernel requires paged_native=True")
    if ecfg.paged_native and ecfg.cache_backend != "paged":
        raise ValueError(f"paged_native requires cache_backend='paged', got "
                         f"{ecfg.cache_backend!r}")
    if ecfg.prefix_cache and ecfg.cache_backend != "paged":
        raise ValueError(f"prefix_cache (shared-prefix radix cache) requires "
                         f"cache_backend='paged', got {ecfg.cache_backend!r}")
    if ecfg.prefill_chunk and recurrent:
        raise ValueError(f"prefill_chunk applies to the dense-family score-matrix "
                         f"prefill, not the recurrent scan ({cfg.family})")


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
                 *, device=None, opq: Optional[OPQ] = None, draft_params=None):
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        _check_config(cfg, self.ecfg, draft_params)
        self.device = resolve_device(device)
        buckets, self._chunked_buckets = _buckets(self.ecfg)
        self.scheduler = Scheduler(self.ecfg.max_slots, buckets)
        self.store: SlotStore = make_store(
            cfg, self.ecfg.max_slots, self.ecfg.max_seq_len,
            backend=self.ecfg.cache_backend, block_size=self.ecfg.block_size,
            n_blocks=self.ecfg.n_blocks, native=self.ecfg.paged_native,
            prefix_cache=self.ecfg.prefix_cache, device=self.device)
        # every prefill query attends as a one-query decode contraction of
        # this engine's decode (through the paged-attention kernel on the
        # kernel route, float KV), so a prefill row keeps the bits of the
        # decode step at its position: re-prefilled continuations continue
        rows = self.decode_rows = DecodeRows(
            self.ecfg.max_seq_len,
            self.ecfg.block_size if self.ecfg.paged_kernel and cfg.kv_cache_dtype != "int8"
            else None)
        self._prefill = (ST.make_recurrent_prefill_step(cfg, self.ecfg.max_seq_len)
                         if self.store.kind == "recurrent"
                         else ST.make_prefill_with_cache_step(cfg, rows))
        chunk = self.ecfg.prefill_chunk
        self._prefill_chunked = (ST.make_chunked_prefill_step(cfg, chunk, rows)
                                 if chunk else None)
        # the suffix of a prefix-cache hit runs in one piece, or in pieces
        # of prefill_chunk when that bounds the score memory
        self._prefill_suffix = (ST.make_suffix_prefill_step(cfg, self.ecfg.block_size, chunk,
                                                            rows)
                                if self.ecfg.prefix_cache else None)
        self._decode = (ST.make_paged_decode_step(cfg, use_kernel=self.ecfg.paged_kernel)
                        if self.ecfg.paged_native else ST.make_decode_step(cfg))
        # the block-native step's graph counters (models/decode_graph.py)
        self._decode_graph = self._decode if self.ecfg.paged_native else None
        self._embed = ST.make_embed_step(cfg, rows)
        self._owns_opq = opq is None and self.ecfg.use_opq
        self.opq = ((OPQ([self.device]) if self._owns_opq else opq)
                    if self.ecfg.use_opq else None)
        self._params_buf = Buffer(params, name="params")
        # speculative decode: the target's W = spec_k + 1 verify step, and the
        # draft as a second program with its own slot-synced contiguous
        # store, admitted, rolled back and reset in lockstep with the target
        self.draft_store: Optional[SlotStore] = None
        if self.ecfg.speculative:
            W = self.ecfg.spec_k + 1
            self._verify = (ST.make_paged_verify_step(cfg, W) if self.ecfg.paged_native
                            else ST.make_verify_step(cfg, W))
            dcfg = self.ecfg.draft
            self.draft_store = make_store(dcfg, self.ecfg.max_slots, self.ecfg.max_seq_len,
                                          device=self.device)
            # the draft's store is contiguous (its prefill rows keep the bits
            # of its own decode steps, as the target's do), or recurrent for a
            # hybrid draft, rolled back by per-slot snapshots
            self._draft_recurrent = self.draft_store.kind == "recurrent"
            self._draft_prefill = (
                ST.make_recurrent_prefill_step(dcfg, self.ecfg.max_seq_len)
                if self._draft_recurrent
                else ST.make_prefill_with_cache_step(dcfg, DecodeRows(self.ecfg.max_seq_len)))
            self._draft_decode = ST.make_decode_step(dcfg)
            self._draft_params_buf = Buffer(draft_params, name="draft-params")
        self._req_ids = itertools.count()
        # host mirror of each slot's token presence (prompt + generated), the
        # repetition penalty's input; it rides the slot lease like the cache
        self._presence = np.zeros((self.ecfg.max_slots, cfg.vocab_padded), bool)
        self.metrics = EngineMetrics()
        # fleet counter reconciliation: the queued ids counted as deferred,
        # and each slot's prefix-hit contribution (hits, blocks, positions);
        # evict_queued, preempt and extract_seeded take back what admission
        # counted, so a request re-admitted on another host counts once in
        # the fleet's sums
        self._deferred_ids: set = set()
        self._prefix_contrib: Dict[int, Tuple[int, int, int]] = {}
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

    def lease_headroom(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether the store could lease this request right now. False means
        admission would defer on backpressure: the router's cue to spill."""
        return self.store.available_now(prompt_len, max_new_tokens)

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               sampling: Optional[SamplingParams] = None,
               stop_history: Sequence[int] = (),
               want_logprobs: Optional[int] = None,
               strict: bool = False) -> Optional[Request]:
        """Admission control at the door: a bounded queue and a per-slot
        sequence budget. Returns the Request, or None when rejected
        (QueueFull when ``strict``).

        ``sampling`` (None == greedy) rides the request through its slot
        residency; ``stop_history`` is the generated prefix of an earlier
        segment of the stream, which stop sequences see. ``want_logprobs``
        (None == off) records each emitted token's logprob and its top-N
        alternatives. Non-greedy sampling on a speculative engine raises:
        greedy acceptance is what makes draft-verify exact."""
        if sampling is not None and not sampling.greedy and self.ecfg.speculative:
            raise ValueError(
                f"speculative decode is greedy-only: temperature="
                f"{sampling.temperature} needs sampled acceptance (rejection "
                f"sampling, not in the JAX package either); drop speculative or "
                f"the sampling params")
        if want_logprobs is not None and not 0 <= want_logprobs <= TOP_LOGPROBS:
            raise ValueError(f"want_logprobs must be in [0, {TOP_LOGPROBS}] (the "
                             f"device-side top-K width), got {want_logprobs}")
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
                      max_new_tokens=max_new_tokens, sampling=sampling,
                      stop_history=tuple(stop_history), want_logprobs=want_logprobs,
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
                self._prefix_contrib[slot] = (1, info["shared_blocks"],
                                              info["prefill_start"])
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
        and one batched write into the leased slots; with speculative decode
        also the draft's prefill of the whole prompt, and its write into the
        draft store. All groups of a round are dispatched before the first
        wait. Returns the number admitted."""
        pending = []
        admitted = 0
        prefix = self.ecfg.prefix_cache
        bs = self.ecfg.block_size
        with tracing.span("admit.plan"):
            for bucket, pairs in self.scheduler.plan_admissions(
                    self._try_lease, self._prefix_group_key if prefix else None):
                admitted += len(pairs)
                toks = np.zeros((len(pairs), bucket), np.int32)
                last = np.zeros((len(pairs),), np.int32)
                presence = np.zeros((len(pairs), self.cfg.vocab_padded), bool)
                for i, (slot, req) in enumerate(pairs):
                    toks[i, :len(req.prompt)] = req.prompt
                    last[i] = len(req.prompt) - 1
                    presence[i, req.prompt] = True
                    self._presence[slot, :] = presence[i]
                    req.metrics.admitted_s = now()
                smp = Buffer(stack_params([req.sampling for _, req in pairs], presence),
                             name="sampling")
                # the scheduler grouped rows by start chunk: no row recomputes a
                # cached position and none skips one it needs
                start_chunk = self._prefix_group_key(*pairs[0]) if prefix else 0
                bufs = (self._params_buf, Buffer(toks, name=f"prefill{bucket}"), Buffer(last))
                if start_chunk > 0:
                    kv0 = self.store.gather_prefix_rows([slot for slot, _ in pairs], bucket)
                    fut = self._dispatch_async(
                        lambda p, t, li, k0, s, fn=self._prefill_suffix, sc=start_chunk:
                        fn(p, t, li, k0, sc, s),
                        *bufs, self._resident(kv0, "prefix-kv0"), smp,
                        flags=f"prefill_prefix/{bucket}")
                    self.metrics.prefill_chunks += bucket // bs - start_chunk
                else:
                    chunked = bucket in self._chunked_buckets
                    fut = self._dispatch_async(
                        self._prefill_chunked if chunked else self._prefill, *bufs, smp,
                        flags=f"prefill_chunked/{bucket}" if chunked else f"prefill/{bucket}")
                    if prefix:
                        # cold groups compute every block-size chunk
                        self.metrics.prefill_chunks += bucket // bs
                dfut = None
                if self.draft_store is not None:
                    # the draft cache holds the whole prompt through the draft's
                    # own weights (the draft store has no prefix cache)
                    dfut = self._dispatch_async(
                        self._draft_prefill, self._draft_params_buf,
                        Buffer(toks, name=f"draft-prefill{bucket}"), Buffer(last),
                        flags=f"draft_prefill/{bucket}")
                pending.append((pairs, last, fut, dfut))
        for pairs, last, fut, dfut in pending:
            # one pair of readings times both the span and the counter
            t0 = tracing.now_ns()
            first, kv, lp = fut.result()
            first = first.cpu().numpy()
            t1 = tracing.now_ns()
            tracing.record("admit.wait", t0, t1)
            self.metrics.prefill_wait_s += (t1 - t0) / 1e9
            self.metrics.prefill_batches += 1
            self.metrics.prefill_tokens += int(last.sum()) + len(pairs)
            t0 = tracing.now_ns()
            slots = [slot for slot, _ in pairs]
            lens = [len(req.prompt) for _, req in pairs]
            self.store.write_slots(slots, kv, lens)
            if dfut is not None:
                # the draft's first token is discarded: the target's is emitted
                self.draft_store.write_slots(slots, dfut.result()[1], lens)
            t1 = tracing.now_ns()
            tracing.record("admit.write", t0, t1)
            self.metrics.seed_write_s += (t1 - t0) / 1e9
            with tracing.span("admit.emit"):
                lp = self._host_logprobs(lp, [req for _, req in pairs])
                for i, (slot, req) in enumerate(pairs):
                    req.state = RequestState.RUNNING
                    self._emit(slot, req, [int(first[i])], lp, [i])
                    m = req.metrics
                    m.first_token_s = now()
                    tracing.record("request.queue", tracing.ns(m.arrival_s),
                                   tracing.ns(m.admitted_s), tracing.ROOT, req=req.id)
                    tracing.record("request.prefill", tracing.ns(m.admitted_s),
                                   tracing.ns(m.first_token_s), tracing.ROOT, req=req.id)
                    self.metrics.observe_tokens(1)
                    if self._finished(req):
                        self._retire(slot)
        return admitted

    def _host_logprobs(self, lp: Dict, reqs) -> Optional[Dict]:
        """A step's logprob payload on the host, read only when a request of
        the step asked for logprobs."""
        if all(req.want_logprobs is None for req in reqs):
            return None
        return {k: v.cpu().numpy() for k, v in lp.items()}

    def _emit(self, slot: int, req: Request, toks: List[int], lp: Optional[Dict],
              idx: List) -> None:
        """Append emitted tokens to a request, with their logprob records
        (``lp[...][idx[j]]``: a row for prefill and decode, a (slot,
        position) pair for verify) and the slot's presence."""
        req.tokens.extend(toks)
        req.token_ts.extend([now()] * len(toks))
        req.metrics.n_generated += len(toks)
        self._presence[slot, toks] = True
        if req.sampling is not None and not req.sampling.greedy:
            self.metrics.sampled_tokens += len(toks)
        if req.want_logprobs is not None:
            for j in idx:
                req.logprobs.append(float(lp["lp"][j]))
                req.top_logprobs.append([(int(t), float(v)) for t, v in
                                         zip(lp["top_ids"][j], lp["top_lps"][j])])

    def _sampling_batch(self) -> Buffer:
        """The decode batch's stacked per-slot sampling params and presence
        rows; idle slots and requests without params stack as GREEDY."""
        return Buffer(stack_params(self.scheduler.sampling_by_slot(GREEDY),
                                   self._presence.copy()), name="sampling")

    def _decode_once(self) -> None:
        with tracing.span("decode.inputs"):
            toks, active = self.scheduler.decode_batch()
            bufs = (self._params_buf,
                    self._resident(self.store.decode_cache(), "kv-cache"),
                    Buffer(toks, name="decode-tokens"), self._sampling_batch(),
                    Buffer(active, name="decode-active"))
        with tracing.span("decode.wait"):
            next_tok, cache, lp = self._dispatch(self._decode, *bufs, flags="decode")
        with tracing.span("decode.emit"):
            self.store.swap(cache)
            self.metrics.decode_steps += 1
            if self._decode_graph is not None:
                self.metrics.decode_graph_captures = self._decode_graph.captures
                self.metrics.decode_graph_replays = self._decode_graph.replays
            next_np = next_tok.cpu().numpy()
            active = list(self.scheduler.active.items())
            lp = self._host_logprobs(lp, [req for _, req in active])
            for slot, req in active:
                self._emit(slot, req, [int(next_np[slot])], lp, [slot])
                if self._finished(req):
                    self._retire(slot)
            self.metrics.observe_tokens(len(active))

    def _spec_decode_once(self) -> None:
        """One speculative draft-verify round: k+1 draft decode steps propose
        k tokens per active slot (the last proposal is dropped; the extra
        step keeps the draft cache in lockstep through a fully accepted
        window), then ONE target verify of the W = k+1 window for the whole
        batch, and each slot advances by its own acceptance: 1..k+1 tokens,
        eos, length and stop sequences landing mid-window. Rejected window
        positions are scrubbed from BOTH caches before any retire: later
        verify horizons reach them, and the retire-time rows must equal plain
        decode's. A recurrent draft has no positions to scrub: each slot
        adopts the draft state snapshot taken after its last accepted
        token."""
        k = self.ecfg.spec_k
        W = k + 1
        n = self.ecfg.max_slots
        toks, active = self.scheduler.decode_batch()
        active_buf = Buffer(active, name="draft-active")
        # window column 0: each slot's last emitted token; 1..k: proposals
        window = np.zeros((n, W), np.int32)
        window[:, 0] = toks[:, 0]
        # a recurrent draft's rollback selects among snapshots: the state
        # before the round, then after each draft step (the last is the live
        # cache, which nothing writes before the rollback)
        snapshots = [self.draft_store.snapshot()] if self._draft_recurrent else None
        cur = toks
        for i in range(W):
            nxt, dcache = self._dispatch(
                self._draft_decode, self._draft_params_buf,
                self._resident(self.draft_store.decode_cache(), "draft-cache"),
                Buffer(cur, name="draft-tokens"), Buffer(None), active_buf,
                flags="draft_decode")
            self.draft_store.swap(dcache)
            if snapshots is not None:
                snapshots.append(self.draft_store.snapshot() if i < W - 1
                                 else self.draft_store.cache)
            self.metrics.draft_steps += 1
            nxt_np = nxt.cpu().numpy().astype(np.int32)
            if i < k:
                window[:, i + 1] = nxt_np
            cur = nxt_np.reshape(n, 1)
        greedy, cache, lp = self._dispatch(
            self._verify, self._params_buf,
            self._resident(self.store.decode_cache(), "kv-cache"),
            Buffer(window, name="verify-window"), flags="verify")
        self.store.swap_window(cache, W)
        self.metrics.decode_steps += 1
        self.metrics.spec_rounds += 1
        greedy_np = greedy.cpu().numpy()                   # (B, W)
        active = list(self.scheduler.active.items())
        lp = self._host_logprobs(lp, [req for _, req in active])
        # per-slot acceptance on the host, and a fixed-shape rollback plan
        slot_ids = np.full((n,), n, np.int64)              # pad: dropped
        new_index = np.zeros((n,), np.int64)
        scrub = np.full((n, k), self.ecfg.max_seq_len, np.int64)
        sel = np.zeros((n,), np.int64)                     # recurrent draft
        produced = 0
        to_retire = []
        for slot, req in active:
            # pre-round write position: the last emitted token's, unwritten
            p = len(req.prompt) + req.metrics.n_generated - 1
            g = greedy_np[slot]
            a = 0             # leading draft proposals the target confirms
            while a < k and window[slot, a + 1] == g[a]:
                a += 1
            emit = min(a + 1, req.max_new_tokens - req.metrics.n_generated)
            if self.ecfg.eos_id is not None:
                hits = np.flatnonzero(g[:emit] == self.ecfg.eos_id)
                if hits.size:     # eos mid-window: nothing past it
                    emit = int(hits[0]) + 1
            stop = req.sampling.stop if req.sampling is not None else ()
            if stop:
                # a stop sequence can complete mid-window too
                hist = tuple(req.stop_history) + tuple(req.tokens)
                for j in range(emit):
                    if stop_match(hist + tuple(int(t) for t in g[:j + 1]), stop):
                        emit = j + 1
                        break
            self._emit(slot, req, [int(t) for t in g[:emit]], lp,
                       [(slot, j) for j in range(emit)])
            produced += emit
            self.metrics.proposed_tokens += k
            self.metrics.accepted_tokens += emit - 1
            self.metrics.accept_hist[emit] = self.metrics.accept_hist.get(emit, 0) + 1
            slot_ids[slot] = slot
            new_index[slot] = p + emit
            sel[slot] = emit
            scrub[slot, :W - emit] = p + emit + np.arange(W - emit)
            if self._finished(req):
                to_retire.append(slot)
        self.store.rollback(slot_ids, new_index, scrub)
        if self._draft_recurrent:
            # recurrent state has no positions to scrub: each slot adopts the
            # snapshot taken right after its last accepted token
            self.draft_store.adopt_selected(snapshots, sel)
        else:
            # the draft wrote K/V at exactly the target's window positions
            # (feed i writes position p + i), so one rollback plan serves both
            self.draft_store.rollback(slot_ids, new_index, scrub)
        for slot in to_retire:
            self._retire(slot)
        self.metrics.observe_tokens(produced)

    def _finished(self, req: Request) -> bool:
        """Finish check after every emission, setting ``finish_reason``
        (priority: length, eos, stop). Stop sequences suffix-match
        ``stop_history + tokens``, the generated stream only."""
        if req.metrics.n_generated >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        if self.ecfg.eos_id is not None and req.last_token == self.ecfg.eos_id:
            req.finish_reason = "eos"
            return True
        stop = req.sampling.stop if req.sampling is not None else ()
        if stop and stop_match(tuple(req.stop_history) + tuple(req.tokens), stop):
            req.finish_reason = "stop"
            self.metrics.stop_hits += 1
            return True
        return False

    def _unwind_prefix(self, slot: int) -> None:
        """Take back a departing slot's prefix-hit counters: a preempted or
        exported request is re-admitted elsewhere, where its prefix walk
        counts afresh. Requests that complete here keep their counts."""
        contrib = self._prefix_contrib.pop(slot, None)
        if contrib is not None:
            hits, blocks, toks = contrib
            self.metrics.prefix_hits -= hits
            self.metrics.prefix_blocks_reused -= blocks
            self.metrics.prefix_tokens_reused -= toks

    def _retire(self, slot: int) -> None:
        req = self.scheduler.retire(slot)
        self._prefix_contrib.pop(slot, None)
        self.store.reset(slot)
        self._presence[slot, :] = False
        if self.draft_store is not None:
            self.draft_store.reset(slot)
        req.state = RequestState.DONE
        m = req.metrics
        m.finish_s = now()
        tracing.record("request.decode", tracing.ns(m.first_token_s), tracing.ns(m.finish_s),
                       tracing.ROOT, req=req.id)
        self.metrics.completed += 1
        self.completed.append(req)

    # ------------------------------------------------------------ drain hooks
    # The router (serving/router.py) drains an engine by placing nothing more
    # on it, pulling its queue (evict_queued) and preempting long in-flight
    # generations for re-admission elsewhere; disaggregation ships a stream's
    # cache blocks instead (extract_seeded / submit_seeded). All of them act
    # at step boundaries only.

    def evict_queued(self) -> List[Request]:
        """Pull every not-yet-admitted request out of the FIFO, in order;
        in-flight slots stay. The requests hold no cache state, so the
        caller can re-submit them anywhere verbatim. A deferral mark leaves
        with its request."""
        out = list(self.scheduler.waiting)
        self.scheduler.waiting.clear()
        for req in out:
            req.state = RequestState.PREEMPTED
            if req.id in self._deferred_ids:
                self._deferred_ids.discard(req.id)
                self.metrics.admissions_deferred -= 1
        self.metrics.evicted += len(out)
        return out

    def _release_slot(self, slot: int) -> None:
        """A departing in-flight request's slot back to the scheduler, its
        presence row cleared and its prefix-hit counts taken back."""
        self.scheduler.retire(slot)
        self._presence[slot, :] = False
        self._unwind_prefix(slot)

    def _in_flight(self, req_id: int) -> Tuple[int, Request]:
        for slot, req in self.scheduler.active.items():
            if req.id == req_id:
                return slot, req
        raise KeyError(f"request {req_id} is not in flight on this engine")

    def preempt(self, req_id: int) -> Request:
        """Remove an in-flight request at a step boundary: retire its slot,
        scrub its cache rows (the draft store's too) and return it with the
        tokens generated so far (>= 1). A continuation elsewhere with
        ``prompt + tokens`` as its prompt regenerates the rest of the stream
        where fused prefill keeps decode's bits."""
        slot, req = self._in_flight(req_id)
        self._release_slot(slot)
        self.store.reset(slot)
        if self.draft_store is not None:
            self.draft_store.reset(slot)
        req.state = RequestState.PREEMPTED
        self.metrics.preempted += 1
        return req

    def _check_shippable(self, what: str) -> None:
        if self.ecfg.speculative:
            raise ValueError(f"{what} does not support speculative engines (the "
                             f"draft store's state does not ship with the target's "
                             f"blocks)")
        if not hasattr(self.store, "export_blocks"):
            raise ValueError(f"{what} requires the paged cache backend (cross-host "
                             f"block shipping), got {self.store.kind!r}: use preempt "
                             f"and a re-prefill continuation instead")

    def extract_seeded(self, req_id: int) -> Tuple[Request, Dict]:
        """Preempt an in-flight request AND export its slot's cache blocks
        (``store.export_blocks``) under the cursor-named payload id
        ``r<id>c<n_tokens>``. The blocks stay on the store's export ledger,
        referenced, until ``release_exported``."""
        self._check_shippable("extract_seeded")
        slot, req = self._in_flight(req_id)
        payload = self.store.export_blocks(slot, payload_id=f"r{req.id}c{len(req.tokens)}")
        self._release_slot(slot)
        req.state = RequestState.PREEMPTED
        self.metrics.exported_slots += 1
        self.metrics.exported_blocks += payload["n_blocks"]
        return req, payload

    def release_exported(self, payload_id: str) -> bool:
        """Ack a shipped payload: the export ledger's blocks are released
        (reset's decision per block). Idempotent; False for an unknown id."""
        return self.store.release_exported(payload_id)

    def submit_seeded(self, prompt: Sequence[int], max_new_tokens: int,
                      tokens: Sequence[int], payload: Dict, *,
                      sampling: Optional[SamplingParams] = None,
                      stop_history: Sequence[int] = (),
                      want_logprobs: Optional[int] = None,
                      logprobs: Sequence[float] = (),
                      top_logprobs: Sequence = ()) -> Optional[Request]:
        """Admit a mid-flight stream from a shipped block payload: lease a
        slot, import the payload (validated in full before any device write;
        a bad one raises ValueError and leaves the slot clean) and join the
        next decode step, with no prefill. ``tokens`` is the stream so far
        (>= 1), counted against the original ``max_new_tokens``. None when
        no slot is free or the lease is refused."""
        self._check_shippable("submit_seeded")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("submit_seeded needs >= 1 generated token (the decode "
                             "step feeds the stream's last emitted token)")
        if len(tokens) >= max_new_tokens:
            raise ValueError(f"stream already finished: {len(tokens)} generated tokens "
                             f">= max_new_tokens {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(f"prompt={len(prompt)} + gen={max_new_tokens} exceeds "
                             f"max_seq_len {self.ecfg.max_seq_len}")
        if not self.scheduler.free:
            return None
        slot = self.scheduler.free[-1]
        # a plain lease (no trie walk): imported blocks stay private to the
        # slot, their content hash is the shipping host's concern
        if not self.store.lease(slot, len(prompt), max_new_tokens):
            return None
        try:
            self.store.import_blocks(slot, payload)
        except Exception:
            self.store.reset(slot)
            raise
        t = now()
        req = Request(id=next(self._req_ids), prompt=prompt,
                      max_new_tokens=max_new_tokens, state=RequestState.RUNNING,
                      tokens=tokens, sampling=sampling, stop_history=tuple(stop_history),
                      want_logprobs=want_logprobs,
                      metrics=RequestMetrics(arrival_s=t, prompt_len=len(prompt),
                                             admitted_s=t, first_token_s=t,
                                             n_generated=len(tokens)))
        req.logprobs = [float(v) for v in logprobs]
        req.top_logprobs = [[(int(tk), float(v)) for tk, v in row] for row in top_logprobs]
        # the seeded prefix was emitted and harvested on the shipping host:
        # placeholders keep token_ts index-aligned with tokens
        req.token_ts = [t] * len(tokens)
        self.scheduler.admit_seeded(req)
        self._presence[slot, :] = False
        self._presence[slot, prompt] = True
        self._presence[slot, tokens] = True
        self.metrics.submitted += 1
        self.metrics.imported_slots += 1
        self.metrics.imported_blocks += payload["n_blocks"]
        return req

    def step(self) -> None:
        """One engine iteration: join waiting requests into free slots, then
        one batched decode step for whatever is in flight."""
        with tracing.span("engine.step"):
            with tracing.span("engine.admit"):
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
                with tracing.span("engine.decode"):
                    if self.ecfg.speculative:
                        self._spec_decode_once()
                    else:
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

    # ------------------------------------------------------- non-generative

    def embed(self, prompt: Sequence[int]) -> Dict[str, np.ndarray]:
        """Non-generative forward (embeddings, classification): one bucketed
        dispatch (flag ``embed/<bucket>``) returning the prompt's
        last-position final-norm hidden state and its last-position logits
        row, padded vocab columns trimmed. No slot is leased and the cache
        is not touched."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("embed needs a non-empty prompt")
        bucket = bucket_for(len(prompt), self.scheduler.buckets)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(prompt)] = prompt
        last = np.asarray([len(prompt) - 1], np.int32)
        hid, row = self._dispatch(self._embed, self._params_buf,
                                  Buffer(toks, name=f"embed{bucket}"), Buffer(last),
                                  flags=f"embed/{bucket}")
        self.metrics.embed_requests += 1
        return {"embedding": hid[0].cpu().numpy(),
                "logits": row[0, :self.cfg.vocab].cpu().numpy()}

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
