"""Multi-host serving router: the OPQ placement policy over real transports
— the port of ``repro.serving.router``.

GPTPU's runtime places tile instructions on the accelerator already holding
their input buffer (affinity) and falls back to the least-loaded lane
(core/opq.py ``_pick_lane``); Jouppi et al. make the same argument at rack
scale — serving utilization comes from scheduling work onto the accelerator
that already holds the data. This module applies that policy across hosts:
a :class:`Router` fronts N hosts behind the
:class:`~repro_torch.serving.transport.HostTransport` protocol — in-process
engines (the default, ``build_inproc_fleet``) or one OS process per host
(``SubprocessTransport``) — and places whole requests the way OPQ places
instructions:

  * **cache-affinity placement** — requests carry an affinity key (an
    explicit ``session``, or a hash of the prompt ids); a key's requests pin
    to the host whose slot pool served it last — the host holding its leased
    blocks — and the hit is counted exactly the way OPQ counts per-lane
    affinity (``stats()["router"]["placed"/"affinity_hits"]``).
  * **load-aware spill** — when the pinned host cannot take the request NOW
    (paged block pool dry — ``lease_headroom`` — or its queue/door rejects),
    the router places it on the least-loaded accepting host instead of
    head-of-line blocking the fleet behind one dry pool, counts a ``spill``,
    and re-pins the key to where the blocks actually leased. First-seen keys
    go least-loaded, the OPQ FCFS fallback. The door predicates are
    advisory: admission races with other traffic (and, on subprocess hosts,
    with the worker's own free-running loop), so a candidate whose door
    closed between ``would_accept`` and ``submit`` is simply skipped and the
    next candidate tried — the ledger records the host that actually took
    the request.
  * **drain/handoff** — ``drain(host)`` stops placing traffic on a host and
    empties it without losing or changing a single token: queued requests
    are pulled (``evict_queued``) and re-placed verbatim; in-flight requests
    with more than ``handoff_threshold`` tokens left are preempted
    (``preempt`` returns the authoritative segment state) and re-admitted on
    another host as a continuation — ``prompt + tokens generated so far``
    through the normal fused prefill-with-cache seeding path, which is
    bit-identical to decode replay, so the stitched stream equals an
    undrained run bit-for-bit where prefill keeps decode's bits
    (tests/test_torch_router.py). Short
    remainders just finish in place on the draining host. Once
    ``is_drained``, the host can restart elastically and return via
    ``undrain``.
  * **loss recovery** — a transport failure (timeout, dead worker process)
    marks the host LOST: it leaves the placement pool, its queued and
    in-flight requests are re-admitted elsewhere as continuations from the
    tokens already *harvested* (a token only counts as emitted once a
    ``poll`` returned it), and requests no surviving host can take yet wait
    as orphans retried every step. Because decode is deterministic, the
    replacement segment regenerates exactly the tokens that died un-polled
    in the lost process — the stream stays bit-identical and never
    double-emits (tests/test_torch_transport.py kills a worker with SIGKILL
    mid-decode and asserts exactly this).

  * **prefill/decode disaggregation** — ``RouterConfig.roles`` (built by
    :func:`parse_disaggregate` from a ``prefill:N,decode:M`` spec) splits
    the fleet: admissions (and every re-prefill fallback) place only on
    prefill-role hosts, and once a stream's prefill has finished its exact
    cache blocks are SHIPPED to a decode-role host over the transport
    (``ship_blocks``/``recv_blocks``/``ack_ship``) — decode hosts never
    dispatch a prefill instruction, so long-prompt admission work stops
    head-of-line-blocking the decode batch (the GPTPU role-matching thesis
    at fleet scale). Shipped blocks carry exact cache bits, so the handed-
    off stream is bit-identical to never having moved; a failed ship falls
    back to the re-prefill continuation path, which stays the oracle.

Determinism: every host is batch-invariant (staggered == sequential) and
greedy/seeded decode is a pure function of the token prefix, so ANY
placement — spills, handoffs, mid-run drains, even crash re-admissions —
yields bit-identical tokens to serving the same requests one at a time on a
single host. The router can therefore never trade correctness for load
balance or availability.
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serving.metrics import now
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.transport import (
    EngineConfig, HostTransport, QueueFull, TransportError,
    build_inproc_fleet,
)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet-level knobs (per-host knobs stay in EngineConfig).

    n_hosts
        Hosts the router fronts — one transport per host, each fronting an
        engine with its own OPQ runtime and slot pool. Ignored when an
        explicit ``transports`` fleet is handed to the Router.
    handoff_threshold
        ``drain(host)``: in-flight requests with MORE than this many tokens
        still to generate are preempted and re-admitted on another host;
        at/below it they finish on the draining host (a handoff costs one
        continuation prefill — not worth it for a tail of a few tokens).
        Under disaggregation the same threshold gates block shipping: a
        remainder at/below it finishes on its prefill host.
    roles
        Prefill/decode disaggregation (``parse_disaggregate`` builds this
        from a ``--disaggregate prefill:N,decode:M`` spec): one role per
        host. ``prefill`` hosts take every admission (fused/chunked prefill
        AND the re-prefill fallback); ``decode`` hosts ONLY ever receive
        shipped cache blocks and run the decode step — their OPQ flag audit
        stays free of prefill instructions by construction. None (default)
        disables role splitting: every host does both.
    ships_per_step
        Ship pacing: at most this many block-ship import attempts per fleet
        step. A ship is a synchronous export->wire->import leg inside the
        step loop, so an unpaced burst (every stream of a fresh mix turning
        eligible at once) would stall harvesting — and therefore every
        OTHER stream's observed inter-token latency — for the whole burst.
        Streams past the budget simply keep decoding on their prefill host
        until a later step ships them.
    """

    n_hosts: int = 2
    handoff_threshold: int = 4
    roles: Optional[Tuple[str, ...]] = None
    ships_per_step: int = 1


# refused imports (decode-side slot/lease backpressure) tolerated before a
# parked ship gives up and falls back to re-prefill. Refusals are capacity
# signals, not errors — a decode host refusing now admits once its streams
# drain (tens of steps for a full slot set), so this is a wedged-host
# safety valve, sized far above any healthy drain, not a fast-fail knob:
# the fallback recomputes the prefill, which costs the bit-identity the
# ship existed to preserve.
_MAX_SHIP_TRIES = 256


def parse_disaggregate(spec: str, n_hosts: int) -> Tuple[str, ...]:
    """``--disaggregate`` spec -> per-host role tuple, prefill hosts first.
    Accepts ``prefill:N,decode:M`` or the shorthand ``N:M``; N + M must
    equal the fleet size and each role needs at least one host."""
    counts = {"prefill": 0, "decode": 0}
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    try:
        if (len(parts) == 1 and ":" in parts[0]
                and parts[0].split(":")[0].strip().isdigit()):
            n, m = parts[0].split(":")
            counts["prefill"], counts["decode"] = int(n), int(m)
        else:
            for part in parts:
                role, n = part.split(":")
                counts[role.strip()] += int(n)
    except (KeyError, ValueError) as e:
        raise ValueError(
            f"--disaggregate expects 'prefill:N,decode:M' (or 'N:M'), "
            f"got {spec!r}") from e
    if counts["prefill"] < 1 or counts["decode"] < 1:
        raise ValueError(
            f"--disaggregate needs at least one host per role, got "
            f"prefill:{counts['prefill']},decode:{counts['decode']}")
    total = counts["prefill"] + counts["decode"]
    if total != n_hosts:
        raise ValueError(
            f"--disaggregate assigns {total} hosts but the fleet has "
            f"{n_hosts}")
    return (("prefill",) * counts["prefill"]
            + ("decode",) * counts["decode"])


@dataclasses.dataclass
class RouterRequest:
    """The fleet-level request: per-host requests are per-segment internals
    (a handoff retires one and opens another); ``tokens`` is the stitched
    stream and ``hosts`` the placement trail (len > 1 == handed off).
    ``tokens`` advances as the router harvests (``poll``) — it is the
    caller-visible truth; un-harvested tokens on a host are provisional and
    regenerated exactly if that host dies."""

    id: int
    prompt: np.ndarray
    max_new_tokens: int
    session: Optional[str]
    arrival_s: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    # worker-side emission time of each token (engine-stamped, monotonic
    # epoch — see transport poll's "ts"): honest inter-token gaps even when
    # a free-running worker's tokens reach the router in one burst
    token_ts: List[float] = dataclasses.field(default_factory=list)
    hosts: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_s: Optional[float] = None
    sampling: Optional[SamplingParams] = None   # rides every segment
    finish_reason: Optional[str] = None         # from the final segment
    want_logprobs: Optional[int] = None         # rides every segment
    logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[List[Tuple[int, float]]] = dataclasses.field(
        default_factory=list)

    @property
    def n_generated(self) -> int:
        return len(self.tokens)


# per-host stats substitute once a host is lost: zeros for everything the
# fleet sums, so aggregation degrades instead of crashing
_FLEET_KEYS = ("submitted", "rejected", "admissions_deferred",
               "evicted", "preempted", "completed", "tokens_generated",
               "decode_steps", "prefill_batches", "prefill_tokens",
               "spec_rounds", "draft_steps", "proposed_tokens",
               "accepted_tokens", "sampled_tokens", "stop_hits",
               "embed_requests")


class Router:
    """See module docstring. Typical use::

        router = Router(cfg, params, EngineConfig(max_slots=4),
                        RouterConfig(n_hosts=2))          # on the card
        req = router.submit(prompt_ids, max_new_tokens=16, session="user-7")
        router.drain(0)                       # elastic restart of host 0
        router.run_until_complete()
        print(req.tokens, router.stats()["router"])

    or, with real host processes::

        fleet = [SubprocessTransport(model_spec, engine_cfg)
                 for _ in range(2)]
        router = Router(transports=fleet)
    """

    def __init__(self, cfg: ArchConfig = None, params=None,
                 engine_cfg: EngineConfig = None,
                 router_cfg: RouterConfig = None, *, draft_params=None,
                 transports: Optional[Sequence[HostTransport]] = None,
                 device=None):
        self.rcfg = router_cfg or RouterConfig()
        if transports is not None:
            # an explicit fleet sets its own size
            self.rcfg = dataclasses.replace(self.rcfg,
                                            n_hosts=len(transports))
        if self.rcfg.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.rcfg.n_hosts}")
        if self.rcfg.handoff_threshold < 0:
            raise ValueError("handoff_threshold must be >= 0")
        if self.rcfg.ships_per_step < 1:
            raise ValueError("ships_per_step must be >= 1")
        if self.rcfg.roles is not None:
            roles = tuple(self.rcfg.roles)
            if len(roles) != self.rcfg.n_hosts:
                raise ValueError(
                    f"roles assigns {len(roles)} hosts but the fleet has "
                    f"{self.rcfg.n_hosts}")
            bad = [r for r in roles if r not in ("prefill", "decode")]
            if bad:
                raise ValueError(f"unknown host roles {bad!r} (want "
                                 f"'prefill' or 'decode')")
            if "prefill" not in roles or "decode" not in roles:
                raise ValueError(
                    "disaggregation needs at least one prefill host and "
                    "one decode host")
            self.rcfg = dataclasses.replace(self.rcfg, roles=roles)
        if transports is None:
            transports = build_inproc_fleet(cfg, params, engine_cfg,
                                            self.rcfg.n_hosts,
                                            draft_params=draft_params,
                                            device=device)
        self.transports: List[HostTransport] = list(transports)
        self._draining: Set[int] = set()
        self._lost: Set[int] = set()
        self._affinity: Dict[str, int] = {}        # key -> host of last lease
        # (host, per-host request id) -> fleet request, with a harvest cursor
        # (tokens already polled off that segment) per live placement
        self._live: Dict[Tuple[int, int], RouterRequest] = {}
        self._cursor: Dict[Tuple[int, int], int] = {}
        # finished ids each host should forget, shipped with the next poll
        self._drop: List[List[int]] = [[] for _ in range(self.rcfg.n_hosts)]
        # requests from a lost (or mid-drain-rejected) host awaiting a
        # surviving host with capacity; retried every step
        self._orphans: List[RouterRequest] = []
        # shipped-but-unimported block payloads awaiting decode-host
        # capacity; retried every step (the recv is idempotent, the source's
        # export-ledger hold stays open until the outcome settles)
        self._ship_parked: List[Dict] = []
        self._req_ids = itertools.count()
        self.completed: List[RouterRequest] = []
        # the OPQ-shaped placement ledger: placed/affinity_hits is the
        # cross-host analog of opq issued/affinity_hits
        self.counters: Dict[str, int] = {
            "placed": 0, "affinity_hits": 0, "spills": 0, "rejected": 0,
            "drains": 0, "handoffs": 0, "requeued": 0,
            "hosts_lost": 0, "recovered": 0,
            "ships": 0, "shipped_blocks": 0, "ship_fallbacks": 0,
        }

    @property
    def engines(self):
        """The underlying engines of an in-process fleet — test/debug access
        only (raises AttributeError on transports without one, e.g. a real
        host process, where there is no same-address-space engine to hand
        out)."""
        return [t.engine for t in self.transports]

    # ------------------------------------------------------------- transport

    def _guard(self, host: int, fn, *args, default=None, **kwargs):
        """Run one transport call; a transport-level failure marks the host
        LOST (re-placing its work) and returns ``default`` so fleet-level
        control flow degrades instead of unwinding."""
        try:
            return fn(*args, **kwargs)
        except TransportError:
            self._mark_lost(host)
            return default

    def _mark_lost(self, host: int) -> None:
        """Host-loss recovery: pull the host from the placement pool, close
        its transport (reaping a dead worker — no orphan processes), and
        re-admit every request it owned as a continuation from the tokens
        already harvested. Determinism regenerates the un-harvested tail
        exactly, so the recovered stream is bit-identical and nothing
        double-emits."""
        if host in self._lost:
            return
        self._lost.add(host)
        self.counters["hosts_lost"] += 1
        try:
            self.transports[host].close()
        except Exception:
            pass
        self._drop[host] = []
        for key in [k for k in self._live if k[0] == host]:
            rreq = self._live.pop(key)
            self._cursor.pop(key, None)
            if rreq.max_new_tokens - len(rreq.tokens) <= 0:
                # every token was already harvested; only the final done
                # frame died with the host
                self._finalize(rreq, rreq.finish_reason or "length")
                continue
            if not self._readmit(rreq):
                self._orphans.append(rreq)

    def _readmit(self, rreq: RouterRequest) -> bool:
        """Re-admit a disrupted request as a continuation on any surviving
        host; False leaves it an orphan for the next step's retry."""
        remaining = rreq.max_new_tokens - len(rreq.tokens)
        cont_prompt = np.concatenate(
            [rreq.prompt, np.asarray(rreq.tokens, np.int32)]
        ) if rreq.tokens else rreq.prompt
        placed = self._place(self._key(rreq.prompt, rreq.session),
                             len(cont_prompt), remaining)
        if placed is None:
            return False
        if not self._submit_segment(rreq, placed[0], cont_prompt, remaining):
            return False
        self.counters["recovered"] += 1
        return True

    def _finalize(self, rreq: RouterRequest, reason: Optional[str]) -> None:
        rreq.done = True
        rreq.finish_s = now()
        rreq.finish_reason = reason
        self.completed.append(rreq)

    # ------------------------------------------------------------- placement

    def _key(self, prompt: np.ndarray, session: Optional[str]) -> str:
        """The affinity key: an explicit session pins a user's requests
        together; otherwise identical prompts hash together (prefix-cache
        affinity in spirit — the host already holds those K/V blocks)."""
        if session is not None:
            return f"s:{session}"
        return f"p:{zlib.crc32(np.ascontiguousarray(prompt).tobytes()):#x}"

    def _load(self, host: int) -> int:
        return self._guard(host, self.transports[host].load, default=1 << 30)

    def _alive(self, exclude: Set[int] = frozenset()) -> List[int]:
        return [h for h in range(self.rcfg.n_hosts)
                if h not in self._draining and h not in self._lost
                and h not in exclude]

    def _admitting(self, exclude: Set[int] = frozenset()) -> List[int]:
        """Hosts eligible for ADMISSION placement: alive, and under
        disaggregation never a decode-role host. Admission dispatches
        prefill — and so does every fallback (re-prefill continuation,
        orphan re-admission), so routing them all through this filter is
        what keeps a decode host's OPQ flag audit prefill-free no matter
        which failure path ran."""
        alive = self._alive(exclude)
        if self.rcfg.roles is None:
            return alive
        return [h for h in alive if self.rcfg.roles[h] == "prefill"]

    def _place(self, key: str, prompt_len: int, max_new_tokens: int,
               exclude: Set[int] = frozenset()
               ) -> Optional[Tuple[int, bool, bool]]:
        """Pick a host for a request: pinned host first (affinity), else
        least-loaded accepting host (FCFS fallback; a bypassed pin counts as
        a spill). Returns (host, affinity_hit, spilled), or None when no
        host can ever take it. Mirrors opq lane-picking one level up."""
        alive = self._admitting(exclude)
        if not alive:
            return None
        pinned = self._affinity.get(key)
        spilled = False
        if pinned is not None and pinned in alive:
            t = self.transports[pinned]
            if (self._guard(pinned, t.would_accept, prompt_len,
                            max_new_tokens, default=False)
                    and self._guard(pinned, t.lease_headroom, prompt_len,
                                    max_new_tokens, default=False)):
                return pinned, True, False
            # the pinned host's pool is dry (or its door rejects): shed the
            # request rather than queue the fleet behind one host
            spilled = pinned not in self._lost
        alive = self._admitting(exclude)       # a probe may have lost a host
        accepting = [h for h in sorted(alive, key=self._load)
                     if self._guard(h, self.transports[h].would_accept,
                                    prompt_len, max_new_tokens,
                                    default=False)]
        if not accepting:
            return None
        # prefer a host that can lease immediately; fall back to queueing on
        # the least-loaded door if every pool is dry right now
        ready = [h for h in accepting
                 if self._guard(h, self.transports[h].lease_headroom,
                                prompt_len, max_new_tokens, default=False)]
        pick = (ready or accepting)[0]
        if pick == pinned:
            # every pool is dry and the least-loaded door is the pin itself:
            # the request lands where its pin points, so the ledger records a
            # (queued) affinity hit, not a spill
            return pinned, True, False
        return pick, False, spilled

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               session: Optional[str] = None,
               sampling: Optional[SamplingParams] = None,
               want_logprobs: Optional[int] = None,
               strict: bool = False) -> Optional[RouterRequest]:
        """Place one request on the fleet. Returns the RouterRequest, or
        None when every host rejects it (QueueFull when ``strict``) — the
        same door contract as the engine's own submit. ``sampling`` and
        ``want_logprobs`` ride the request through every segment a
        drain/handoff opens, so a seeded stream stitches bit-identically to
        an undrained run.

        The door predicates in ``_place`` are a snapshot, not a lease:
        another submit (or, on subprocess hosts, the worker's own loop) can
        consume the capacity between ``would_accept`` and ``submit``. A
        candidate whose door closed in that window returns None from submit
        and the NEXT candidate is re-validated and tried — never a
        spurious fleet-level rejection while some host still accepts."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        key = self._key(prompt, session)
        tried: Set[int] = set()
        host = eid = None
        hit = spilled = False
        while True:
            placed = self._place(key, len(prompt), max_new_tokens,
                                 exclude=tried)
            if placed is None:
                break
            host, hit, spilled = placed
            eid = self._guard(host, self.transports[host].submit,
                              prompt, max_new_tokens, sampling=sampling,
                              want_logprobs=want_logprobs)
            if eid is not None:
                break
            tried.add(host)                # door closed since the probe —
            host = None                    # re-validate the next candidate
        if eid is None or host is None:
            self.counters["rejected"] += 1
            if strict:
                raise QueueFull(
                    f"no host accepts prompt={len(prompt)} + "
                    f"gen={max_new_tokens} "
                    f"(draining={sorted(self._draining)})")
            return None
        self.counters["placed"] += 1
        self.counters["affinity_hits"] += int(hit)
        self.counters["spills"] += int(spilled)
        self._affinity[key] = host                 # pin to where the lease is
        rreq = RouterRequest(id=next(self._req_ids), prompt=prompt,
                             max_new_tokens=max_new_tokens, session=session,
                             arrival_s=now(), hosts=[host], sampling=sampling,
                             want_logprobs=want_logprobs)
        self._live[(host, eid)] = rreq
        self._cursor[(host, eid)] = 0
        return rreq

    # ------------------------------------------------------------ drain/handoff

    def drain(self, host: int) -> None:
        """Stop admitting to ``host`` and empty it without losing a token:
        re-place its queued requests, hand off in-flight generations longer
        than ``handoff_threshold`` as continuations (``prompt + tokens so
        far`` re-admitted through the normal seeding path — bit-identical to
        not draining), and let short tails finish in place. The host keeps
        stepping until its slots empty (``is_drained``); ``undrain`` returns
        it to the placement pool after an elastic restart."""
        if not 0 <= host < self.rcfg.n_hosts:
            raise ValueError(f"no host {host} (n_hosts={self.rcfg.n_hosts})")
        if host in self._draining:
            return
        self._draining.add(host)
        self.counters["drains"] += 1
        if host in self._lost:
            return                         # nothing left to empty
        t = self.transports[host]
        # sync the harvest mirror first so continuation prompts and the
        # handoff-threshold decision see every token the host emitted
        self._harvest(host)
        if host in self._lost:
            return
        # queued requests hold no cache state: re-place them verbatim. A
        # request no other host can take goes back to the draining host's
        # queue — drain blocks NEW traffic, not work already accepted.
        # Requests the router does not own (submitted to the engine
        # directly) re-enqueue on the host untouched — the host side of
        # evict_queued handles them (transport.EngineHost).
        owned = [eid for (h, eid) in self._live if h == host]
        for eid in self._guard(host, t.evict_queued, owned, default=[]):
            key = (host, eid)
            rreq = self._live.pop(key, None)
            if rreq is None:
                continue
            self._cursor.pop(key, None)
            self._reroute(rreq, fallback=host)
        if host in self._lost:
            return
        # in-flight: hand off the long generations, finish the short tails
        for entry in self._guard(host, t.inflight, default=[]):
            eid = int(entry["id"])
            key = (host, eid)
            rreq = self._live.get(key)
            if rreq is None:
                continue                   # not router-placed: finish here
            remaining = rreq.max_new_tokens - len(rreq.tokens)
            if remaining <= self.rcfg.handoff_threshold:
                continue
            target = self._place(self._key(rreq.prompt, rreq.session),
                                 len(rreq.prompt) + len(rreq.tokens),
                                 remaining, exclude={host})
            if target is None:
                continue                   # nowhere to go: finish here
            wire = self._guard(host, t.preempt, eid)
            if host in self._lost:
                return                     # loss recovery took over
            if wire is None:
                continue                   # finished meanwhile: next poll
            del self._live[key]
            cur = self._cursor.pop(key, 0)
            self._absorb_segment(rreq, wire, cur)
            remaining = rreq.max_new_tokens - len(rreq.tokens)
            if remaining <= 0:
                self._finalize(rreq, wire.get("finish_reason") or "length")
                continue
            cont_prompt = np.concatenate(
                [rreq.prompt, np.asarray(rreq.tokens, np.int32)])
            if self._submit_segment(rreq, target[0], cont_prompt, remaining):
                self.counters["handoffs"] += 1
            else:
                self._orphans.append(rreq)

    def _absorb_segment(self, rreq: RouterRequest, wire: Dict,
                        cursor: int) -> None:
        """Fold a preempted segment's authoritative wire state into the
        fleet request: everything past the harvest cursor (a free-running
        worker may be ahead of the last poll)."""
        absorbed = wire["tokens"][cursor:]
        rreq.tokens.extend(int(t) for t in absorbed)
        # the wire form carries no emission times; absorb time is the best
        # stand-in (preemption already interrupts the stream's cadence)
        rreq.token_ts.extend([now()] * len(absorbed))
        if rreq.want_logprobs is not None:
            rreq.logprobs.extend(float(v)
                                 for v in wire.get("logprobs", [])[cursor:])
            rreq.top_logprobs.extend(
                [(int(t), float(v)) for t, v in row]
                for row in wire.get("top_logprobs", [])[cursor:])

    def _reroute(self, rreq: RouterRequest, fallback: int) -> None:
        remaining = rreq.max_new_tokens - len(rreq.tokens)
        cont_prompt = np.concatenate(
            [rreq.prompt, np.asarray(rreq.tokens, np.int32)]
        ) if rreq.tokens else rreq.prompt
        placed = self._place(self._key(rreq.prompt, rreq.session),
                             len(cont_prompt), remaining)
        host = fallback if placed is None else placed[0]
        if not self._submit_segment(rreq, host, cont_prompt, remaining):
            self._orphans.append(rreq)
        self.counters["requeued"] += 1

    def _submit_segment(self, rreq: RouterRequest, host: int,
                        prompt: np.ndarray, max_new_tokens: int) -> bool:
        # sampling params survive the handoff, and the new segment's stop
        # matcher sees the tokens earlier segments generated (stop_history)
        # — position-counter randomness makes the stitched seeded stream
        # bit-identical to the undrained one
        eid = self._guard(host, self.transports[host].submit,
                          prompt, max_new_tokens, sampling=rreq.sampling,
                          stop_history=tuple(rreq.tokens),
                          want_logprobs=rreq.want_logprobs)
        if eid is None:
            return False
        self._live[(host, eid)] = rreq
        self._cursor[(host, eid)] = 0
        rreq.hosts.append(host)
        self._affinity[self._key(rreq.prompt, rreq.session)] = host
        return True

    def is_drained(self, host: int) -> bool:
        """Draining AND empty — safe to restart the host process. A lost
        host is vacuously drained (its work was re-placed)."""
        if host not in self._draining:
            return False
        if host in self._lost:
            return True
        return not self._guard(host, self.transports[host].has_work,
                               default=False)

    def undrain(self, host: int) -> None:
        """Return a (restarted) host to the placement pool."""
        self._draining.discard(host)

    # --------------------------------------------------------------- stepping

    def step(self) -> None:
        """One fleet iteration: pump every live host (one engine step for
        in-process hosts; a no-op for subprocess hosts, whose workers
        free-run), harvest new tokens and completions, and retry orphaned
        requests against recovered capacity. Draining hosts are pumped too —
        they must finish what they hold."""
        if self._orphans:
            pending, self._orphans = self._orphans, []
            for rreq in pending:
                if not self._readmit(rreq):
                    self._orphans.append(rreq)
        for host in range(self.rcfg.n_hosts):
            if host in self._lost:
                continue
            self._guard(host, self.transports[host].pump)
            if host in self._lost:
                continue
            self._harvest(host)
        if self.rcfg.roles is not None:
            self._disagg_handoff()

    def _disagg_handoff(self) -> None:
        """Move prefilled streams from prefill-role hosts onto decode-role
        hosts by SHIPPING their exact cache blocks over the transport — no
        recompute, so the continued stream is bit-identical to never having
        moved. A stream becomes eligible once its first token was harvested
        (its prefill is finished) and its remainder is worth the move
        (handoff_threshold); with no decode host holding lease headroom it
        simply keeps decoding where it is and is retried next step. A
        REFUSED import (a free-running decode worker won the slot/lease
        race between the headroom probe and the recv) is transient: the
        extracted payload parks and the recv retries next step — it is
        idempotent, so a retry never double-imports. Only a corrupt frame
        or ``_MAX_SHIP_TRIES`` consecutive refusals fall back to the
        re-prefill continuation path on a PREFILL host — the degenerate
        oracle — so decode hosts stay prefill-free no matter which leg
        fails; the source's export-ledger hold is released (``ack_ship``)
        once the outcome settles, on every path."""
        budget = self.rcfg.ships_per_step
        if self._ship_parked:
            parked, self._ship_parked = self._ship_parked, []
            for item in parked:
                if budget <= 0:
                    self._ship_parked.append(item)
                    continue
                status = self._recv_install(item["entry"], item["rreq"],
                                            item["src"])
                if status == "shipped":
                    budget -= 1
                    continue
                if status == "refused":
                    budget -= 1            # a recv attempt was spent;
                    item["tries"] += 1     # no-dst waits without burning
                                           # retries: capacity WILL free
                if (status in ("corrupt", "dead")
                        or item["tries"] > _MAX_SHIP_TRIES):
                    self._ship_fallback(item["rreq"], item["src"],
                                        item["entry"]["payload_id"])
                else:
                    self._ship_parked.append(item)
        src_keys = [k for k in self._live
                    if self.rcfg.roles[k[0]] == "prefill"]
        for key in src_keys:
            if budget <= 0:
                break                      # paced: the rest ship next steps
            host, eid = key
            rreq = self._live.get(key)
            if rreq is None or host in self._lost:
                continue
            if not rreq.tokens:
                continue                   # prefill not harvested yet
            remaining = rreq.max_new_tokens - len(rreq.tokens)
            if remaining <= self.rcfg.handoff_threshold:
                continue                   # short tail: finish in place
            if not self._ship_dsts(rreq):
                continue                   # no decode capacity right now
            t_src = self.transports[host]
            entry = self._guard(host, t_src.ship_blocks, eid)
            if host in self._lost:
                continue                   # loss recovery re-placed it
            if entry is None:
                continue                   # finished meanwhile: next poll
            # the stream is off the source engine now: fold its
            # authoritative segment state in before deciding where it lands
            del self._live[key]
            cur = self._cursor.pop(key, 0)
            wire = entry["wire"]
            pid = entry["payload_id"]
            self._absorb_segment(rreq, wire, cur)
            if rreq.max_new_tokens - len(rreq.tokens) <= 0:
                self._guard(host, t_src.ack_ship, pid)
                self._finalize(rreq, wire.get("finish_reason") or "length")
                continue
            status = self._recv_install(entry, rreq, host)
            budget -= 1
            if status == "corrupt":
                self._ship_fallback(rreq, host, pid)
            elif status != "shipped":
                self._ship_parked.append(
                    {"entry": entry, "rreq": rreq, "src": host, "tries": 1})

    def _ship_dsts(self, rreq: RouterRequest) -> List[int]:
        """Alive decode-role hosts with lease headroom for this stream."""
        return [h for h in self._alive()
                if self.rcfg.roles[h] == "decode"
                and self._guard(h, self.transports[h].lease_headroom,
                                len(rreq.prompt), rreq.max_new_tokens,
                                default=False)]

    def _recv_install(self, entry: Dict, rreq: RouterRequest,
                      src: int) -> str:
        """Offer a shipped payload to the least-loaded eligible decode host.
        Returns ``"shipped"`` (imported + installed, source hold acked),
        ``"refused"``/``"no-dst"`` (transient: park and retry), ``"dead"``
        (no decode host left alive: fall back now), or ``"corrupt"`` (the
        importer rejected the frame: fall back)."""
        alive = [h for h in self._alive()
                 if self.rcfg.roles[h] == "decode"]
        if not alive:
            return "dead"
        dsts = self._ship_dsts(rreq)
        if not dsts:
            return "no-dst"
        dst = min(dsts, key=self._load)
        try:
            new_id = self._guard(dst, self.transports[dst].recv_blocks,
                                 entry)
        except ValueError:
            return "corrupt"               # importer refused: bad frame
        if new_id is None:
            return "refused"               # slot/lease race: retry
        self._guard(src, self.transports[src].ack_ship,
                    entry["payload_id"])
        wire = entry["wire"]
        self._live[(dst, new_id)] = rreq
        self._cursor[(dst, new_id)] = len(wire["tokens"])
        rreq.hosts.append(dst)
        self.counters["ships"] += 1
        self.counters["shipped_blocks"] += int(entry["payload"]["n_blocks"])
        return "shipped"

    def _ship_fallback(self, rreq: RouterRequest, src: int,
                       payload_id: str) -> None:
        """A ship that cannot complete: release the source's export-ledger
        hold and continue by re-prefill on a PREFILL host (decode hosts
        never prefill, even on the failure path)."""
        self._guard(src, self.transports[src].ack_ship, payload_id)
        self.counters["ship_fallbacks"] += 1
        cont = np.concatenate(
            [rreq.prompt, np.asarray(rreq.tokens, np.int32)])
        rem = rreq.max_new_tokens - len(rreq.tokens)
        placed = self._place(self._key(rreq.prompt, rreq.session),
                             len(cont), rem)
        if placed is None or not self._submit_segment(
                rreq, placed[0], cont, rem):
            self._orphans.append(rreq)

    def _harvest(self, host: int) -> None:
        """Poll one host for token deltas past each live request's cursor.
        Polling is idempotent — a duplicated or retried poll re-reads, never
        re-emits — and a request's done flag travels with its final tokens,
        so completion is atomic with the tokens that caused it."""
        cursors = {eid: self._cursor[(h, eid)]
                   for (h, eid) in self._live if h == host}
        drop, self._drop[host] = self._drop[host], []
        if not cursors and not drop:
            return
        deltas = self._guard(host, self.transports[host].poll, cursors,
                             drop, default=None)
        if deltas is None:
            self._drop[host] = drop        # poll failed: host marked lost
            return
        for eid, delta in deltas.items():
            key = (host, int(eid))
            rreq = self._live.get(key)
            if rreq is None:
                continue
            new = [int(t) for t in delta.get("t", ())]
            rreq.tokens.extend(new)
            ts = [float(v) for v in delta.get("ts", ())]
            # tolerate older workers without timestamps: harvest time is
            # the (burst-quantized) fallback
            rreq.token_ts.extend(ts if len(ts) == len(new)
                                 else [now()] * len(new))
            self._cursor[key] += len(new)
            if rreq.want_logprobs is not None:
                rreq.logprobs.extend(float(v) for v in delta.get("lp", ()))
                rreq.top_logprobs.extend(
                    [(int(t), float(v)) for t, v in row]
                    for row in delta.get("tl", ()))
            if delta.get("done"):
                del self._live[key]
                del self._cursor[key]
                self._drop[host].append(int(eid))
                self._finalize(rreq, delta.get("reason"))

    def progress(self, rreq: RouterRequest) -> List[int]:
        """The stitched token stream as of the last harvest — what an SSE
        streamer polls between fleet steps. Harvest is continuous (every
        ``step`` polls deltas), so this is simply the mirror."""
        return list(rreq.tokens)

    def embed(self, prompt: Sequence[int]) -> Dict[str, np.ndarray]:
        """Non-generative forward on the least-loaded live host —
        embeddings/classification never lease a slot, so placement is pure
        load balancing (no affinity to honour)."""
        alive = self._alive()
        if not alive:
            raise RuntimeError("every host is draining — no embed capacity")
        host = min(alive, key=self._load)
        out = self._guard(host, self.transports[host].embed, prompt)
        if out is None:
            return self.embed(prompt)      # host died mid-call: next host
        return out

    def has_work(self) -> bool:
        # un-finalized placements count as work even when every host is idle:
        # a free-running worker can finish (and go idle) between fleet steps,
        # and the completion still has to be harvested by a poll
        if self._orphans or self._live or self._ship_parked:
            return True
        return any(self._guard(h, self.transports[h].has_work, default=False)
                   for h in range(self.rcfg.n_hosts) if h not in self._lost)

    def run_until_complete(self, max_steps: int = 100_000
                           ) -> List[RouterRequest]:
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"fleet did not drain in {max_steps} steps")
        return self.completed

    # ---------------------------------------------------------------- summary

    def stats(self) -> Dict:
        """Fleet telemetry, three levels down: ``router`` (the placement
        ledger — placed/affinity_hits/spills in the OPQ per-lane shape, plus
        drain/handoff/loss counts and per-transport RPC telemetry),
        ``fleet`` (host counters summed across the fleet), and ``per_host``
        (each host's full stats, its own per-lane OPQ counters included;
        zeros for a lost host, which can no longer report)."""
        per_host = []
        for host in range(self.rcfg.n_hosts):
            s = (None if host in self._lost
                 else self._guard(host, self.transports[host].stats))
            per_host.append(s if s is not None else dict(
                {k: 0 for k in _FLEET_KEYS},
                first_token_s=None, last_token_s=None, lost=True))
        fleet = {k: sum(h[k] for h in per_host) for k in _FLEET_KEYS}
        # fleet rate over the FLEET's first->last token span — summing
        # per-host rates would overstate it whenever host spans differ
        # (e.g. a host drained early has a short span and a high rate)
        firsts = [h["first_token_s"] for h in per_host
                  if h.get("first_token_s") is not None]
        lasts = [h["last_token_s"] for h in per_host
                 if h.get("last_token_s") is not None]
        span = (max(lasts) - min(firsts)) if firsts else 0.0
        fleet["sustained_tok_s"] = (
            fleet["tokens_generated"] / span if span > 0
            else float("inf") if fleet["tokens_generated"] else 0.0)
        return {
            "router": dict(self.counters, hosts=self.rcfg.n_hosts,
                           roles=(list(self.rcfg.roles)
                                  if self.rcfg.roles else None),
                           draining=sorted(self._draining),
                           lost=sorted(self._lost),
                           orphans=len(self._orphans),
                           completed=len(self.completed),
                           transport=[dict(t.metrics.summary(), kind=t.kind)
                                      for t in self.transports]),
            "fleet": fleet,
            "per_host": per_host,
        }

    def close(self) -> None:
        for host, t in enumerate(self.transports):
            if host in self._lost:
                continue                   # already closed at loss time
            try:
                t.close()
            except TransportError:
                pass
