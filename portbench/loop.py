"""The closed loop that drives the engine, and what the harness sees of it.

Phases, all timed on the host's monotonic clock:

1. warm-up: one request of each prefill bucket the mix reaches, alone, two
   tokens each;
2. ramp: the clients start, ``ramp_wave`` per engine step, each with a
   first request whose output budget is cut so that the first requests
   end spread out (``Traffic.ramp_request``); client ``c``'s ``j``-th
   request is ``Traffic.key(c, j)``; the ramp ends once every
   client's first request has its first token;
3. window: from the ramp's end ``t0``, whole engine steps until
   ``t_stop``, the end of the first step by which the window has emitted
   its work, ``work_tokens`` output tokens (the cell's
   ``window_out_tok_s`` times ``seconds``): every run then times the same
   work, since the traffic sends the same sizes in the same order for
   every seed. The loop's output comes in bursts, a step of admissions
   lasting seconds between decode steps of some 50 ms, so a window cut at
   a time instead ends before or after a burst as the card runs a little
   faster or slower, and moves the rate several times as much as the
   speed. A window that has not done its work by ``CAP`` times
   ``seconds``, and one without ``work_tokens``, closes at the first step
   that ends at or after ``t0`` plus that time. Each client sends its next
   request as soon as it sees its last one finish;
4. drain: no new request; steps go on until every request that arrived in
   the window has its first token (at most ``DRAIN_S`` past the close).

Tokens are stamped when ``Engine.step()`` returns with them: the moment a
caller sees them. A request is due when its client saw the last one
finish; its time to first token runs from then.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from portbench import sut
from portbench import work
from portbench.model import Model
from portbench.traffic import Traffic, warmup_lengths

DRAIN_S = 60.0
CAP = 3.0
COUNTERS = ("decode_steps", "steps", "occupancy_sum", "prefill_wait_s", "prefill_tokens")


def now() -> float:
    return time.perf_counter()


@dataclasses.dataclass
class Served:
    """One request as its client sees it."""
    k: int                      # the request's index (Traffic.key)
    client: int
    prompt_len: int
    budget: int
    due: float
    req: object = None          # the engine's Request; None when refused
    stamps: List[float] = dataclasses.field(default_factory=list)
    finished: Optional[float] = None
    failed: bool = False


@dataclasses.dataclass
class Step:
    start: float
    end: float
    tokens: int                 # tokens emitted by the step
    prefills: List[int]         # prompt lengths admitted by the step
    contexts: List[int]         # live context of each decoded row
    blocks_used: Optional[int] = None


@dataclasses.dataclass
class Record:
    """Everything a run measured; the metric readers read this."""
    model: Model
    t0: float = 0.0
    seconds: float = 0.0        # the length the rate is taken over: as asked, or as
                                # the window ran where its work sized it
    t_stop: float = 0.0         # the end of the window's last step
    setup_s: float = 0.0
    served: List[Served] = dataclasses.field(default_factory=list)
    steps: List[Step] = dataclasses.field(default_factory=list)   # window steps
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)  # window deltas
    pool_blocks: Optional[int] = None
    trace: object = None        # devtrace.Summary of a traced run
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up phase ends
    work: work.Work = dataclasses.field(default_factory=work.Work)

    @property
    def window_s(self) -> float:
        """The seconds of whole engine steps the window ran."""
        return self.t_stop - self.t0

    def arrivals(self) -> List[Served]:
        """Requests due inside the window."""
        return [s for s in self.served if self.t0 <= s.due < self.t_stop]

    def in_window(self, t: float) -> bool:
        return self.t0 < t <= self.t_stop


class Loop:
    def __init__(self, eng, traffic: Traffic, m: Model):
        self.eng = eng
        self.traffic = traffic
        self.m = m
        self.rec = Record(model=m)
        self._live: List[Served] = []
        self._ready: List[Tuple[int, float]] = []     # (client, due)
        self._ready_later: List[int] = []             # clients refused last step
        self._sent = [0] * traffic.clients              # requests each client sent

    # ----------------------------------------------------------- clients

    def _submit_ready(self, ramp: bool = False) -> None:
        for client, due in self._ready:
            k = self.traffic.key(client, self._sent[client])
            self._sent[client] += 1
            prompt, budget = (self.traffic.ramp_request(k) if ramp
                              else self.traffic.request(k))
            s = Served(k=k, client=client, prompt_len=len(prompt), budget=budget, due=due)
            s.req = self.eng.submit(prompt, max_new_tokens=budget)
            self.rec.served.append(s)
            if s.req is None:
                s.failed = True
                self._ready_later.append(client)
            else:
                self._live.append(s)
        self._ready = []

    def _step(self, accepting: bool) -> Step:
        t_start = now()
        self.eng.step()
        t_end = now()
        step = Step(start=t_start, end=t_end, tokens=0, prefills=[], contexts=[])
        still = []
        for s in self._live:
            n = len(s.req.tokens)
            for j in range(len(s.stamps), n):
                if j == 0:
                    step.prefills.append(s.prompt_len)
                else:
                    step.contexts.append(s.prompt_len + j)
            step.tokens += n - len(s.stamps)
            s.stamps.extend([t_end] * (n - len(s.stamps)))
            if s.req.done:
                s.finished = t_end
                if accepting:
                    self._ready.append((s.client, t_end))
            else:
                still.append(s)
        self._live = still
        if accepting:
            self._ready.extend((c, t_end) for c in self._ready_later)
        self._ready_later = []
        return step

    # ------------------------------------------------------------ phases

    def warmup(self) -> None:
        """Each prefill bucket the mix reaches, once, alone."""
        buckets = list(getattr(self.eng.scheduler, "buckets", ()))
        lo, hi = self.traffic.prompt_range()
        lengths = warmup_lengths(buckets, lo, hi) if buckets else [hi]
        for i, n in enumerate(lengths):
            req = self.eng.submit(self.traffic.warmup_prompt(n, i), max_new_tokens=2)
            if req is None:
                raise RuntimeError(f"the engine refused a {n}-token warm-up prompt")
            while not req.done:
                self.eng.step()

    def run(self, seconds: float, on_open: Callable = lambda: None,
            on_close: Callable = lambda: None, work_tokens: Optional[int] = None) -> Record:
        self.warmup()
        self.rec.marks["warmup"] = now()
        clients, wave = self.traffic.clients, self.traffic.ramp_wave
        started = 0
        firsts: List[Served] = []
        # only the first requests: later ones may wait on a full pool at any step
        while started < clients or not all(s.stamps or s.failed for s in firsts):
            if started < clients:
                t = now()
                first = self._ready
                self._ready = [(c, t) for c in range(started, min(clients, started + wave))]
                n = len(self.rec.served)
                self._submit_ready(ramp=True)
                firsts.extend(self.rec.served[n:])
                self._ready = first
                started = min(clients, started + wave)
            self._submit_ready()
            self._step(accepting=True)
        on_open()
        rec = self.rec
        rec.t0 = now()
        rec.seconds = seconds
        self._ready = [(c, max(due, rec.t0)) for c, due in self._ready]
        before = self._counters()
        emitted = 0
        while True:
            self._submit_ready()
            step = self._step(accepting=True)
            blocks = sut.pool_blocks(self.eng)
            if blocks is not None:
                step.blocks_used, rec.pool_blocks = blocks
            rec.steps.append(step)
            emitted += step.tokens
            if work_tokens is None:
                if step.end >= rec.t0 + seconds:
                    break
            elif emitted >= work_tokens or step.end >= rec.t0 + CAP * seconds:
                break
        rec.t_stop = rec.steps[-1].end
        if work_tokens is not None:
            rec.seconds = rec.window_s
        after = self._counters()
        on_close()
        rec.counters = {k: after[k] - before[k] for k in COUNTERS}
        self._drain()
        for st in rec.steps:
            for p in st.prefills:
                rec.work.add(work.prefill(self.m, p))
            rec.work.add(work.decode_step(self.m, st.contexts))
        return rec

    def _drain(self) -> None:
        """Follow every window arrival to its first token, or fail it."""
        rec = self.rec
        self._ready = []
        deadline = now() + DRAIN_S
        waiting = [s for s in rec.arrivals() if not s.failed and not s.stamps]
        while waiting and now() < deadline:
            self._step(accepting=False)
            waiting = [s for s in waiting if not s.stamps]
        for s in waiting:
            s.failed = True

    def _counters(self) -> Dict[str, float]:
        mt = self.eng.metrics
        return {k: float(getattr(mt, k)) for k in COUNTERS}


def served_tokens(s: Served) -> np.ndarray:
    """The tokens the engine served for ``s``."""
    return np.asarray(s.req.tokens, dtype=np.int64)
