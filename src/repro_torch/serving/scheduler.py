"""Slot-based continuous-batching scheduler (rtp-llm FIFOScheduler shape).

Requests wait in a FIFO; every engine step the scheduler joins as many waiting
requests as there are free slots into the in-flight decode batch and retires
finished ones — there is no full-batch barrier, a long request never blocks
short ones from entering and leaving around it.

Admissions are grouped by *prefill bucket* (prompt padded up to a small fixed
set of lengths) so same-bucket arrivals share one prefill forward and the
number of distinct compiled prefill shapes is bounded by ``len(buckets)``
instead of the number of distinct prompt lengths seen in traffic.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Sequence, Tuple

import numpy as np

MIN_BUCKET = 16


def default_buckets(max_len: int) -> Tuple[int, ...]:
    """Powers of two from MIN_BUCKET up, capped at ``max_len``."""
    buckets: List[int] = []
    b = MIN_BUCKET
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class Scheduler:
    def __init__(self, n_slots: int, buckets: Sequence[int]):
        self.n_slots = n_slots
        self.buckets = tuple(sorted(buckets))
        # pop() from the tail — reversed so slot 0 is leased first
        self.free: List[int] = list(range(n_slots))[::-1]
        self.active: Dict[int, object] = {}        # slot -> Request
        self.waiting: Deque[object] = deque()

    # ------------------------------------------------------------------ FIFO

    def enqueue(self, request) -> None:
        self.waiting.append(request)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def n_active(self) -> int:
        return len(self.active)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    # ------------------------------------------------------------ join/retire

    def plan_admissions(self, try_lease=None
                        ) -> List[Tuple[int, List[Tuple[int, object]]]]:
        """Lease free slots to waiting requests (FIFO), grouped by prefill
        bucket: [(bucket_len, [(slot, request), ...]), ...]. Mutates the free
        list and active map — the engine must prefill every planned request.

        ``try_lease(slot, request) -> bool`` lets the cache backend reserve
        capacity before the slot is committed (serving/store.py). A False
        return stops planning with the request still at the queue head —
        FIFO-order admission backpressure (e.g. paged block-pool exhaustion),
        resolved when a retire frees capacity."""
        groups: Dict[int, List[Tuple[int, object]]] = {}
        while self.waiting and self.free:
            req = self.waiting[0]
            slot = self.free[-1]
            if try_lease is not None and not try_lease(slot, req):
                break
            self.waiting.popleft()
            self.free.pop()
            self.active[slot] = req
            b = bucket_for(len(req.prompt), self.buckets)
            groups.setdefault(b, []).append((slot, req))
        return sorted(groups.items())

    def decode_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """The in-flight batch as fixed-shape host arrays: ``tokens``
        (n_slots, 1) int32 — each active slot's last emitted token, the
        input the decode step feeds next — and the ``active`` mask
        (n_slots,)."""
        tokens = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros((self.n_slots,), bool)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.last_token
            active[slot] = True
        return tokens, active

    def retire(self, slot: int):
        req = self.active.pop(slot)
        self.free.append(slot)
        return req
