"""Scheduler (serving/scheduler.py): the 90th percentile (nearest rank) of
the time each request due in the window waited in the engine's queue,
from its submission to its admission (``RequestMetrics.queue_wait_s``), in
ms. Refused requests are left out; one never admitted counts as infinitely
long. Requests admitted in the drain after the window count."""

import math

from portbench import stats


def read(rec):
    waits = []
    for s in rec.arrivals():
        if s.req is None:
            continue
        w = s.req.metrics.queue_wait_s
        waits.append(math.inf if w is None else w)
    v = stats.nearest_rank(waits, 90)
    return None if v is None else 1e3 * v
