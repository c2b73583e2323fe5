"""The program's own spans in a traced run, and the device's idle gaps
labelled by them.

The port records spans at its layer boundaries (``repro_torch.tracing``)
while a ``torch.profiler`` session records, so the traced window's spans
are in the program's recorder when the run ends, on the host clock that
``devtrace`` ties to the device trace. They are taken once and kept on the
trace summary as ``program_spans``. Without a trace, or with a program that
has no recorder, there are none and the readers of this module return
None.

An idle gap is labelled by the shortest program span around its midpoint,
by an exact sweep (every span is considered, however many nest), or
``harness`` where no program span covers it.
"""

from __future__ import annotations

import collections
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import devtrace

UNCOVERED = "harness"


def spans(rec) -> Optional[List]:
    """The program's spans of the traced window, or None."""
    trace = rec.trace
    if trace is None:
        return None
    if not hasattr(trace, "program_spans"):
        try:
            from repro_torch import tracing
        except ImportError:         # a program without the recorder
            trace.program_spans = None
        else:
            trace.program_spans = tracing.take()
    return trace.program_spans or None


def innermost(host: Sequence[Tuple[str, int, int]], times: Sequence[int]) -> List[Optional[str]]:
    """For each of ``times``, the name of the shortest of the ``host``
    spans (name, start, end) whose closed interval holds it, or None."""
    order = sorted(host, key=lambda s: s[1])
    out: List[Optional[str]] = [None] * len(times)
    heap: List[Tuple[int, int, int]] = []       # (length, end, index) of started spans
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and order[j][1] <= t:
            name, a, b = order[j]
            heapq.heappush(heap, (b - a, b, j))
            j += 1
        # a span that ended before t has ended for every later time too
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        if heap:
            out[k] = order[heap[0][2]][0]
    return out


def idle_by_span(rec) -> Optional[Dict[str, float]]:
    """Idle seconds of the traced window by the program span around each
    gap: the gaps of ``devtrace.Summary`` (the window less the merged
    device operations), labelled here by program spans."""
    found = spans(rec)
    if found is None:
        return None
    trace = rec.trace
    off = trace.offset_ns
    lo, hi = int(rec.t0 * 1e9) + off, int(rec.t_stop * 1e9) + off
    busy = devtrace._merge([(a, b) for _, a, b in trace.ops])
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [(s.name, s.start_ns + off, s.end_ns + off) for s in found]
    labels = innermost(host, [(a + b) // 2 for a, b in gaps])
    out: Dict[str, float] = collections.Counter()
    for (a, b), name in zip(gaps, labels):
        out[name or UNCOVERED] += (b - a) / 1e9
    return out
