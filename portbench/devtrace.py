"""The traced run: the device's activity from ``torch.profiler`` (CUDA
activity only, so the host pays little for it), host spans the benchmark
records around its calls into the engine's layers, and the reduction of
both to busy time, top device operations and idle gaps labelled by what
the host was doing.

Clocks: each span is taken on ``time.perf_counter_ns``. The device
trace's clock is tied to it by marker kernels (``torch.cuda._sleep``),
each launched on an idle device right after a host reading, three before
the window and three after; the median of their offsets maps host times
to device times to within a launch's latency, tens of microseconds. One
marker found in the trace is enough.

Spans (installed on the engine object by wrapping its methods; the
program is not edited): ``step`` (``Engine.step``), ``admit``
(``_admit``), ``decode`` (``_decode_once``), ``decode.sampling_batch``,
``store.write_slots``, and ``opq:<flag>`` around each instruction the
engine's operation queue executes, issue and completion wait included
(``opq:decode``, ``opq:prefill``, ``opq:prefill_chunked``, ...). A device
operation belongs to the phase of the innermost ``opq:`` span around its
midpoint; an idle gap is labelled by the innermost span around its
midpoint, or ``harness`` (the benchmark's own work between steps).
"""

from __future__ import annotations

import bisect
import collections
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
MARKER_CYCLES = 20000
MARKERS = 3                     # markers before and after the window
NAME_CHARS = 120                # device operation names are cut to this


class Spans:
    """Host spans: (name, start_ns, end_ns), from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def add(self, name: str, start: int, end: int) -> None:
        with self._lock:
            self.items.append((name, start, end))

    def wrap(self, obj, attr: str, name) -> None:
        """Replace ``obj.attr`` by a wrapper that records a span around each
        call; ``name`` is a string or a function of the call's arguments."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name(*args) if callable(name) else name, t, time.perf_counter_ns())
        setattr(obj, attr, spanned)


def _opq_name(ins, *_args) -> str:
    return "opq:" + (getattr(ins, "flags", "") or "?").split("/")[0]


def install(eng, spans: Spans) -> None:
    """Wrap the engine's layer calls (module doc)."""
    spans.wrap(eng, "step", "step")
    spans.wrap(eng, "_admit", "admit")
    spans.wrap(eng, "_decode_once", "decode")
    spans.wrap(eng, "_sampling_batch", "decode.sampling_batch")
    spans.wrap(eng.store, "write_slots", "store.write_slots")
    if getattr(eng, "opq", None) is not None:
        spans.wrap(eng.opq, "_executor", _opq_name)


def _markers() -> List[int]:
    out = []
    for _ in range(MARKERS):
        torch.cuda.synchronize()
        out.append(time.perf_counter_ns())
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.001)
    return out


class Tracer:
    """Start before the window opens, stop after it closes."""

    def __init__(self, eng):
        self.spans = Spans()
        install(eng, self.spans)
        self.prof = None
        self.marks: List[int] = []
        self.wall_ns = 0

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.wall_ns = time.time_ns() - time.perf_counter_ns()
        time.sleep(0.05)
        self.marks += _markers()

    def stop(self) -> None:
        self.marks += _markers()
        self.prof.stop()

    def summary(self, t0: float, t1: float) -> "Summary":
        """Reduce the trace to the window [t0, t1] (perf_counter seconds)."""
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        return Summary(events, self.marks, self.wall_ns, self.spans.items,
                       int(t0 * 1e9), int(t1 * 1e9))


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Innermost:
    """The innermost (shortest) span around a host time."""

    def __init__(self, spans: List[Tuple[str, int, int]]):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]

    def at(self, t: int) -> Optional[str]:
        best = None
        i = bisect.bisect_right(self.starts, t)
        # spans nest or follow each other; look back over the few that can
        # still be open at t
        for name, a, b in reversed(self.spans[max(0, i - 64):i]):
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else None


def _offset(found: List[int], marks: List[int], wall_ns: int) -> Tuple[int, int]:
    """The device-minus-host clock offset: the median over the marker
    kernels found (device starts) of each one's start minus its host
    launch time. With every marker found they pair in order; otherwise
    each pairs with the launch nearest to it under ``wall_ns`` (the wall
    clock minus the host's counter: the trace's timestamps are wall-clock
    times). Returns (offset, markers found)."""
    if not found:
        raise RuntimeError("no marker kernel in the device trace")
    if len(found) == len(marks):
        offsets = [a - m for a, m in zip(found, marks)]
    else:
        offsets = [a - min(marks, key=lambda m: abs(a - m - wall_ns)) for a in found]
    offsets.sort()
    return offsets[len(offsets) // 2], len(found)


def _phases(host, times: List[int]) -> List[Optional[str]]:
    """The ``opq:`` span around each time (instructions run one at a time,
    so these spans do not overlap), or None."""
    opq = sorted((a, b, n) for n, a, b in host if n.startswith("opq:"))
    starts = [a for a, _, _ in opq]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        out.append(opq[i][2] if i >= 0 and opq[i][1] >= t else None)
    return out


class Summary:
    """The window's device activity (module doc)."""

    def __init__(self, events, marks: List[int], wall_ns: int, spans, t0_ns: int,
                 t1_ns: int):
        self.n_events = len(events)
        self.offset_ns, self.markers_found = _offset(
            sorted(a for name, a, _ in events if MARKER in name), marks, wall_ns)
        self.offset_vs_wall_ns = self.offset_ns - wall_ns
        lo, hi = t0_ns + self.offset_ns, t1_ns + self.offset_ns
        ends = [b for _, _, b in events]
        # where the trace's device events stop, against the window's end
        self.last_event_s = (max(ends) - hi) / 1e9 if ends else None
        self.window_s = (hi - lo) / 1e9
        # device operations inside the window, clipped to it
        self.ops = [(name, max(a, lo), min(b, hi)) for name, a, b in events
                    if MARKER not in name and b > lo and a < hi]
        busy = _merge([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        host = [(n, a + self.offset_ns, b + self.offset_ns) for n, a, b in spans]
        label = _Innermost(host)
        self.phase_of = _phases(host, [(a + b) // 2 for _, a, b in self.ops])
        gaps = []
        prev = lo
        for a, b in busy + [(hi, hi)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        self.idle = collections.Counter()
        self.idle_count = collections.Counter()
        for a, b in gaps:
            name = label.at((a + b) // 2) or "harness"
            self.idle[name] += (b - a) / 1e9
            self.idle_count[name] += 1

    def device_s(self, match: Callable[[str], bool], phase: Optional[str] = None) -> float:
        """Device seconds of operations whose name passes ``match``, within
        ``phase`` (an ``opq:`` span name) when given."""
        return sum(b - a for (name, a, b), ph in zip(self.ops, self.phase_of)
                   if match(name) and (phase is None or ph == phase)) / 1e9

    def breakdown(self) -> Dict:
        by_name = collections.Counter()
        for name, a, b in self.ops:
            by_name[name[:NAME_CHARS]] += (b - a) / 1e9
        return {"device_ops": [[n, s] for n, s in by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in self.idle.most_common(10)]}
