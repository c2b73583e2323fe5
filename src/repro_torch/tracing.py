"""The port's span recorder: host-time spans at the serving path's layer
boundaries, kept in memory until ``take()``.

A span is ``Span(name, start_ns, end_ns, span_id, parent_id, thread_id,
attrs)`` on ``now_ns`` (``time.perf_counter_ns``), the host clock that a
device trace can be tied to by marker kernels. The parent is the innermost
span open on the same thread, or one the caller names: the OPQ lane's
``opq.run`` names the engine span that issued its instruction. Request
spans carry ``req=<Request.id>``.

The recorder is on between ``enable()`` and ``disable()``, and while a
``torch.profiler`` session records (as ``torch.profiler.record_function``
is), so a profiled window carries the program's spans. Off, ``span()``
returns one shared no-op context and ``record()`` returns at once: no
clock read, no span kept. On or off, nothing here synchronises a device.

Spans, by thread (children indented)::

    engine thread: engine.step
                     engine.admit: admit.plan, admit.wait, admit.write, admit.emit
                     engine.decode: decode.inputs, decode.wait, decode.emit
                   request.queue, request.prefill, request.decode (one each
                     per request, from its RequestMetrics timestamps)
    OPQ lane:      opq.run (flags)
                     opq.issue: fwd.embed, fwd.layer (i): fwd.attn, fwd.ffn;
                                fwd.head, fwd.sample; or, for a decode step
                                replayed as a CUDA graph, fwd.graph
                                (captured_launches, capture=0/1)
                     opq.sync
                   under an MoE layer's fwd.ffn (models/moe.py):
                     fwd.moe: moe.route, moe.experts (pairs, passes,
                              host_reads), moe.shared

A span's ``note(**attrs)`` adds attributes while it is open (counters that
its body works out); the no-op span ignores them.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

now_ns = time.perf_counter_ns

ROOT = 0          # ``parent=ROOT``: a span with no parent


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    attrs: Dict


_on = False
_spans: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on or _profiler._is_profiler_enabled


def take() -> List[Span]:
    """The spans recorded so far, in the order they ended; the recorder
    keeps none of them."""
    n = len(_spans)
    out = _spans[:n]
    del _spans[:n]
    return out


def _stack() -> List[int]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def current() -> Optional[int]:
    """The id of the innermost span open on this thread, or None."""
    stack = _stack() if enabled() else ()
    return stack[-1] if stack else None


def ns(seconds: float) -> int:
    """A ``now_ns() / 1e9`` reading back in nanoseconds."""
    return round(seconds * 1e9)


class _Noop:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Open:
    __slots__ = ("name", "parent", "attrs", "span_id", "start")

    def __init__(self, name: str, parent: Optional[int], attrs: Dict):
        self.name, self.parent, self.attrs = name, parent, attrs

    def __enter__(self):
        stack = _stack()
        if self.parent is None:
            self.parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        stack.append(self.span_id)
        self.start = now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = now_ns()
        _stack().pop()
        _spans.append(Span(self.name, self.start, end, self.span_id, self.parent or None,
                           threading.get_ident(), self.attrs))
        return False

    def note(self, **attrs) -> None:
        """Add attributes known only once the body has run (counters)."""
        self.attrs.update(attrs)


def span(name: str, parent: Optional[int] = None, **attrs):
    """A context manager that records ``name`` around its body when the
    recorder is on; ``parent`` overrides the thread's innermost open span."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Open(name, parent, attrs)


def record(name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
           **attrs) -> None:
    """Record a span from two ``now_ns`` readings the caller already took."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    _spans.append(Span(name, start_ns, end_ns, next(_ids), parent or None,
                       threading.get_ident(), attrs))


def write_chrome_trace(path: str, spans: Iterable[Span]) -> None:
    """Write one Chrome trace event (``ph: X``, microseconds) per span, for
    Perfetto or chrome://tracing: a track per thread of this process, and
    the request spans under process 0, a track per request."""
    pid = os.getpid()
    events = []
    for s in spans:
        req = s.attrs.get("req")
        events.append({"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "pid": pid if req is None else 0,
                       "tid": s.thread_id if req is None else req,
                       "args": dict(s.attrs, span_id=s.span_id, parent_id=s.parent_id)})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
