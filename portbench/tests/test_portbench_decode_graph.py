"""The reader of ``decode_graph_share`` on synthetic spans: every decode
instruction of the window replays the graph, none does (the spans of a
program that issues each forward kernel by kernel), some do; and silent
without a trace or for a program without the graphed decode step."""

import sys
import types

import pbtest  # noqa: F401  (the checkout's root and src on the import path)

from portbench import spec
from portbench.loop import Record
from portbench.model import Model
from repro_torch.tracing import Span

M = Model(family="dense", n_layers=1, d_model=8, n_heads=1, n_kv=1, head_dim=8, vocab=16, d_ff=8)
MS = 1_000_000


def _record(spans):
    rec = Record(model=M, t0=1.0, seconds=1.0, t_stop=2.0)
    rec.trace = types.SimpleNamespace(ops=[], offset_ns=0, window_s=1.0, program_spans=spans)
    return rec


def _spans(replayed):
    """A decode instruction before the window, one per entry of
    ``replayed`` inside it (True: its issue replays the graph; False: it
    issues layer by layer) and a prefill."""
    out, ids = [], iter(range(1, 1000))

    def run(flags, a, graph):
        r, i = next(ids), next(ids)
        out.append(Span("opq.run", a, a + 50 * MS, r, None, 1, {"flags": flags}))
        out.append(Span("opq.issue", a + MS, a + 10 * MS, i, r, 1, {}))
        child = (Span("fwd.graph", a + 2 * MS, a + 9 * MS, next(ids), i, 1,
                      {"captured_launches": 321, "capture": 0}) if graph
                 else Span("fwd.layer", a + 2 * MS, a + 9 * MS, next(ids), i, 1, {"i": 0}))
        out.append(child)
    run("decode", 900 * MS, True)
    for k, graph in enumerate(replayed):
        run("decode", (1_000 + 60 * k) * MS, graph)
    run("prefill/1024", 1_900 * MS, False)
    return out


def test_every_replayed_decode_reads_100():
    assert spec.reader("metrics", "decode_graph_share")(_record(_spans([True] * 5))) == 100.0


def test_a_program_that_issues_every_forward_reads_0():
    spans = [s for s in _spans([False] * 5) if s.name != "fwd.graph"]
    assert spec.reader("metrics", "decode_graph_share")(_record(spans)) == 0.0


def test_the_share_counts_the_window_only():
    got = spec.reader("metrics", "decode_graph_share")(_record(_spans([True, False, False, True])))
    assert got == 50.0


def test_silent_without_a_trace_or_without_the_graphed_step(monkeypatch):
    read = spec.reader("metrics", "decode_graph_share")
    assert read(Record(model=M, t0=1.0, seconds=1.0, t_stop=2.0)) is None
    assert read(_record([])) is None
    monkeypatch.setitem(sys.modules, "repro_torch.models.decode_graph", None)
    assert read(_record(_spans([True] * 3))) is None
