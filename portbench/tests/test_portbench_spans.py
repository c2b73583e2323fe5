"""The readers of the program's spans (``portbench/progspans.py`` and the
metrics ``decode_issue_ms``, ``issue_idle_share``, ``queue_wait_p90_ms``)
on synthetic records, the exact innermost-span lookup at any depth, a
reduced cell on the CPU with a profiler session over its window, and the
same cell traced on a card."""

import math
import sys
import types

import pytest
import torch

import pbtest
import repro_torch

from portbench import progspans, spec, sut
from portbench.loop import Loop, Record, Served
from portbench.model import Model
from portbench.traffic import Traffic
from repro_torch.tracing import Span

M = Model(family="dense", n_layers=1, d_model=8, n_heads=1, n_kv=1, head_dim=8, vocab=16, d_ff=8)
MS = 1_000_000


def _reader(name):
    return spec.reader("metrics", name)


def _span(name, a, b, sid, parent=None, **attrs):
    return Span(name, a, b, sid, parent, 1, attrs)


def _brute(host, t):
    inside = [(b - a, name) for name, a, b in host if a <= t <= b]
    return min(inside)[1] if inside else None


@pytest.mark.parametrize("depth", [1, 65, 300])
def test_innermost_is_exact_at_any_depth(depth):
    # ``depth`` spans nested inside one another, each with many short
    # siblings that start after the outer ones, and a span after them all
    host = [(f"d{i}", i * 10, 100_000 - i * 10) for i in range(depth)]
    host += [(f"leaf{i}", 50_000 + 3 * i, 50_000 + 3 * i + 1) for i in range(200)]
    host.append(("after", 200_000, 200_010))
    times = [0, 5, 10 * depth - 1, 49_999, 50_000, 50_002, 50_600, 99_000, 150_000,
             200_005, 300_000]
    got = progspans.innermost(host, times)
    assert got == [_brute(host, t) for t in times]
    assert got[4] == "leaf0" and got[-1] is None and got[-2] == "after"


def _traced_record(spans, ops, t0_ns=1_000 * MS, t1_ns=2_000 * MS, offset=0):
    rec = Record(model=M, t0=t0_ns / 1e9, seconds=1.0, t_stop=t1_ns / 1e9)
    rec.trace = types.SimpleNamespace(
        ops=[("k", a + offset, b + offset) for a, b in ops], offset_ns=offset,
        window_s=(t1_ns - t0_ns) / 1e9, program_spans=spans)
    return rec


def _window_spans():
    """Two decode instructions and a prefill, one decode starting before
    the window; the engine waits in ``decode.wait`` across each."""
    s = []
    sid = iter(range(1, 100))

    def run(flags, a, b, layers):
        r, i = next(sid), next(sid)
        s.append(_span("opq.run", a, b, r, flags=flags))
        s.append(_span("opq.issue", a + MS, b - 10 * MS, i, r))
        for n, (la, lb) in enumerate(layers):
            lay = next(sid)
            s.append(_span("fwd.layer", la, lb, lay, i, i=n))
            s.append(_span("fwd.attn", la, (la + lb) // 2, next(sid), lay))
        s.append(_span("opq.sync", b - 10 * MS, b, next(sid), r))
    run("decode", 990 * MS, 1_100 * MS, [])
    run("decode", 1_200 * MS, 1_400 * MS, [(1_210 * MS, 1_250 * MS)])
    run("prefill/1024", 1_500 * MS, 1_900 * MS, [])
    s.append(_span("decode.wait", 1_195 * MS, 1_405 * MS, next(sid)))
    return s


def test_decode_issue_ms_is_the_mean_decode_issue_in_the_window():
    rec = _traced_record(_window_spans(), [])
    # only the decode that starts inside the window: 1201 .. 1390 ms
    assert abs(_reader("decode_issue_ms")(rec) - 189.0) < 1e-9


def test_issue_idle_share_counts_gaps_under_issue_and_forward_spans():
    # busy everywhere but four 10 ms gaps: inside fwd.attn, inside the
    # issue outside any layer, inside opq.sync, and under no span
    gaps = [1_220, 1_300, 1_395, 1_450]
    ops, prev = [], 1_000 * MS
    for g in gaps:
        ops.append((prev, g * MS))
        prev = (g + 10) * MS
    ops.append((prev, 2_000 * MS))
    rec = _traced_record(_window_spans(), ops, offset=123_456)
    idle = progspans.idle_by_span(rec)
    assert set(idle) == {"fwd.attn", "opq.issue", "opq.sync", progspans.UNCOVERED}
    assert all(abs(v - 0.01) < 1e-12 for v in idle.values())
    assert abs(_reader("issue_idle_share")(rec) - 2.0) < 1e-9


def test_readers_are_silent_without_a_trace_or_a_recorder(monkeypatch):
    untraced = Record(model=M, t0=1.0, seconds=1.0, t_stop=2.0)
    older = _traced_record(None, [])
    del older.trace.program_spans
    # a program without the recorder: the import fails
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for rec in (untraced, older):
        for name in ("decode_issue_ms", "issue_idle_share"):
            assert _reader(name)(rec) is None
    assert older.trace.program_spans is None


def _request(wait):
    metrics = types.SimpleNamespace(queue_wait_s=wait)
    return types.SimpleNamespace(metrics=metrics)


def test_queue_wait_p90_skips_refused_requests():
    rec = Record(model=M, t0=0.0, seconds=10.0, t_stop=10.0)
    for k in range(10):
        rec.served.append(Served(k=k, client=k, prompt_len=4, budget=2, due=1.0,
                                 req=_request(0.1 * (k + 1))))
    rec.served.append(Served(k=10, client=0, prompt_len=4, budget=2, due=1.0, failed=True))
    rec.served.append(Served(k=11, client=1, prompt_len=4, budget=2, due=11.0,
                             req=_request(50.0)))       # due after the window
    assert abs(_reader("queue_wait_p90_ms")(rec) - 900.0) < 1e-9
    rec.served[0].req = _request(None)                  # never admitted
    assert abs(_reader("queue_wait_p90_ms")(rec) - 1000.0) < 1e-9
    rec.served[1].req = _request(None)
    assert _reader("queue_wait_p90_ms")(rec) == math.inf


def test_a_profiled_cpu_window_carries_the_program_spans():
    cell, cpu = pbtest.smoke_cell("qwen3-14b.chat"), torch.device("cpu")
    m = Model.from_config(cell.config)
    cfg = sut.port_config(cell.config)
    eng = sut.engine(cfg, sut.port_params(m, cfg, 21, cpu), cell.store, cell.engine, cpu)
    loop = Loop(eng, Traffic(cell.traffic, m.vocab, 21), m)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    try:
        rec = loop.run(1.0, on_open=prof.start, on_close=prof.stop)
    finally:
        eng.close()
    lo, hi = int(rec.t0 * 1e9), int(rec.t_stop * 1e9)
    rec.trace = types.SimpleNamespace(ops=[], offset_ns=0, window_s=(hi - lo) / 1e9)
    spans = progspans.spans(rec)
    assert spans and progspans.spans(rec) is spans            # taken once, kept
    # the recorder followed the profiler: nothing before the window opened
    assert min(s.start_ns for s in spans if s.name == "engine.step") >= lo
    issue = _reader("decode_issue_ms")(rec)
    assert 0 < issue <= _reader("decode_step_ms")(rec)
    assert 0 <= _reader("issue_idle_share")(rec) <= 100
    assert _reader("queue_wait_p90_ms")(rec) <= _reader("ttft_p90_ms.host")(rec)


@pytest.mark.cuda
def test_a_reduced_cell_reports_the_span_metrics_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode here")
    from portbench.run import execute, readings
    cell = pbtest.smoke_cell("qwen3-14b.chat")
    rec, _, _ = execute(cell, 5, 2.0, True, torch.device("cuda"), judge=False)
    got = {k: v["value"] for k, v in readings(spec.cell("qwen3-14b.chat"), rec,
                                               trace=True).items()}
    assert 0 < got["decode_issue_ms"] <= got["decode_step_ms"]
    assert 0 <= got["issue_idle_share"] <= got["idle_share"]
    assert got["queue_wait_p90_ms"] <= got["ttft_p90_ms.host"]
