"""The port's span recorder (repro_torch.tracing) on the CPU engine at the
smoke config: off, it records nothing, reads no clock and leaves the tokens
as they are; on, every forward layer nests under the OPQ lane's issue of
an instruction that an engine step issued, each request's three spans tile
its life, the admission counters are the sums of their spans, and the
Chrome export holds one event per span."""

import json

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch.serve import quant_predicate
from repro_torch.models.model import init_model_quantized
from repro_torch.serving import Engine, EngineConfig

CFG = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
BASE = dict(max_slots=2, max_seq_len=48, block_size=8)
# routes whose forwards carry spans: fused prefill and paged decode through
# the kernel's wrapper, the chunked scan (buckets 32 and 48 in pieces of 16),
# and the contiguous store
ROUTES = {
    "paged_kernel": dict(cache_backend="paged", paged_native=True, paged_kernel=True),
    "chunked": dict(cache_backend="paged", paged_native=True, prefill_chunk=16),
    "contiguous": dict(cache_backend="contiguous"),
}
PROMPT_LENS = [5, 20, 12, 30]
GEN = 8


@pytest.fixture(scope="module")
def params():
    return init_model_quantized(CFG, torch.Generator().manual_seed(0), quant_predicate)


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _serve(params, route, on):
    """Staggered traffic through a fresh engine, the recorder on or off;
    returns (token streams, requests, engine metrics, spans)."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab, (n,), dtype=np.int32) for n in PROMPT_LENS]
    eng = Engine(CFG, params, EngineConfig(**BASE, **ROUTES[route]), device="cpu")
    if on:
        tracing.enable()
    try:
        reqs = [eng.submit(prompts[0], GEN)]
        eng.step()
        reqs += [eng.submit(p, GEN) for p in prompts[1:]]
        eng.run_until_complete()
    finally:
        tracing.disable()
        eng.close()
    return [r.tokens for r in reqs], reqs, eng.metrics, tracing.take()


def _by_id(spans):
    return {s.span_id: s for s in spans}


def _ancestor(s, ids, prefix):
    """The nearest ancestor of ``s`` whose name starts with ``prefix``."""
    while s.parent_id is not None:
        s = ids[s.parent_id]
        if s.name.startswith(prefix):
            return s
    return None


@pytest.mark.parametrize("route", list(ROUTES))
def test_off_records_nothing_and_on_keeps_the_tokens(params, route):
    toks_off, _, _, spans_off = _serve(params, route, on=False)
    toks_on, _, _, spans_on = _serve(params, route, on=True)
    assert spans_off == []
    assert spans_on
    assert toks_on == toks_off


def test_off_reads_no_clock(monkeypatch):
    reads = []
    monkeypatch.setattr(tracing, "now_ns", lambda: reads.append(1) or 0)
    with tracing.span("fwd.layer", i=3) as s:
        assert s is tracing.span("other")
    tracing.record("admit.wait", 1, 2)
    assert tracing.current() is None
    assert reads == [] and tracing.take() == []


@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_layers_nest_under_the_lane_and_the_engine(params, route):
    _, _, _, spans = _serve(params, route, on=True)
    ids = _by_id(spans)
    issues = [s for s in spans if s.name == "opq.issue"]
    assert issues
    layers = {s.span_id: 0 for s in issues}
    for s in spans:
        if s.name == "fwd.layer":
            issue = _ancestor(s, ids, "opq.")
            assert issue.name == "opq.issue"
            assert issue.start_ns <= s.start_ns <= s.end_ns <= issue.end_ns
            layers[issue.span_id] += 1
            assert {c.name for c in spans if c.parent_id == s.span_id} == {"fwd.attn",
                                                                          "fwd.ffn"}
    for issue in issues:
        run = ids[issue.parent_id]
        assert run.name == "opq.run" and run.attrs["flags"]
        assert _ancestor(run, ids, "engine.").name in ("engine.decode", "engine.admit")
        assert run.thread_id != ids[run.parent_id].thread_id
        # every layer of the stack, once per piece of a chunked scan
        assert layers[issue.span_id] and layers[issue.span_id] % CFG.n_layers == 0
        if not run.attrs["flags"].startswith("prefill_chunked"):
            assert layers[issue.span_id] == CFG.n_layers
    names = {s.name for s in spans}
    assert {"engine.step", "admit.plan", "admit.wait", "admit.write", "admit.emit",
            "decode.inputs", "decode.wait", "decode.emit", "fwd.embed", "fwd.head",
            "fwd.sample"} <= names
    assert not any(n.startswith("opq:") for n in names)


def test_request_spans_tile_submit_to_finish(params):
    _, reqs, _, spans = _serve(params, "paged_kernel", on=True)
    for r in reqs:
        mine = {s.name: s for s in spans if s.attrs.get("req") == r.id}
        assert set(mine) == {"request.queue", "request.prefill", "request.decode"}
        q, p, d = mine["request.queue"], mine["request.prefill"], mine["request.decode"]
        assert q.parent_id is p.parent_id is d.parent_id is None
        assert q.start_ns == tracing.ns(r.metrics.arrival_s)
        assert q.end_ns == p.start_ns and p.end_ns == d.start_ns
        assert d.end_ns == tracing.ns(r.metrics.finish_s)
        assert q.start_ns <= q.end_ns <= p.end_ns <= d.end_ns


@pytest.mark.parametrize("route", ["paged_kernel", "chunked"])
def test_admission_counters_are_their_spans(params, route):
    _, _, m, spans = _serve(params, route, on=True)
    for name, total in (("admit.wait", m.prefill_wait_s), ("admit.write", m.seed_write_s)):
        durations = [s.end_ns - s.start_ns for s in spans if s.name == name]
        assert len(durations) == m.prefill_batches
        assert abs(sum(durations) / 1e9 - total) < 1e-6


def test_a_profiler_session_turns_the_recorder_on():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("engine.step"):
            tracing.record("admit.wait", 5, 7)
    with tracing.span("engine.step"):
        pass
    got = tracing.take()
    assert [s.name for s in got] == ["admit.wait", "engine.step"]
    assert got[0].parent_id == got[1].span_id


def test_chrome_export_has_one_event_per_span(params, tmp_path):
    _, _, _, spans = _serve(params, "paged_kernel", on=True)
    path = tmp_path / "trace.json"
    tracing.write_chrome_trace(str(path), spans)
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == len(spans)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert sorted(e["args"]["span_id"] for e in events) == sorted(s.span_id for s in spans)


def test_serve_cli_writes_the_run_as_a_chrome_trace(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "serve.json"
    reqs, _ = serve.run(["--smoke", "--device", "cpu", "--quantize", "serve",
                         "--cache-backend", "paged", "--paged-native", "--paged-kernel",
                         "--requests", "3", "--prompt-len", "8", "--gen", "8",
                         "--slots", "2", "--trace", str(path)])
    events = json.loads(path.read_text())["traceEvents"]
    assert f"{len(events)} spans -> {path}" in capsys.readouterr().out
    names = [e["name"] for e in events]
    assert names.count("fwd.layer") % CFG.n_layers == 0 and "engine.step" in names
    assert {e["args"]["req"] for e in events if e["name"] == "request.decode"} == {
        r.id for r in reqs}
    assert not tracing.enabled()
