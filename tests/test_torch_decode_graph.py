"""The block-native decode step replayed as one CUDA graph
(repro_torch/models/decode_graph.py).

On the CPU: which steps take the graph (the family and the device decide,
no option does), that the CPU's step is the eager one with the eager
results and no replay counted, the engine's two graph counters, and the
``fwd.graph`` span as the benchmark's span readers label it. On a card
(tests marked ``cuda``, skipped here with a reason): the replayed step
against the eager one, bit for bit in tokens, logprobs, every pool cell
and the index after every engine step, through three admission waves with
retirements, slot reuse, a sampled request and a preemption; a backup
re-issue of a replayed step; the kernels' launch counts; one recapture
after the pool moves."""

import dataclasses
import inspect
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import decode_graph as DG
from repro_torch.models import steps as ST
from repro_torch.models.model import init_model_quantized
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.sampling import SamplingParams
from repro_torch.tracing import Span

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import progspans, spec  # noqa: E402
from portbench.loop import Record  # noqa: E402
from portbench.model import Model  # noqa: E402

SMOKE = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
PAGED = dict(cache_backend="paged", paged_native=True, block_size=8)


# ------------------------------------------------------------ the CPU's side

@pytest.mark.parametrize("arch,replace,device,takes", [
    ("tinyllama-1.1b", {}, "cuda", True),
    ("tinyllama-1.1b", {"kv_cache_dtype": "int8"}, "cuda", True),
    ("qwen3-14b", {}, "cuda", True),
    ("qwen2-vl-2b", {}, "cuda", True),
    ("deepseek-moe-16b", {}, "cuda", False),    # MoE is not in GRAPH_FAMILIES
    ("tinyllama-1.1b", {}, "cpu", False),
    ("tinyllama-1.1b", {}, "meta", False),
    ("deepseek-moe-16b", {}, "cpu", False),
])
def test_the_family_and_the_device_decide(arch, replace, device, takes):
    cfg = get_config(arch).replace(**replace)
    assert DG.engages(cfg, torch.device(device)) is takes


@pytest.mark.parametrize("use_kernel", [True, False])
def test_both_paged_routes_are_graphed_steps(use_kernel):
    step = ST.make_paged_decode_step(SMOKE, use_kernel=use_kernel)
    assert isinstance(step, DG.GraphedDecodeStep)
    assert (step.captures, step.replays) == (0, 0)


def test_no_option_selects_the_graph():
    assert not [f.name for f in dataclasses.fields(EngineConfig) if "graph" in f.name]
    assert list(inspect.signature(DG.engages).parameters) == ["cfg", "device"]
    source = inspect.getsource(DG)
    assert "environ" not in source and "getenv" not in source
    assert "arch" not in inspect.getsource(DG.engages).split('"""')[-1]


@pytest.fixture(scope="module")
def smoke_params():
    return init_model_quantized(SMOKE, torch.Generator().manual_seed(0), quant_predicate)


def _engine(params, device="cpu", cfg=SMOKE, **kw):
    ecfg = dict(max_slots=3, max_seq_len=48, **PAGED, paged_kernel=True)
    ecfg.update(kw)
    return Engine(cfg, params, EngineConfig(**ecfg), device=device)


def test_the_cpu_step_is_the_eager_step(smoke_params):
    eng = _engine(smoke_params)
    rng = np.random.default_rng(4)
    try:
        for n in (5, 11, 7):
            eng.submit(rng.integers(0, SMOKE.vocab, (n,), dtype=np.int32), 6,
                       sampling=SamplingParams(temperature=0.7, seed=n), want_logprobs=2)
        eng.step()
        eng.step()
        toks, active = eng.scheduler.decode_batch()
        smp = eng._sampling_batch().to_device("cpu")
        args = (torch.from_numpy(toks), smp, torch.from_numpy(active))
        cache = eng.store.decode_cache()
        pools = {n: cache[n].clone() for n in ("k", "v")}
        got = eng._decode(smoke_params, cache, *args)
        after = {n: cache[n].clone() for n in ("k", "v")}
        for n in ("k", "v"):
            cache[n].copy_(pools[n])
        want = eng._decode.body(smoke_params, cache, *args)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1]["index"], want[1]["index"])
        assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])
        assert all(torch.equal(after[n], cache[n]) for n in ("k", "v"))
        eng.run_until_complete()
    finally:
        eng.close()
    assert eng.metrics.decode_steps > 0
    assert (eng.metrics.decode_graph_captures, eng.metrics.decode_graph_replays) == (0, 0)


def test_the_engine_reports_its_graph_counters(smoke_params):
    summary = EngineMetrics().summary()
    assert summary["decode_graph_captures"] == 0 and summary["decode_graph_replays"] == 0
    eng = _engine(smoke_params)
    try:
        eng.submit(np.arange(1, 6, dtype=np.int32), 3)
        eng.run_until_complete()
        stats = eng.stats()
    finally:
        eng.close()
    assert stats["decode_graph_replays"] == 0 and stats["decode_graph_captures"] == 0
    assert stats["decode_steps"] == 2


MS = 1_000_000


def test_a_replay_span_under_the_issue_is_issue_idle():
    """A decode instruction whose issue replays a graph: an idle gap under
    ``fwd.graph`` is labelled by it, and counts as idle under the host's
    issue (the benchmark's ``issue_idle_share``)."""
    spans = [Span("opq.run", 1_100 * MS, 1_300 * MS, 1, None, 1, {"flags": "decode"}),
             Span("opq.issue", 1_101 * MS, 1_120 * MS, 2, 1, 1, {}),
             Span("fwd.graph", 1_102 * MS, 1_119 * MS, 3, 2, 1,
                  {"captured_launches": 321, "capture": 0}),
             Span("opq.sync", 1_120 * MS, 1_300 * MS, 4, 1, 1, {})]
    ops = [(1_000 * MS, 1_105 * MS), (1_115 * MS, 2_000 * MS)]
    model = Model(family="dense", n_layers=1, d_model=8, n_heads=1, n_kv=1, head_dim=8,
                  vocab=16, d_ff=8)
    rec = Record(model=model, t0=1.0, seconds=1.0, t_stop=2.0)
    rec.trace = types.SimpleNamespace(ops=[("k", a, b) for a, b in ops], offset_ns=0,
                                      window_s=1.0, program_spans=spans)
    assert dict(progspans.idle_by_span(rec)) == {"fwd.graph": pytest.approx(0.01)}
    assert spec.reader("metrics", "issue_idle_share")(rec) == pytest.approx(1.0)


# ------------------------------------------------------------------ the card

WAVES = [[(5, 6), (17, 12), (30, 20), (9, 8)], [(12, 10), (3, 14), (25, 6)],
         [(8, 9), (20, 7), (14, 11)]]
CARD_CASES = {
    "qwen3-14b": ("qwen3-14b", {}, True),
    "tinyllama-1.1b": ("tinyllama-1.1b", {}, True),
    "tinyllama-1.1b-int8kv": ("tinyllama-1.1b", {"kv_cache_dtype": "int8"}, False),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode here")
    return torch.device("cuda")


def _card_model(arch, replace):
    """``arch`` at its full widths and two layers, W8A8, on the card."""
    cfg = get_config(arch).replace(n_layers=2, quantize="serve", **replace)
    gen = torch.Generator(device="cuda").manual_seed(1)
    return cfg, init_model_quantized(cfg, gen, quant_predicate, device="cuda")


def _serve(cfg, params, kernel, move_pool_at=None):
    """Three admission waves through a four-slot engine: a sampled request
    with logprobs in the first, a preemption at step 3, the later waves
    admitted as slots retire. Returns the token streams and logprobs, the
    index and pool after every step, the launches and the engine's
    metrics. ``move_pool_at``: the step before which the pool is moved."""
    eng = Engine(cfg, params, EngineConfig(max_slots=4, max_seq_len=64, cache_backend="paged",
                                           block_size=16, paged_native=True,
                                           paged_kernel=kernel), device="cuda")
    rng = np.random.default_rng(9)
    waves = [[rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n, _ in w] for w in WAVES]
    for c in DG.COUNTERS:
        c.launches = 0
    reqs, states, steps = [], [], 0
    try:
        for w, (prompts, sizes) in enumerate(zip(waves, WAVES)):
            for i, (p, (_, gen)) in enumerate(zip(prompts, sizes)):
                sampling = SamplingParams(temperature=0.8, top_k=40, seed=7) if w == i == 0 else None
                reqs.append(eng.submit(p, gen, sampling=sampling, want_logprobs=3))
            for _ in range(4 if w < 2 else 200):
                if not eng.has_work():
                    break
                if steps == move_pool_at:
                    eng.store.cache = dict(eng.store.cache, **{
                        n: t.clone() for n, t in eng.store.cache.items() if n in ("k", "v")})
                eng.step()
                steps += 1
                if steps == 3:
                    eng.preempt(reqs[2].id)
                cache = eng.store.cache
                states.append({n: t.clone() for n, t in cache.items() if n != "tables"})
    finally:
        eng.close()
    torch.cuda.synchronize()
    return ([(r.tokens, r.logprobs, r.top_logprobs) for r in reqs], states,
            {c.__name__: c.launches for c in DG.COUNTERS}, eng.metrics)


def _eager(monkeypatch):
    monkeypatch.setattr(DG, "engages", lambda cfg, device: False)


def _same_states(a, b):
    assert len(a) == len(b)
    for step, (x, y) in enumerate(zip(a, b)):
        for n in x:
            assert torch.equal(x[n], y[n]), f"{n} differs after step {step + 1}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_the_replayed_step_is_the_eager_step_bit_for_bit(cuda_device, case, monkeypatch):
    arch, replace, kernel = CARD_CASES[case]
    cfg, params = _card_model(arch, replace)
    streams, states, launches, m = _serve(cfg, params, kernel)
    with monkeypatch.context() as mp:
        _eager(mp)
        e_streams, e_states, e_launches, e_m = _serve(cfg, params, kernel)
    assert streams == e_streams
    _same_states(states, e_states)
    assert launches == e_launches and launches["qgemm"] > 0
    assert launches["paged_decode_attention"] == (e_launches["paged_decode_attention"]
                                                  if kernel else 0)
    # one graph for steps with a sampled row, one for greedy steps
    assert (m.decode_graph_captures, m.decode_graph_replays) == (2, m.decode_steps)
    assert (e_m.decode_graph_captures, e_m.decode_graph_replays) == (0, 0)
    assert m.preempted == 1 and m.completed == sum(map(len, WAVES)) - 1


@pytest.mark.cuda
def test_a_backup_reissue_of_a_replay_changes_nothing(cuda_device):
    cfg, params = _card_model("tinyllama-1.1b", {})
    eng = Engine(cfg, params, EngineConfig(max_slots=4, max_seq_len=64, cache_backend="paged",
                                           block_size=16, paged_native=True, paged_kernel=True),
                 device="cuda")
    rng = np.random.default_rng(2)
    try:
        for n in (7, 19, 4):
            eng.submit(rng.integers(0, cfg.vocab, (n,), dtype=np.int32), 12)
        for _ in range(3):
            eng.step()
        toks, active = eng.scheduler.decode_batch()
        args = (torch.from_numpy(toks).cuda(), eng._sampling_batch().to_device("cuda"),
                torch.from_numpy(active).cuda())
        cache = eng.store.decode_cache()
        index = cache["index"].clone()
        first = eng._decode(params, cache, *args)
        pools = {n: cache[n].clone() for n in ("k", "v")}
        second = eng._decode(params, cache, *args)
        torch.cuda.synchronize()
    finally:
        eng.close()
    assert eng._decode.replays == 5 and eng._decode.captures == 1
    assert torch.equal(cache["index"], index)                # the input index is never written
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1]["index"], second[1]["index"])
    assert torch.equal(first[1]["index"], index + 1)
    assert first[1]["index"].data_ptr() != second[1]["index"].data_ptr()
    assert all(torch.equal(first[2][k], second[2][k]) for k in first[2])
    assert all(torch.equal(pools[n], cache[n]) for n in ("k", "v"))


@pytest.mark.cuda
def test_a_moved_pool_is_captured_again_once(cuda_device, monkeypatch):
    cfg, params = _card_model("tinyllama-1.1b", {})
    # the sampled request has retired by step 6: the greedy graph is in use
    streams, states, launches, m = _serve(cfg, params, True, move_pool_at=10)
    with monkeypatch.context() as mp:
        _eager(mp)
        e_streams, e_states, e_launches, _ = _serve(cfg, params, True)
    assert streams == e_streams and launches == e_launches
    _same_states(states, e_states)
    # the sampled and greedy graphs, and the graph of the moved pool
    assert (m.decode_graph_captures, m.decode_graph_replays) == (3, m.decode_steps)
