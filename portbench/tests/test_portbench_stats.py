"""Rate and tail arithmetic on synthetic records, and that a stall inside
the window shows in both."""

import math
import time
import types

import pbtest  # noqa: F401  (import path)

from portbench import spec, stats
from portbench.loop import Loop, Record, Served, Step
from portbench.traffic import Traffic
from portbench.model import Model

M = Model(family="dense", n_layers=1, d_model=8, n_heads=1, n_kv=1, head_dim=8, vocab=16, d_ff=8)


def _record(durations):
    """Four clients, one token each at the end of every step; the steps
    take ``durations`` seconds, the window is all of them."""
    rec = Record(model=M, t0=0.0)
    times, t = [], 0.0
    for d in durations:
        rec.steps.append(Step(start=t, end=t + d, tokens=4, prefills=[], contexts=[10] * 4))
        t += d
        times.append(t)
    rec.t_stop = rec.seconds = t
    for c in range(4):
        rec.served.append(Served(k=c, client=c, prompt_len=10, budget=len(times), due=0.0,
                                 stamps=list(times)))
    return rec


STEADY = [0.1] * 100


def test_nearest_rank():
    v = list(range(1, 101))
    assert stats.nearest_rank(v, 90) == 90
    assert stats.nearest_rank(v, 95) == 95
    assert stats.nearest_rank([5.0], 95) == 5.0
    assert stats.nearest_rank([], 50) is None
    assert stats.nearest_rank([1.0, math.inf], 90) == math.inf


def test_rate_and_tails_of_a_steady_record():
    rec = _record(STEADY)
    assert abs(stats.output_tok_s(rec) - 40.0) < 1e-6
    assert abs(stats.nearest_rank(stats.itls_s(rec), 95) - 0.1) < 1e-9
    assert abs(spec.reader("metrics", "itl_p95_ms.sat")(rec) - 100.0) < 1e-6
    assert abs(spec.reader("metrics", "ttft_p90_ms.host")(rec) - 100.0) < 1e-6


def test_a_stall_moves_the_rate_and_the_tail():
    one_stall = STEADY[:50] + [2.0] + STEADY[51:]
    assert stats.output_tok_s(_record(one_stall)) < 0.9 * stats.output_tok_s(_record(STEADY))
    # one stalled gap in a hundred does not reach the 95th percentile ...
    assert abs(stats.nearest_rank(stats.itls_s(_record(one_stall)), 95) - 0.1) < 1e-9
    # ... a stall every tenth step does
    every_tenth = [1.0 if i % 10 == 9 else 0.1 for i in range(100)]
    assert abs(stats.nearest_rank(stats.itls_s(_record(every_tenth)), 95) - 1.0) < 1e-9


def test_the_step_across_the_end_counts_in_proportion():
    rec = _record([1.0] * 9 + [4.0])         # the last step crosses t0 + 10
    rec.seconds = 10.0
    assert abs(stats.output_tok_s(rec) - (9 * 4 + 4 * 0.25) / 10.0) < 1e-9
    rec.steps[-1].start, rec.steps[-1].end = 10.0, 14.0
    rec.steps.insert(-1, rec.steps[0].__class__(start=9.0, end=10.0, tokens=4, prefills=[],
                                                contexts=[]))
    assert abs(stats.output_tok_s(rec) - 40 / 10.0) < 1e-9


def test_ttft_runs_from_due_and_a_failed_request_is_missing():
    rec = _record(STEADY)
    rec.served.append(Served(k=9, client=0, prompt_len=4, budget=2, due=2.0,
                             stamps=[2.5, 2.6]))
    rec.served.append(Served(k=10, client=1, prompt_len=4, budget=2, due=3.0, failed=True))
    ttfts = stats.ttfts_s(rec)
    assert 0.5 in [round(x, 9) for x in ttfts]
    assert math.inf in ttfts
    # a request due after the window closed is not an arrival
    rec.served.append(Served(k=11, client=2, prompt_len=4, budget=2, due=rec.t_stop,
                             stamps=[rec.t_stop + 1]))
    assert len(rec.arrivals()) == 6


class _Engine:
    """Stands in for the port's engine: every live request gets one token a
    step, and a step lasts ``pause`` seconds more for each request it
    admits, as the card's admissions do."""

    def __init__(self, pause):
        self.pause, self.live, self.waiting = pause, [], []
        self.scheduler = types.SimpleNamespace(buckets=())
        self.store = types.SimpleNamespace(memory_stats=dict)
        self.metrics = types.SimpleNamespace(decode_steps=0, steps=0, occupancy_sum=0,
                                             prefill_wait_s=0.0, prefill_tokens=0)

    def submit(self, prompt, max_new_tokens):
        req = types.SimpleNamespace(prompt=prompt, tokens=[], done=False, n=max_new_tokens)
        self.waiting.append(req)
        return req

    def step(self):
        time.sleep(self.pause * len(self.waiting))
        self.live += self.waiting
        self.waiting = []
        for r in self.live:
            r.tokens.append(1)
            r.done = len(r.tokens) >= r.n
        self.live = [r for r in self.live if not r.done]


def _window(pause, work_tokens):
    mix = dict(spec.load_json(spec.BENCH / "traffic" / "chat.json"), clients=4, ramp_wave=4,
               prompt_len={"dist": "lognormal", "median": 20, "sigma": 0.5, "lo": 8, "hi": 40},
               output_len={"dist": "lognormal", "median": 8, "sigma": 0.4, "lo": 4, "hi": 12})
    rec = Loop(_Engine(pause), Traffic(mix, 1000, 7), M).run(0.05, work_tokens=work_tokens)
    return rec, [st.tokens for st in rec.steps]


def test_a_window_closes_on_its_work():
    """A window sized by its work runs the same steps whatever the speed,
    and its rate takes all of its tokens over all of its time; the CAP
    closes one whose work does not come."""
    fast, fast_steps = _window(0.0, 40)
    slow, slow_steps = _window(0.002, 40)
    assert fast_steps == slow_steps and sum(fast_steps) >= 40 > sum(fast_steps[:-1])
    for rec in (fast, slow):
        assert rec.seconds == rec.window_s
        assert abs(stats.output_tok_s(rec) - sum(slow_steps) / rec.window_s) < 1e-9
    capped, _ = _window(0.0, 10 ** 9)
    assert 0.15 <= capped.window_s < 0.3 and capped.seconds == capped.window_s
