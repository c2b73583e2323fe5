"""The traffic generator: seeded, within its ranges, every block covering
the distributions once, the sizes drawn anew for every seed."""

import numpy as np
import pbtest  # noqa: F401  (import path)

from portbench import spec
from portbench.traffic import Traffic, stratified, warmup_lengths

SEED = 3_000_000_019


def _mix():
    return spec.load_json(spec.BENCH / "traffic" / "chat.json")


def test_requests_repeat_from_the_seed():
    a, b = Traffic(_mix(), 151936, SEED), Traffic(_mix(), 151936, SEED)
    for k in (0, 1, 17, 200):
        pa, oa = a.request(k)
        pb, ob = b.request(k)
        assert oa == ob and np.array_equal(pa, pb)
    other = Traffic(_mix(), 151936, SEED + 1)
    assert not np.array_equal(a.request(0)[0][:64], other.request(0)[0][:64])


def test_sizes_and_ids_keep_their_ranges():
    mix = _mix()
    for vocab in (151936, 1000):
        t = Traffic(mix, vocab, SEED)
        for k in range(3 * t.block):
            prompt, budget = t.request(k)
            assert mix["prompt_len"]["lo"] <= len(prompt) <= mix["prompt_len"]["hi"]
            assert mix["output_len"]["lo"] <= budget <= mix["output_len"]["hi"]
            assert prompt.dtype == np.int32 and 0 <= prompt.min() and prompt.max() < vocab


def test_each_block_covers_every_stratum_once():
    mix = _mix()
    t = Traffic(mix, 1000, SEED)
    n = t.block
    edges = {key: stratified(mix[key], np.arange(n + 1) / n)
             for key in ("prompt_len", "output_len")}
    for b in range(3):
        sizes = np.array([t.sizes(b * n + i) for i in range(n)])
        for col, key in enumerate(("prompt_len", "output_len")):
            got = np.sort(sizes[:, col])
            assert np.all(edges[key][:-1] <= got) and np.all(got <= edges[key][1:])


def test_seeds_draw_their_own_sizes_and_orders():
    mix = _mix()
    seqs = [[Traffic(mix, 1000, seed).sizes(k) for k in range(64)]
            for seed in (SEED, 2**31 + 11, 7)]
    assert seqs[0] != seqs[1] and seqs[1] != seqs[2]
    # the same seed draws the same sizes, whatever was asked before
    t = Traffic(mix, 1000, 7)
    assert [t.sizes(k) for k in reversed(range(64))] == seqs[2][::-1]


def test_block_totals_move_little_between_seeds():
    mix = _mix()
    n = mix["block"]
    totals = np.array([[sum(sum(Traffic(mix, 1000, seed).sizes(b * n + i)) for i in range(n))
                        for b in range(4)] for seed in range(8)])
    spread = totals.std(axis=0) / totals.mean(axis=0)
    assert spread.max() < 0.08


def test_lengths_follow_the_published_medians_with_a_tail():
    mix = _mix()
    t = Traffic(mix, 1000, SEED)
    sizes = np.array([t.sizes(k) for k in range(40 * t.block)])
    for col, key in enumerate(("prompt_len", "output_len")):
        d = mix[key]
        assert abs(np.median(sizes[:, col]) / d["median"] - 1) < 0.1
        assert sizes[:, col].max() > 2.5 * d["median"]


def test_ramp_requests_cut_budgets_to_spread_shares():
    mix = _mix()
    t = Traffic(mix, 1000, SEED)
    cuts = []
    for c in range(t.clients):
        prompt, budget = t.ramp_request(c, c)
        full_prompt, full_budget = t.request(c)
        assert np.array_equal(prompt, full_prompt)
        assert 1 <= budget <= full_budget
        cuts.append(budget / full_budget)
    assert min(cuts) < 0.2 and max(cuts) > 0.8


def test_warmup_lengths_cover_each_reachable_bucket_once():
    assert warmup_lengths([16, 32, 64, 128], 10, 100) == [16, 32, 64, 100]
    assert warmup_lengths([16, 32, 64, 128], 20, 40) == [32, 40]
