"""The traffic generator: seeded, within its ranges, every round covering
the distributions once, every seed sending the same sizes in the same
order with its own token ids."""

import numpy as np
import pbtest  # noqa: F401  (import path)

from portbench import spec
from portbench.traffic import Traffic, stratified, warmup_lengths

SEED = 3_000_000_019


def _mix():
    return spec.load_json(spec.BENCH / "traffic" / "chat.json")


def _sent(t, rounds):
    """Each client's first ``rounds`` sizes, in the order it sends them."""
    return [[t.sizes(t.key(c, j)) for j in range(rounds)] for c in range(t.clients)]


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
        for k in range(3 * t.clients):
            prompt, budget = t.request(k)
            assert mix["prompt_len"]["lo"] <= len(prompt) <= mix["prompt_len"]["hi"]
            assert mix["output_len"]["lo"] <= budget <= mix["output_len"]["hi"]
            assert prompt.dtype == np.int32 and 0 <= prompt.min() and prompt.max() < vocab


def test_each_block_covers_every_stratum_once():
    """Each round (one request of every client) holds one size inside each
    of ``clients`` equally likely strata of both distributions."""
    mix = _mix()
    t = Traffic(mix, 1000, SEED)
    n = t.clients
    edges = {key: stratified(mix[key], np.arange(n + 1) / n)
             for key in ("prompt_len", "output_len")}
    for j in range(3):
        sizes = np.array([t.sizes(t.key(c, j)) for c in range(n)])
        for col, key in enumerate(("prompt_len", "output_len")):
            got = np.sort(sizes[:, col])
            assert np.all(edges[key][:-1] <= got) and np.all(got <= edges[key][1:])
    keys = {t.key(c, j) for c in range(n) for j in range(3)}
    assert keys == set(range(3 * n))


def test_seeds_draw_their_own_sizes_and_orders():
    """Seeds draw their own token ids, and no sizes or orders of their own:
    every seed's clients send the same sizes in the same order, whatever
    was asked before."""
    mix = _mix()
    ts = [Traffic(mix, 1000, seed) for seed in (SEED, 2**31 + 11, 7)]
    sent = [_sent(t, 3) for t in ts]
    assert sent[0] == sent[1] == sent[2]
    assert len({s for seq in sent[0] for s in seq}) > mix["clients"]
    t = Traffic(mix, 1000, 7)
    assert [t.sizes(t.key(c, j)) for c in reversed(range(t.clients))
            for j in reversed(range(3))] == [x for seq in sent[2][::-1] for x in seq[::-1]]
    ids = [t.request(t.key(5, 1))[0] for t in ts]
    assert len(ids[0]) == len(ids[1]) and not np.array_equal(ids[0], ids[1])


def test_block_totals_move_little_between_seeds():
    """Every seed's rounds hold the same sizes: the work does not move."""
    mix = _mix()
    n = mix["clients"]
    totals = np.array([[sum(sum(t.sizes(t.key(c, j))) for c in range(n)) for j in range(4)]
                       for t in (Traffic(mix, 1000, seed) for seed in range(8))])
    assert np.all(totals == totals[0])
    ramps = {tuple(sorted(Traffic(mix, 1000, seed).ramp_request(k)[1] for k in range(n)))
             for seed in range(4)}
    assert len(ramps) == 1


def test_lengths_follow_the_published_medians_with_a_tail():
    mix = _mix()
    t = Traffic(mix, 1000, SEED)
    sizes = np.array([t.sizes(k) for k in range(40 * t.clients)])
    for col, key in enumerate(("prompt_len", "output_len")):
        d = mix[key]
        assert abs(np.median(sizes[:, col]) / d["median"] - 1) < 0.1
        assert sizes[:, col].max() > 2.5 * d["median"]


def test_ramp_requests_cut_budgets_to_spread_shares():
    mix = _mix()
    t = Traffic(mix, 1000, SEED)
    cuts = []
    for c in range(t.clients):
        prompt, budget = t.ramp_request(t.key(c, 0))
        full_prompt, full_budget = t.request(t.key(c, 0))
        assert np.array_equal(prompt, full_prompt)
        assert 1 <= budget <= full_budget
        cuts.append(budget / full_budget)
    assert min(cuts) < 0.2 and max(cuts) > 0.8


def test_warmup_lengths_cover_each_reachable_bucket_once():
    assert warmup_lengths([16, 32, 64, 128], 10, 100) == [16, 32, 64, 100]
    assert warmup_lengths([16, 32, 64, 128], 20, 40) == [32, 40]
