"""The comparison that decides ``correct``, on the CPU at the port's
reduced sizes, for every cell of ``BENCHMARK.json`` and every
configuration fixture (``pbtest.CASES``): the engine's served tokens pass
against the plain reference, the control (the int4 reference in the
program's place) fails the limits, and a run with the timed path broken
underneath comes out not correct, for each fault a serving cell can have
on one chip:

* a decode step that returns its state unchanged (its K/V writes undone);
* half of the batch left out (the second half of the rows given the first
  half's tokens);
* a token altered where it is produced (every third decode step).

The exchange between chips has no counterpart on one chip.

On the MoE fixture, a run judged by a reference with unrenormalised gates,
or with a leading dense layer, comes out not correct too: the comparison
tells apart the two published departures of DeepSeek-MoE from the port's
present block. Through the new reference dispatch, the dense reference's
logits are bitwise the ones it gave before the dispatch.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import pbtest

from portbench import check
from portbench.model import Model
from portbench.run import execute

SEED = 2_147_483_659
CPU = torch.device("cpu")


def _run(name, plant=None, seconds=2.0):
    cell = pbtest.smoke_cell(name)
    rec, _, checks = execute(cell, SEED, seconds, False, CPU, plant=plant)
    return cell, rec, checks


@pytest.mark.parametrize("name", pbtest.CASES)
def test_served_tokens_pass_and_the_control_fails(name):
    cell, rec, checks = _run(name)
    assert checks["served_tokens"]["value"] >= checks["served_tokens"]["min"] > 0
    assert check.passed(checks), checks
    samples = check.sample(rec, SEED)
    m = Model.from_config(cell.config)
    ref = check.reference_logits(cell.config, m, SEED, samples, CPU, bits=8)
    low = check.reference_logits(cell.config, m, SEED, samples, CPU, bits=4)
    read = check.READINGS
    ctl = check.control_gaps(ref, low)
    assert any(read[k](ctl) > v for k, v in cell.limits.items())
    # the program's own gaps sit well under the limits
    gaps = check.served_gaps(ref, samples)
    assert all(read[k](gaps) < v / 2 for k, v in cell.limits.items())


def _wrap_decode(eng, after):
    fn = eng._decode
    calls = [0]

    def broken(params, cache, tokens, *rest):
        out = after(fn, calls[0], params, cache, tokens, *rest)
        calls[0] += 1
        return out
    eng._decode = broken


def state_unchanged(eng):
    def after(fn, i, params, cache, tokens, *rest):
        saved = {k: cache[k].clone() for k in ("k", "v")}
        out = fn(params, cache, tokens, *rest)
        for k, v in saved.items():
            cache[k].copy_(v)
        return out
    _wrap_decode(eng, after)


def half_batch(eng):
    def after(fn, i, params, cache, tokens, *rest):
        tok, *more = fn(params, cache, tokens, *rest)
        tok = tok.clone()
        half = tok.shape[0] // 2
        tok[half:2 * half] = tok[:half]
        return (tok, *more)
    _wrap_decode(eng, after)


def altered_token(eng):
    vocab = eng.cfg.vocab

    def after(fn, i, params, cache, tokens, *rest):
        tok, *more = fn(params, cache, tokens, *rest)
        if i % 3 == 2:
            tok = (tok + 1) % vocab
        return (tok, *more)
    _wrap_decode(eng, after)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, altered_token],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", pbtest.CASES)
def test_a_broken_timed_path_is_not_correct(name, fault):
    _, _, checks = _run(name, plant=fault)
    assert not check.passed(checks), checks


@pytest.mark.parametrize("departure", [{"norm_topk_prob": False}, {"first_k_dense": 1}],
                         ids=["unrenormalised_gates", "a_leading_dense_layer"])
def test_a_reference_with_a_published_departure_finds_the_run_not_correct(departure):
    # the port serves renormalised gates and no dense layer; the reference
    # read with either published value must not take its tokens
    cell, rec, checks = _run("moe-smoke")
    assert check.passed(checks), checks
    m = dataclasses.replace(Model.from_config(cell.config), **departure)
    assert not check.passed(check.judge(cell.config, m, SEED, rec, cell.limits, CPU))


# the dense reference's logits before the dispatch (sha256 of the f32
# bytes, int8 and int4 weights) at the reduced qwen3-14b, on two sequences
DENSE_LOGITS_SHA256 = {
    8: "43d403b079c88755e80a3290f1fff63f7814a6a9f8a6a0c8690b4bb86985dbb6",
    4: "013d4c5f69239f9a297740f9150ce4a46014fcab8e120ad5775f0e3228769dac",
}


@pytest.mark.parametrize("bits", sorted(DENSE_LOGITS_SHA256))
def test_the_dense_reference_is_bitwise_the_one_before_the_dispatch(bits):
    c = pbtest.smoke_cell("qwen3-14b.chat").config
    assert check.reference(c).__name__ == "portbench.reference.decoder"
    m = Model.from_config(c)
    rng = np.random.default_rng(7)
    seqs = [torch.as_tensor(rng.integers(0, m.vocab, n), dtype=torch.int64) for n in (13, 29)]
    # the sequences teacher-forced, their last 5 and 7 positions scored
    samples = [(s[:len(s) - k + 1].numpy(), np.concatenate([s[len(s) - k + 1:].numpy(), [0]]))
               for s, k in zip(seqs, (5, 7))]
    out = check.reference_logits(c, m, SEED, samples, CPU, bits=bits)
    digest = hashlib.sha256(b"".join(o.contiguous().numpy().tobytes() for o in out))
    assert digest.hexdigest() == DENSE_LOGITS_SHA256[bits]


def test_the_reference_is_the_module_the_file_names():
    c = pbtest.fixture("moe-smoke")
    assert check.reference(c).__name__ == "portbench.reference.moe"
    for bad in ("portbench/check.py", "portbench/reference/../run.py", "/elsewhere/moe.py"):
        with pytest.raises(ValueError, match="not a module"):
            check.reference(dict(c, reference=bad))


def test_the_sample_holds_the_longest_request_and_repeats():
    _, rec, _ = _run("qwen3-14b.chat")
    a, b = check.sample(rec, SEED), check.sample(rec, SEED)
    assert [len(t) for _, t in a] == [len(t) for _, t in b]
    longest = max(len(s.req.tokens) for s in rec.served if s.finished is not None)
    assert len(a[0][1]) == longest
    assert sum(len(t) for _, t in a) >= min(check.SAMPLE_TOKENS, sum(
        len(s.req.tokens) for s in rec.served if s.finished is not None))
    assert all(np.array_equal(p1, p2) for (p1, _), (p2, _) in zip(a, b))
