"""Greedy speculative decode in the port (serving/engine.py
``_spec_decode_once``, the verify window of models/serve.py and
models/attention.py, the stores' ``swap_window`` and ``rollback``):

  * bit-identity — a speculative engine's streams equal plain decode's
    TOKEN FOR TOKEN and its retire-time cache rows BIT FOR BIT (the
    reference's SnapshotEngine pattern), W8A8 at the smoke size, on the
    contiguous store with a good draft (the target's weights: every
    proposal accepted) and a bad one (other weights: every window
    rejected), with int8 KV, through the paged gather bridge, block-native
    with a bad draft, and over a prefix-cache warm hit;
  * the reference — the port's speculative streams against the reference
    Engine's speculative streams (a subprocess, tests/_torch_parity.py's
    rule), and the OPQ flag counts equal;
  * stops — eos mid-window retires at the stop; the rejected-position
    scrub has teeth (forgetting it is caught by the cache-row check);
  * lockstep and conservation — the draft store tracks the target store's
    write position, and the paged census is conserved under random
    variable advancement;
  * dispatch audit, metrics and config validation.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import _torch_parity as P  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tensorizer as tz  # noqa: E402
from repro_torch.launch.serve import quant_predicate  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.model import init_model_quantized  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, PagedKVStore,  # noqa: E402
                                 SamplingParams, pristine_value)

CFG = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
RNG = np.random.default_rng(23)


def _make_params(seed):
    gen = torch.Generator().manual_seed(seed)
    return tz.quantize_params(init_model(CFG, gen), predicate=quant_predicate)


@pytest.fixture(scope="module")
def params():
    return _make_params(0)


@pytest.fixture(scope="module")
def bad_draft_params():
    """Other weights of the same arch: the draft disagrees with the target
    almost everywhere (every round advances each slot by 1)."""
    return _make_params(7)


def _spec_kw(draft_cfg=None, k=3):
    return dict(speculative=True, spec_k=k, draft=draft_cfg or CFG)


def _engine(cls, cfg, params, ecfg, draft_params=None):
    return cls(cfg, params, ecfg, device="cpu", draft_params=draft_params)


class SnapshotEngine(Engine):
    """An Engine that keeps each request's cache row AT RETIRE, before the
    reset scrubs it: positions up to the lease's extent (prompt + max_new;
    cells past it read the null block or unused row space)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rows = {}

    def _retire(self, slot):
        req = self.scheduler.active[slot]
        ext = len(req.prompt) + req.max_new_tokens
        view = self.store.gather_view()
        self.rows[req.id] = {
            n: (leaf[slot] if n == "index" else leaf[:, slot, :ext]).clone()
            for n, leaf in view.items()}
        super()._retire(slot)


def _assert_rows_equal(ra, rb):
    assert set(ra) == set(rb)
    for name in ra:
        assert torch.equal(ra[name], rb[name]), name


def _serve(eng, prompts, gens, stagger=0):
    reqs = []
    for p, g in zip(prompts, gens):
        reqs.append(eng.submit(p, g, strict=True))
        for _ in range(stagger):
            eng.step()
    eng.run_until_complete()
    return reqs, [list(r.tokens) for r in reqs]


def _traffic(lens=(6, 12, 9), gens=(6, 4, 5)):
    return [RNG.integers(0, CFG.vocab, (n,), dtype=np.int32) for n in lens], list(gens)


# ---------------------------------------------------------------------------
# bit-identity within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype,backend_kw,draft", [
    ("bfloat16", {}, "good"),
    ("bfloat16", {}, "bad"),
    ("int8", {}, "good"),
    ("bfloat16", dict(cache_backend="paged", block_size=8), "good"),
    ("int8", dict(cache_backend="paged", block_size=8), "bad"),
    ("bfloat16", dict(cache_backend="paged", block_size=8, paged_native=True), "bad"),
    ("bfloat16", dict(cache_backend="paged", block_size=8, paged_native=True), "good"),
], ids=["contig-good", "contig-bad", "int8-good", "paged-bridge-good",
        "int8-paged-bridge-bad", "paged-native-bad", "paged-native-good"])
def test_spec_matches_plain_tokens_and_cache_bits(kv_dtype, backend_kw, draft, params,
                                                  bad_draft_params):
    cfg = CFG.replace(kv_cache_dtype=kv_dtype)
    dparams = params if draft == "good" else bad_draft_params
    kw = dict(max_slots=2, max_seq_len=32, **backend_kw)
    prompts, gens = _traffic()

    plain = _engine(SnapshotEngine, cfg, params, EngineConfig(**kw))
    preqs, ptoks = _serve(plain, prompts, gens, stagger=1)
    plain.close()
    spec = _engine(SnapshotEngine, cfg, params, EngineConfig(**kw, **_spec_kw(cfg)), dparams)
    sreqs, stoks = _serve(spec, prompts, gens, stagger=1)
    spec.close()

    assert stoks == ptoks
    for pr, sr in zip(preqs, sreqs):
        _assert_rows_equal(plain.rows[pr.id], spec.rows[sr.id])
    decoded = sum(gens) - len(gens)
    if draft == "good":
        assert spec.metrics.decode_steps < decoded
        assert spec.metrics.accepted_tokens > 0
    else:
        assert spec.metrics.accepted_tokens == 0
        assert all(length == 1 for length in spec.metrics.accept_hist)


def test_good_draft_accepts_every_proposal_within_budget(params):
    """The target's own weights as the draft: each round emits the whole
    window (spec_k + 1 tokens) until the request's budget cuts the last
    round, so the accepted-length histogram is exactly the budget's."""
    k, gen = 3, 11
    prompts, _ = _traffic(lens=(7, 9), gens=(gen, gen))
    eng = _engine(Engine, CFG, params,
                  EngineConfig(max_slots=2, max_seq_len=32, **_spec_kw(k=k)), params)
    _serve(eng, prompts, [gen, gen])
    s = eng.stats()
    eng.close()
    full, rest = divmod(gen - 1, k + 1)
    want = Counter({k + 1: full * 2})
    if rest:
        want[rest] += 2
    assert s["accept_hist"] == dict(want)
    assert s["accepted_tokens"] == 2 * (gen - 1) - sum(want.values())


def test_spec_staggered_equals_sequential(params):
    prompts, gens = _traffic(lens=(6, 12, 9), gens=(7, 4, 6))
    kw = dict(max_slots=2, max_seq_len=32, **_spec_kw())
    seq = _engine(Engine, CFG, params, EngineConfig(**kw), params)
    solo = []
    for p, g in zip(prompts, gens):
        r = seq.submit(p, g, strict=True)
        seq.run_until_complete()
        solo.append(list(r.tokens))
    seq.close()
    stag = _engine(Engine, CFG, params, EngineConfig(**kw), params)
    _, stoks = _serve(stag, prompts, gens, stagger=1)
    stag.close()
    assert stoks == solo


def test_spec_prefix_cache_warm_hit_bit_identical(params):
    preamble = RNG.integers(0, CFG.vocab, (16,), dtype=np.int32)
    prompt = np.concatenate([preamble, RNG.integers(0, CFG.vocab, (4,), dtype=np.int32)])
    kw = dict(max_slots=2, max_seq_len=32, cache_backend="paged", block_size=8,
              prefix_cache=True)

    def serve_hit(ecfg, dparams=None):
        eng = _engine(SnapshotEngine, CFG, params, ecfg, dparams)
        eng.submit(preamble, 4, strict=True)                 # seeds the trie
        eng.run_until_complete()
        req = eng.submit(prompt, 8, strict=True)
        eng.run_until_complete()
        assert eng.stats()["prefix_hits"] >= 1
        row = eng.rows[req.id]
        eng.close()
        return list(req.tokens), row

    ptoks, prow = serve_hit(EngineConfig(**kw))
    stoks, srow = serve_hit(EngineConfig(**kw, **_spec_kw()), params)
    assert stoks == ptoks
    _assert_rows_equal(prow, srow)


def test_spec_lockstep_and_census_every_step(params):
    """Over the paged prefix-cache store: after every step the census
    partitions the pool, the draft store's write position equals the
    target's, and both equal the host's prompt + generated - 1."""
    ecfg = EngineConfig(max_slots=2, max_seq_len=32, cache_backend="paged", block_size=8,
                        prefix_cache=True, **_spec_kw())
    eng = _engine(Engine, CFG, params, ecfg, params)
    prompts, gens = _traffic(lens=(6, 11, 8), gens=(8, 5, 7))
    for p, g in zip(prompts, gens):
        eng.submit(p, g, strict=True)
    while eng.has_work():
        eng.step()
        _census_ok(eng.store)
        for slot, req in eng.scheduler.active.items():
            assert eng.draft_store.slot_index(slot) == eng.store.slot_index(slot) == (
                len(req.prompt) + req.metrics.n_generated - 1)
    assert eng.store.debug_block_census()["referenced"] == []
    eng.close()


# ---------------------------------------------------------------------------
# eos mid-window
# ---------------------------------------------------------------------------

def _pick_mid_window_eos(full, W=4):
    """A token whose first occurrence sits strictly inside an accepted
    window (stream index not a multiple of W)."""
    return next((i, int(t)) for i, t in enumerate(full)
                if 0 < i < len(full) - 1 and i % W != 0 and full.index(t) == i)


def _eos_runs(params, backend_kw, forget_scrub=False):
    prompt = RNG.integers(0, CFG.vocab, (8,), dtype=np.int32)
    kw = dict(max_slots=2, max_seq_len=32, **backend_kw)
    probe = _engine(Engine, CFG, params, EngineConfig(**kw))
    r = probe.submit(prompt, 10, strict=True)
    probe.run_until_complete()
    probe.close()
    full = list(r.tokens)
    stop, eos = _pick_mid_window_eos(full)
    plain = _engine(SnapshotEngine, CFG, params, EngineConfig(**kw, eos_id=eos))
    rp = plain.submit(prompt, 10, strict=True)
    plain.run_until_complete()
    plain.close()
    spec = _engine(SnapshotEngine, CFG, params,
                   EngineConfig(**kw, eos_id=eos, **_spec_kw()), params)
    if forget_scrub:
        forgot = spec.store.rollback

        def no_scrub(slots, new_index, positions):
            # indices advance, but every scrub position is the out-of-range pad
            forgot(slots, new_index, np.full_like(np.asarray(positions),
                                                  spec.ecfg.max_seq_len))
        spec.store.rollback = no_scrub
    rs = spec.submit(prompt, 10, strict=True)
    spec.run_until_complete()
    return full, stop, eos, plain, rp, spec, rs


BACKENDS = [{}, dict(cache_backend="paged", block_size=8, paged_native=True)]


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=["contig", "paged-native"])
def test_eos_mid_window_retires_at_stop(backend_kw, params):
    full, stop, eos, plain, rp, spec, rs = _eos_runs(params, backend_kw)
    assert list(rs.tokens) == list(rp.tokens) == full[:stop + 1]
    assert rs.tokens[-1] == eos and eos not in rs.tokens[:-1] and rs.finish_reason == "eos"
    assert spec.metrics.accept_hist.get(stop % 4, 0) >= 1
    _assert_rows_equal(plain.rows[rp.id], spec.rows[rs.id])
    if backend_kw:
        # every block but the null block is back to the pristine fill
        assert not spec.store._leased
        for name, leaf in spec.store.cache.items():
            if name not in ("index", "tables"):
                assert bool((leaf[:, 1:] == pristine_value(name)).all()), name
    spec.close()


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=["contig", "paged-native"])
def test_eos_overshoot_scrub_has_teeth(backend_kw, params):
    """Replay the would-be bug (rollback moves the indices but scrubs
    nothing): the retire-row comparison must catch the leaked draft K/V."""
    _, _, _, plain, rp, spec, rs = _eos_runs(params, backend_kw, forget_scrub=True)
    spec.close()
    with pytest.raises(AssertionError):
        _assert_rows_equal(plain.rows[rp.id], spec.rows[rs.id])


def test_stop_sequence_mid_window(params):
    """A stop sequence completing inside an accepted window truncates the
    round there, as on the plain engine."""
    prompt = RNG.integers(0, CFG.vocab, (8,), dtype=np.int32)
    kw = dict(max_slots=2, max_seq_len=32)
    probe = _engine(Engine, CFG, params, EngineConfig(**kw))
    full = probe.submit(prompt, 12, strict=True)
    probe.run_until_complete()
    probe.close()
    stop = (int(full.tokens[5]), int(full.tokens[6]))
    streams = []
    for ecfg, dparams in ((EngineConfig(**kw), None),
                          (EngineConfig(**kw, **_spec_kw()), params)):
        eng = _engine(Engine, CFG, params, ecfg, dparams)
        r = eng.submit(prompt, 12, sampling=SamplingParams(stop=[stop]), strict=True)
        eng.run_until_complete()
        streams.append((list(r.tokens), r.finish_reason, eng.stats()["stop_hits"]))
        eng.close()
    assert streams[0] == streams[1]
    assert streams[0][1] == "stop" and tuple(streams[0][0][-2:]) == stop


# ---------------------------------------------------------------------------
# conservation under variable advancement
# ---------------------------------------------------------------------------

def _census_ok(store):
    c = store.debug_block_census()
    everything = c["free"] + c["referenced"] + c["cached_unreferenced"]
    assert len(everything) == len(set(everything)), c
    assert sorted(everything) == list(range(1, store.n_blocks)), c
    leases = Counter(b for bs in store._leased.values() for b in bs)
    assert sorted(leases) == c["referenced"]
    for b, n in leases.items():
        assert store._ref[b] == n


@settings(deadline=None, max_examples=10)
@given(st.integers(min_value=0, max_value=1 << 30))
def test_block_conservation_under_variable_advancement(seed):
    """Random lease / speculative rollback / retire / drain sequences, with
    rollback plans whose scrub windows overshoot both the lease and the
    sequence bound: the census stays a partition after every operation, and
    each rollback leaves the slot's index where the plan put it."""
    rng = np.random.default_rng(seed)
    store = PagedKVStore(CFG, 3, 16, block_size=4, n_blocks=10, prefix_cache=True,
                         device="cpu")
    k = 3
    extents = {}
    _census_ok(store)
    for _ in range(60):
        op = int(rng.integers(0, 5))
        if op in (0, 3):
            slot = int(rng.integers(0, 3))
            if slot in store._leased:
                continue
            plen = int(rng.integers(1, 13))
            gen = int(rng.integers(1, 17 - plen))
            tokens = rng.integers(0, 3, (plen,), dtype=np.int32)
            if store.lease(slot, plen, gen, tokens=tokens):
                extents[slot] = (plen, plen + gen)
                if op == 0:
                    store.commit_prefix(slot)
        elif op == 1:
            leased = sorted(store._leased)
            if leased:
                s = int(rng.choice(leased))
                store.reset(s)
                extents.pop(s, None)
        elif op == 4:
            leased = sorted(store._leased)
            if not leased:
                continue
            slots = np.full((3,), 3, np.int64)
            new_index = np.zeros((3,), np.int64)
            scrub = np.full((3, k), 16, np.int64)
            for s in leased:
                plen, ext = extents[s]
                p = int(rng.integers(plen - 1, ext))
                emit = int(rng.integers(1, k + 2))
                slots[s] = s
                new_index[s] = min(p + emit, ext)
                scrub[s] = p + emit + np.arange(k)
            store.rollback(slots, new_index, scrub)
            for s in leased:
                assert store.slot_index(s) == new_index[s]
        else:
            for s in sorted(store._leased):
                store.reset(s)
            extents.clear()
        _census_ok(store)
    for s in sorted(store._leased):
        store.reset(s)
    _census_ok(store)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_rollback_scrubs_exactly_the_planned_cells(backend):
    """Rollback writes the pristine fill at each planned (slot, position)
    below max_seq_len and nowhere else, and sets only the planned slots'
    index; pads (slot n_slots, position max_seq_len) are dropped."""
    from repro_torch.serving import make_store
    cfg = CFG.replace(kv_cache_dtype="int8")
    store = make_store(cfg, 3, 16, backend=backend, block_size=4, device="cpu")
    for s in range(3):
        assert store.lease(s, 4, 12)
    for name, leaf in store.cache.items():
        if name not in ("index", "tables"):
            leaf.fill_(3)
    before = {n: t.clone() for n, t in store.gather_view().items()}
    store.rollback(np.array([1, 3, 0]), np.array([9, 5, 6]),
                   np.array([[9, 10, 16], [1, 2, 3], [6, 15, 16]]))
    view = store.gather_view()
    assert view["index"].tolist() == [6, 9, 0]
    for name, leaf in view.items():
        if name == "index":
            continue
        want = before[name].clone()
        for s, p in ((1, 9), (1, 10), (0, 6), (0, 15)):
            want[:, s, p] = pristine_value(name)
        assert torch.equal(leaf, want), name


# ---------------------------------------------------------------------------
# dispatch audit, metrics, validation
# ---------------------------------------------------------------------------

def test_spec_opq_flags_and_metrics_reconcile(params):
    kw = dict(max_slots=2, max_seq_len=32, **_spec_kw())
    eng = _engine(Engine, CFG, params, EngineConfig(**kw), params)
    prompts, gens = _traffic(lens=(6, 12), gens=(7, 5))
    reqs, _ = _serve(eng, prompts, gens)
    s = eng.stats()
    eng.close()
    flags = s["opq"]["flags"]
    assert set(flags) == {"prefill/16", "draft_prefill/16", "draft_decode", "verify"}
    assert flags["verify"] == s["decode_steps"] == s["spec_rounds"]
    assert flags["draft_decode"] == s["draft_steps"] == (eng.ecfg.spec_k + 1) * s["spec_rounds"]
    assert s["tokens_generated"] == sum(r.metrics.n_generated for r in reqs)
    decoded = s["tokens_generated"] - s["completed"]
    slot_rounds = sum(s["accept_hist"].values())
    assert decoded == s["accepted_tokens"] + slot_rounds
    assert s["proposed_tokens"] == eng.ecfg.spec_k * slot_rounds
    assert s["acceptance_rate"] == pytest.approx(s["accepted_tokens"] / s["proposed_tokens"])
    assert s["decode_steps"] < decoded


def test_plain_engine_flag_set_unchanged(params):
    eng = _engine(Engine, CFG, params, EngineConfig(max_slots=2, max_seq_len=32))
    prompts, gens = _traffic(lens=(6, 12), gens=(4, 4))
    _serve(eng, prompts, gens)
    flags = eng.stats()["opq"]["flags"]
    eng.close()
    assert set(flags) == {"prefill/16", "decode"}


def test_spec_config_validation(params):
    base = dict(max_slots=1, max_seq_len=32)

    def build(cfg=CFG, dparams=params, **kw):
        return _engine(Engine, cfg, params, EngineConfig(**{**base, **kw}), dparams)
    with pytest.raises(ValueError, match="draft model"):
        build(speculative=True, dparams=None)
    with pytest.raises(ValueError, match="speculative=False"):
        build(draft=CFG)
    with pytest.raises(ValueError, match="spec_k"):
        build(**_spec_kw(k=0))
    with pytest.raises(ValueError, match="vocab"):
        build(speculative=True, draft=CFG.replace(vocab=CFG.vocab * 2))
    with pytest.raises(ValueError, match="paged_kernel|kernel"):
        build(cache_backend="paged", paged_native=True, paged_kernel=True, **_spec_kw())
    # a recurrent (ssm or hybrid) target is the reference's refusal; an ssm
    # or hybrid draft is served; an embeds-input draft is refused
    with pytest.raises(ValueError, match="TARGET must be a dense-family arch, got ssm"):
        build(cfg=CFG.replace(family="ssm"), **_spec_kw())
    xlstm = get_config("xlstm-125m").smoke().replace(quantize="serve")
    build(dparams=init_model_quantized(xlstm, torch.Generator().manual_seed(1),
                                       quant_predicate, device="cpu"),
          **_spec_kw(xlstm)).close()
    with pytest.raises(ValueError, match="draft must be a token-input dense/moe/ssm/hybrid "
                                         "arch, got family=vlm input_mode=embeds"):
        build(**_spec_kw(get_config("qwen2-vl-2b").smoke()))
    with pytest.raises(ValueError, match="TARGET must be a dense-family arch, got hybrid"):
        build(cfg=CFG.replace(family="hybrid"), **_spec_kw())
    zamba = get_config("zamba2-7b").smoke().replace(quantize="serve")
    build(dparams=init_model_quantized(zamba, torch.Generator().manual_seed(1),
                                       quant_predicate, device="cpu"),
          **_spec_kw(zamba)).close()
    # a MoE target and a MoE draft are served (tests/test_torch_moe_engine.py)
    moe = get_config("deepseek-moe-16b").smoke().replace(vocab=CFG.vocab)
    build(**_spec_kw(moe)).close()
    eng = build(**_spec_kw())
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit([1, 2, 3], 4, sampling=SamplingParams(temperature=0.7))
    assert eng.submit([1, 2, 3], 4, sampling=SamplingParams(stop=[[5]])) is not None
    eng.close()


def test_cli_speculative_and_sampling_report(capsys):
    from repro_torch.launch import serve as tserve
    common = ["--smoke", "--device", "cpu", "--quantize", "serve", "--requests", "3",
              "--prompt-len", "8", "--gen", "8", "--slots", "2", "--stagger-steps", "2"]
    for backend in (["--cache-backend", "contiguous"],
                    ["--cache-backend", "paged", "--paged-native"]):
        reqs, stats = tserve.run(common + backend + ["--speculative", "--spec-k", "3"])
        out = capsys.readouterr().out
        assert "[serve] speculative: draft tinyllama-1.1b, k=3" in out
        assert "proposals accepted" in out and "accepted-length hist" in out
        assert stats["spec_rounds"] > 0 and all(len(r.tokens) == 8 for r in reqs)
    reqs, stats = tserve.run(common + ["--temperature", "0.8", "--top-k", "50",
                                       "--top-p", "0.9", "--stop", "5,6"])
    out = capsys.readouterr().out
    assert "[serve] sampling:" in out and stats["sampled_tokens"] > 0
    assert reqs[0].sampling.seed == 0 and reqs[2].sampling.seed == 2
    assert reqs[1].sampling.greedy and reqs[1].sampling.stop == ((5, 6),)
    for bad in (["--speculative", "--temperature", "0.5"], ["--spec-k", "0"],
                ["--speculative", "--cache-backend", "paged", "--paged-native",
                 "--paged-kernel"], ["--stop", "1,x"], ["--top-p", "0"]):
        with pytest.raises(SystemExit):
            tserve.run(common + bad)


# ---------------------------------------------------------------------------
# the reference Engine's speculative streams
# ---------------------------------------------------------------------------

REF_CASES = {
    f"spec-{route}": ({**ecfg, "speculative": True, "spec_k": 3}, "bfloat16",
                      *P.traffic([5, 9, 12, 7], 24))
    for route, ecfg in (("contiguous", {"cache_backend": "contiguous"}),
                        ("bridge", {"cache_backend": "paged"}),
                        ("native_plain", {"cache_backend": "paged", "paged_native": True}))}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("ref") / "spec.pkl")


@pytest.fixture(scope="module")
def ref_params(references):
    from repro_torch.testing.params import params_from_numpy
    return params_from_numpy(references["params"], device="cpu")


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("name", list(REF_CASES))
def test_spec_streams_match_reference(references, ref_params, name, dtype):
    got = P.run_port(ref_params, name, REF_CASES[name], dtype)
    ref = references[name, dtype]
    P.check_tokens(ref, got, dtype, name)
    assert got["flags"] == ref["flags"]
    assert got["census"] == ref["census"]
    assert got["stats"]["spec_rounds"] > 0


if __name__ == "__main__":
    P.main(REF_CASES)
