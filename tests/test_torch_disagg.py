"""Prefill/decode disaggregation in the port (repro_torch.serving.store
export/import, the transport's ship RPCs, the Router's role split) and the
continuation-seed harness (tests/_seed_verify.py) driven through the port's
Engine: the ports of tests/test_disagg.py with the same traffic, seeds and
assertions, and the port against the reference.

  * seed harness — every continuation point W of the pinned streams is
    clean through the port's Engine (re-admitting ``prompt + tokens[:W]``
    by fused prefill regenerates the exact rest), and the sweep has teeth
  * bit-identity — a ``prefill:1,decode:1`` fleet serving a staggered mix
    equals one engine serving the requests one at a time, float and W8A8
    weights, with zero prefill instructions on the decode host
  * fault injection — a retried ship_blocks returns the same entry and a
    retried recv dedups (one import); a corrupted payload is refused by its
    checksum and the stream falls back to re-prefill, bitwise; a
    backpressured decode host parks the ship and the retry lands it
  * counters — preempt/export takes back prefix_hits, eviction takes back
    admissions_deferred
  * conservation — free + referenced + cached-unreferenced partition both
    pools of a shipping pair after every operation, ledger-held blocks
    referenced until the ack
  * reference parity — the same payload (pool bits written through
    ``write_slots`` from the same numpy K/V) has the same n_valid,
    n_blocks, layout tag and checksum in both packages, and the reference's
    payload imports into the port's pool bit for bit; disaggregated
    streams (bf16 and int8 KV, W8A8) equal the reference fleet's by the
    margin rule with identical router counters and decode-host flags
"""

import pickle
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

import _seed_verify as sv  # noqa: E402
import _torch_parity as P  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tensorizer as tz  # noqa: E402
from repro_torch.launch.serve import quant_predicate  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, EngineConfig, PagedKVStore, Router, RouterConfig,
)
from repro_torch.serving.router import parse_disaggregate  # noqa: E402
from repro_torch.serving.transport import build_inproc_fleet  # noqa: E402

CFG = get_config("tinyllama-1.1b").smoke()
RNG = np.random.default_rng(7)
ROLES = parse_disaggregate("prefill:1,decode:1", 2)


def _init(cfg):
    return init_model(cfg, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def params():
    return _init(CFG)


def _factory(cfg, params, ecfg_kw):
    return Engine(cfg, params, EngineConfig(**ecfg_kw), device="cpu")


def _pecfg(**kw):
    base = dict(max_slots=4, max_queue=16, max_seq_len=64, cache_backend="paged",
                block_size=8, paged_native=True)
    base.update(kw)
    return EngineConfig(**base)


def _prompts(lens, rng=None):
    rng = RNG if rng is None else rng
    return [rng.integers(0, CFG.vocab, (n,), dtype=np.int32) for n in lens]


def _sequential(cfg, params, prompts, gens, ecfg):
    eng = Engine(cfg, params, ecfg, device="cpu")
    outs = []
    for p, g in zip(prompts, gens):
        req = eng.submit(p, g, strict=True)
        eng.run_until_complete()
        outs.append(list(req.tokens))
    eng.close()
    return outs


def _prefill_issued(flags):
    return sum(n for f, n in flags.items() if f.startswith(("prefill", "draft_prefill")))


# ================================================================ seed harness

def test_continuation_sweep_all_points_clean(params):
    """Every continuation point of a greedy stream is clean through the
    port's Engine: the property the router's re-prefill fallback relies on
    at arbitrary cut points."""
    prompt = _prompts([6], rng=np.random.default_rng(21))[0]
    report = sv.assert_clean_continuations(
        CFG, params, prompt, 10, ecfg_kw=dict(max_slots=2, max_seq_len=32),
        engine_factory=_factory)
    assert report.clean == list(range(1, 10))
    assert report.ranges() == [(1, 9)]


def test_continuation_sweep_has_teeth(params):
    """A tampered continuation token at one cut point is flagged at exactly
    that W with the right first-divergence index."""
    prompt = _prompts([6], rng=np.random.default_rng(21))[0]
    base = sv.run_stream(CFG, params, prompt, 8, ecfg_kw=dict(max_slots=2, max_seq_len=32),
                         engine_factory=_factory)

    def tamper(w, cont):
        return ([(cont[0] + 1) % CFG.vocab] + cont[1:]) if w == 3 else cont

    report = sv.sweep_continuations(CFG, params, prompt, 8, baseline=base,
                                    ecfg_kw=dict(max_slots=2, max_seq_len=32),
                                    cut_points=(2, 3, 4), engine_factory=_factory,
                                    _tamper=tamper)
    assert report.divergent == [(3, 3)]
    assert report.clean == [2, 4]
    assert not report.all_clean
    with pytest.raises(AssertionError, match="divergent cut points"):
        sv.assert_clean_continuations(CFG, params, prompt, 8, baseline=base,
                                      ecfg_kw=dict(max_slots=2, max_seq_len=32),
                                      cut_points=(3,), engine_factory=_factory,
                                      _tamper=tamper)


@pytest.mark.slow
def test_pinned_transport_seeds_verified():
    """The seeds tests/test_torch_transport.py takes from the reference
    (21/22/13), swept through the port's Engine at the reference's cut
    points."""
    big = CFG.replace(n_layers=4, d_model=256, n_heads=8, n_kv=4, d_ff=1024, vocab=512,
                      head_dim=32)
    bparams = _init(big)
    for seed, plen, gen in ((21, 7, 96), (22, 6, 96), (13, 6, 96)):
        prompt = np.random.default_rng(seed).integers(0, big.vocab, (plen,), dtype=np.int32)
        sv.assert_clean_continuations(big, bparams, prompt, gen,
                                      ecfg_kw=dict(max_slots=2, max_seq_len=128),
                                      cut_points=(1, 2, 3, gen // 2, gen - 2),
                                      engine_factory=_factory)


# ============================================================== bit-identity

def _serve_disagg(cfg, params, prompts, gens, ecfg, *, stagger=3, wrap_src=None,
                  wrap_dst=None):
    """A staggered mix on an in-process prefill:1,decode:1 fleet;
    ``wrap_src``/``wrap_dst`` wrap the prefill/decode host transports.
    Returns (tokens, router counters, decode host flags)."""
    fleet = build_inproc_fleet(cfg, params, ecfg, 2, device="cpu")
    if wrap_src:
        wrap_src(fleet[ROLES.index("prefill")])
    if wrap_dst:
        wrap_dst(fleet[ROLES.index("decode")])
    router = Router(transports=fleet,
                    router_cfg=RouterConfig(handoff_threshold=2, roles=ROLES))
    reqs = []
    for i, (p, g) in enumerate(zip(prompts, gens)):
        reqs.append(router.submit(p, g, session=str(i), strict=True))
        for _ in range(stagger):
            router.step()
    router.run_until_complete()
    s = router.stats()
    flags = dict(s["per_host"][ROLES.index("decode")]["opq"]["flags"])
    router.close()
    return [list(r.tokens) for r in reqs], s["router"], flags


def test_disagg_dense_bit_identical_and_prefill_free(params):
    prompts = _prompts([12, 24, 9, 17])
    gens = [24, 16, 24, 16]
    ecfg = _pecfg()
    want = _sequential(CFG, params, prompts, gens, ecfg)
    toks, rstats, flags = _serve_disagg(CFG, params, prompts, gens, ecfg)
    assert toks == want
    assert rstats["ships"] >= 1 and rstats["ship_fallbacks"] == 0
    assert _prefill_issued(flags) == 0, flags


def test_disagg_int8_bit_identical(params):
    """The same under serving quantization (per-row activation scales keep a
    slot's numerics independent of its decode batchmates)."""
    cfg_q = CFG.replace(quantize="serve")
    params_q = tz.quantize_params(params, predicate=quant_predicate)
    prompts = _prompts([12, 24, 9])
    gens = [20, 14, 20]
    ecfg = _pecfg()
    want = _sequential(cfg_q, params_q, prompts, gens, ecfg)
    toks, rstats, flags = _serve_disagg(cfg_q, params_q, prompts, gens, ecfg)
    assert toks == want
    assert rstats["ships"] >= 1
    assert _prefill_issued(flags) == 0, flags


# ============================================================ fault injection

def test_ship_rpc_idempotent_no_double_import(params):
    """A re-called ship_blocks returns the same cached entry; a re-delivered
    recv_blocks dedups on the payload id (one import); a re-sent ack is a
    no-op."""
    fleet = build_inproc_fleet(CFG, params, _pecfg(max_slots=2, max_seq_len=32), 2,
                               device="cpu")
    src, dst = fleet
    eid = src.submit(_prompts([10])[0], 12)
    for _ in range(50):
        if (src.poll({eid: 0}).get(eid) or {}).get("t"):
            break
        src.pump()
    entry = src.ship_blocks(eid)
    assert entry is not None
    assert src.ship_blocks(eid) is entry
    nid = dst.recv_blocks(entry)
    assert nid is not None
    assert dst.recv_blocks(entry) == nid
    assert dst.engine.metrics.imported_slots == 1
    assert src.ack_ship(entry["payload_id"]) is True
    assert src.ack_ship(entry["payload_id"]) is False
    for _ in range(50):
        if not dst.has_work():
            break
        dst.pump()
    assert dst.poll({nid: 0})[nid].get("done")
    for t in fleet:
        t.close()


def test_corrupt_ship_payload_falls_back_bit_identically(params):
    """A bit flipped in every shipped payload: the importer's checksum
    refuses it and the stream falls back to re-prefill on the prefill host,
    bitwise the single engine's."""
    prompts = _prompts([12, 9])
    gens = [20, 20]
    ecfg = _pecfg()
    want = _sequential(CFG, params, prompts, gens, ecfg)

    def corrupt(t):
        orig = t.ship_blocks

        def bad_ship(req_id):
            entry = orig(req_id)
            if entry is not None:
                name = sorted(entry["payload"]["leaves"])[0]
                leaf = np.array(entry["payload"]["leaves"][name], copy=True)
                flat = leaf.reshape(-1).view(np.uint8)
                flat[0] ^= 0xFF
                entry["payload"]["leaves"][name] = leaf
            return entry
        t.ship_blocks = bad_ship

    toks, rstats, flags = _serve_disagg(CFG, params, prompts, gens, ecfg, wrap_src=corrupt)
    assert toks == want
    assert rstats["ship_fallbacks"] >= 1 and rstats["ships"] == 0
    assert _prefill_issued(flags) == 0, flags


def test_backpressured_ship_parks_and_retries(params):
    prompts = _prompts([12, 9])
    gens = [20, 20]
    ecfg = _pecfg()
    want = _sequential(CFG, params, prompts, gens, ecfg)

    def flaky(t):
        orig = t.recv_blocks
        state = {"refusals": 3}

        def refusing(entry):
            if state["refusals"] > 0:
                state["refusals"] -= 1
                return None
            return orig(entry)
        t.recv_blocks = refusing

    toks, rstats, flags = _serve_disagg(CFG, params, prompts, gens, ecfg, wrap_dst=flaky)
    assert toks == want
    assert rstats["ships"] >= 1 and rstats["ship_fallbacks"] == 0
    assert _prefill_issued(flags) == 0, flags


# ================================================================== counters

def test_preempt_and_evict_reconcile_admission_counters(params):
    """A preempted or exported stream's prefix_hits contribution leaves with
    it, and an evicted queued request takes its admissions_deferred mark."""
    ecfg = _pecfg(max_slots=2, max_seq_len=32, n_blocks=7, prefix_cache=True)
    eng = Engine(CFG, params, ecfg, device="cpu")
    prompt = _prompts([16])[0]
    r0 = eng.submit(prompt, 4, strict=True)
    eng.run_until_complete()
    assert r0.done and eng.metrics.prefix_hits == 0
    r1 = eng.submit(prompt, 8, strict=True)
    eng.step()
    assert eng.metrics.prefix_hits == 1
    eng.preempt(r1.id)
    assert eng.metrics.prefix_hits == 0
    r2 = eng.submit(prompt, 8, strict=True)
    eng.step()
    assert eng.metrics.prefix_hits == 1
    _, payload = eng.extract_seeded(r2.id)
    assert eng.metrics.prefix_hits == 0
    eng.release_exported(payload["payload_id"])

    big = _prompts([16])[0]
    ra = eng.submit(big, 16, strict=True)
    rb = eng.submit(big[::-1].copy(), 16, strict=True)
    deadline = 200
    while eng.metrics.admissions_deferred == 0 and deadline:
        eng.step()
        deadline -= 1
    assert eng.metrics.admissions_deferred == 1
    evicted = eng.evict_queued()
    assert [r.id for r in evicted] == [rb.id]
    assert eng.metrics.admissions_deferred == 0
    eng.run_until_complete()
    assert ra.done
    eng.close()


# =============================================================== conservation

def _census_ok(store: PagedKVStore):
    c = store.debug_block_census()
    everything = c["free"] + c["referenced"] + c["cached_unreferenced"]
    assert len(everything) == len(set(everything)), c
    assert sorted(everything) == list(range(1, store.n_blocks)), c
    holds = Counter(b for bs in store._leased.values() for b in bs)
    holds.update(b for bs in store._exported.values() for b in bs)
    assert sorted(holds) == c["referenced"]
    for b, n in holds.items():
        assert store._ref[b] == n, (b, n, store._ref[b])


@settings(deadline=None, max_examples=10)
@given(st.integers(min_value=0, max_value=1 << 30))
def test_block_conservation_across_ship_lifecycle(seed):
    """Random lease/commit/export/import/ack/fallback/retire traffic over two
    small pools: after every operation both partition exactly, ledger blocks
    stay referenced until the ack, a released payload frees exactly what
    nothing else holds, and nothing leaks at the end."""
    rng = np.random.default_rng(seed)
    cfg = get_config("tinyllama-1.1b").smoke()

    def mk():
        return PagedKVStore(cfg, n_slots=3, max_seq_len=16, block_size=4, n_blocks=12,
                            prefix_cache=True, device="cpu")
    A, B = mk(), mk()
    in_flight, imported, pid_counter = [], [], [0]
    for _ in range(80):
        op = int(rng.integers(0, 6))
        if op == 0:
            slot = int(rng.integers(0, 3))
            if slot not in A._leased:
                plen = int(rng.integers(1, 13))
                gen = int(rng.integers(1, 17 - plen))
                tokens = rng.integers(0, 3, (plen,), dtype=np.int32)
                if A.lease(slot, plen, gen, tokens=tokens) and int(rng.integers(0, 2)):
                    A.commit_prefix(slot)
        elif op == 1:
            leased = sorted(set(A._leased))
            if leased:
                slot = int(rng.choice(leased))
                cap = len(A._leased[slot]) * 4
                index = A.cache["index"].clone()
                index[slot] = int(rng.integers(0, cap + 1))
                A.cache = dict(A.cache, index=index)
                pid_counter[0] += 1
                pid = f"p{pid_counter[0]}"
                in_flight.append((pid, A.export_blocks(slot, payload_id=pid)))
        elif op == 2 and in_flight:
            pid, payload = in_flight.pop(int(rng.integers(len(in_flight))))
            free = [s for s in range(3) if s not in B._leased]
            if free and B.lease(free[0], 8, 8):
                try:
                    B.import_blocks(free[0], payload)
                    imported.append(pid)
                except ValueError:
                    B.reset(free[0])
                    A.release_exported(pid)
            else:
                in_flight.append((pid, payload))
        elif op == 3:
            if imported:
                assert A.release_exported(imported.pop()) is True
        elif op == 4 and in_flight:
            pid, _ = in_flight.pop(int(rng.integers(len(in_flight))))
            assert A.release_exported(pid) is True
        else:
            store = A if int(rng.integers(0, 2)) else B
            leased = sorted(set(store._leased))
            if leased:
                store.reset(int(rng.choice(leased)))
        _census_ok(A)
        _census_ok(B)
        assert A.release_exported("nonexistent") is False
    for pid, _ in in_flight:
        assert A.release_exported(pid) is True
    for pid in imported:
        A.release_exported(pid)
    for store in (A, B):
        for slot in sorted(set(store._leased)):
            store.reset(slot)
        _census_ok(store)
        assert store.debug_block_census()["referenced"] == []


def test_import_refuses_a_bad_payload_before_writing(params):
    """Geometry, dtype, truncation and checksum are checked before any
    device write: each bad payload raises ValueError, the pool is
    untouched, and the good payload then imports bit for bit."""
    eng = Engine(CFG, params, _pecfg(max_slots=2, max_seq_len=32), device="cpu")
    req = eng.submit(_prompts([10])[0], 12)
    eng.step()
    eng.step()
    _, payload = eng.extract_seeded(req.id)
    dst = PagedKVStore(CFG, 2, 32, block_size=8, native=True, device="cpu")
    assert dst.lease(0, 10, 12)
    before = {n: t.clone() for n, t in dst.cache.items()}

    def bad(mutate):
        p = {**payload, "layout": {**payload["layout"],
                                   "leaves": dict(payload["layout"]["leaves"])},
             "leaves": dict(payload["leaves"])}
        mutate(p)
        return p
    name = sorted(payload["leaves"])[0]
    cases = [
        lambda p: p["layout"].update(block_size=16),
        lambda p: p.update(n_blocks=p["n_blocks"] + 1),
        lambda p: p["leaves"].update({name: p["leaves"][name][:, :1]}),
        lambda p: p["leaves"].update({name: p["leaves"][name].view(np.int16)}),
        lambda p: p.update(crc=p["crc"] ^ 1),
    ]
    for mutate in cases:
        with pytest.raises(ValueError):
            dst.import_blocks(0, bad(mutate))
        assert all(torch.equal(t, before[n]) for n, t in dst.cache.items())
    dst.import_blocks(0, payload)
    assert dst.slot_index(0) == payload["n_valid"]
    src_rows = eng.store.cache
    eng.close()
    blocks = dst._leased[0][:payload["n_blocks"]]
    for n in payload["leaves"]:
        got = dst.cache[n][:, blocks]
        assert got.dtype == src_rows[n].dtype
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16)
                              if got.dtype == torch.bfloat16 else got.numpy(),
                              payload["leaves"][n])


# ====================================================== against the reference

PAYLOAD_KV = {"bfloat16": 13, "int8": 14}      # seed of each pool's numpy K/V


def _pool_leaves(cfg, n_valid, seed):
    """Numpy K/V (L, 1, n_valid, ...): f32 values for bf16 leaves (both
    packages' ``write_slots`` round them to nearest even), int8 codes and
    f32 scales as they are."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, n_valid, cfg.n_kv, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.random(shape[:-1]).astype(np.float32),
                "v_scale": rng.random(shape[:-1]).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _export(PagedKVStore, to_leaf, cfg, n_valid, seed, **kw):
    store = PagedKVStore(cfg, 2, 32, block_size=8, **kw)
    assert store.lease(0, n_valid, 32 - n_valid)
    kv = {n: to_leaf(a) for n, a in _pool_leaves(cfg, n_valid, seed).items()}
    store.write_slots([0], kv, [n_valid])
    return store.export_blocks(0, payload_id="r0c1")


DISAGG_CASES = {
    f"disagg-{kv}": {"kv": kv, "traffic": P.traffic([12, 24, 9], 20, seed=31)}
    for kv in P.KV_DTYPES}


def run_disagg_case(Router, RouterConfig, EngineConfig, build_fleet, cfg, params, case):
    fleet = build_fleet(cfg, params, EngineConfig(
        max_slots=4, max_queue=16, max_seq_len=64, cache_backend="paged", block_size=8,
        paged_native=True), 2)
    router = Router(transports=fleet, router_cfg=RouterConfig(handoff_threshold=2,
                                                              roles=ROLES))
    prompts, gens = case["traffic"]
    return P.drive_router(router, prompts, gens, sessions=[str(i) for i in range(len(gens))],
                          stagger=3)


def _reference():
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.serving.store import PagedKVStore as JStore
    out = P.fleet_reference(DISAGG_CASES, run_disagg_case)
    for kv, seed in PAYLOAD_KV.items():
        cfg = jget_config("tinyllama-1.1b").smoke().replace(kv_cache_dtype=kv)
        payload = _export(JStore, jnp.asarray, cfg, 13, seed)
        payload["leaves"] = {n: np.asarray(a) for n, a in payload["leaves"].items()}
        out["payload", kv] = payload
    return out


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("ref") / "disagg.pkl")


@pytest.mark.parametrize("kv", list(PAYLOAD_KV))
def test_payload_matches_reference_and_imports(references, kv):
    ref = references["payload", kv]
    cfg = CFG.replace(kv_cache_dtype=kv)
    got = _export(PagedKVStore, torch.from_numpy, cfg, 13, PAYLOAD_KV[kv], device="cpu")
    for key in ("payload_id", "n_valid", "n_blocks", "layout", "crc"):
        assert got[key] == ref[key], key
    # the reference's payload (bf16 leaves as ml_dtypes) imports into the
    # port's pool: its raw words are the port's wire form
    wire = dict(ref, leaves={n: a.view(np.uint16) if a.dtype.name == "bfloat16" else a
                             for n, a in ref["leaves"].items()})
    dst = PagedKVStore(cfg, 2, 32, block_size=8, device="cpu")
    assert dst.lease(1, 13, 19)
    dst.import_blocks(1, wire)
    for n, a in got["leaves"].items():
        assert np.array_equal(a, wire["leaves"][n]), n


@pytest.fixture(scope="module")
def ports(references):
    from repro_torch.testing.params import params_from_numpy
    return P.fleet_port(params_from_numpy(references["params"], device="cpu"),
                        DISAGG_CASES, run_disagg_case)


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("name", list(DISAGG_CASES))
def test_disagg_streams_and_counters_match_reference(references, ports, name, dtype):
    ref, got = references[name, dtype], ports[name, dtype]
    P.check_tokens(ref, got, dtype, name)
    assert got["counters"] == ref["counters"]
    assert got["counters"]["ships"] >= 1 and got["counters"]["ship_fallbacks"] == 0
    assert got["hosts"] == ref["hosts"]
    assert got["flags"] == ref["flags"]
    assert _prefill_issued(got["flags"][ROLES.index("decode")]) == 0


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
