"""The port's multi-host Router (repro_torch.serving.router) on the CPU:
the ports of tests/test_router.py at smoke widths with the same traffic,
seeds and assertions, and the port's fleet against the reference fleet.

  * bit-identity — staggered multi-host serving (affinity placement,
                   spills, a mid-run drain/handoff) gives exactly the tokens
                   of one engine serving the requests one at a time, bf16
                   and int8 KV, and for the MoE family (moonshot-v1-16b-a3b)
  * drain/handoff, affinity, spill, the fleet door, direct engine submits,
    config validation, the Engine's drain hooks, ``available_now`` and the
    three-level ``stats()`` — as in the reference's tests
  * reference parity — placement, spill and drain (bf16 and int8 KV) on
    the same W8A8 weights through the reference Router (a subprocess,
    tests/_torch_parity.py) and the port's, f32 and bf16 compute: streams
    equal by the margin rule, router counters, host trails and every
    host's OPQ flag counts identical
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import _torch_parity as P  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, EngineConfig, QueueFull, RequestState, Router, RouterConfig,
    format_router_stats,
)

CFG = get_config("tinyllama-1.1b").smoke()
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def params():
    return init_model(CFG, torch.Generator().manual_seed(0))


def _prompts(lens, cfg=CFG):
    return [RNG.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _sequential(params, prompts, gens, cfg=CFG, **ecfg_kw):
    """Reference: one engine, one request at a time, drained in between."""
    kw = dict(max_slots=2, max_seq_len=32)
    kw.update(ecfg_kw)
    eng = Engine(cfg, params, EngineConfig(**kw), device="cpu")
    outs = []
    for p, g in zip(prompts, gens):
        req = eng.submit(p, g)
        eng.run_until_complete()
        outs.append(list(req.tokens))
    eng.close()
    return outs


def _router(cfg, params, ecfg, rcfg):
    return Router(cfg, params, ecfg, rcfg, device="cpu")


def _fleet_staggered(params, prompts, gens, cfg=CFG, *, n_hosts=2, drain_at=None,
                     handoff_threshold=0, sessions=None, **ecfg_kw):
    """Mixed multi-host traffic: staggered arrivals, optional mid-run drain
    of host 0. Returns (token streams, router stats, request objects)."""
    router = _router(cfg, params, EngineConfig(max_slots=2, max_seq_len=32, **ecfg_kw),
                     RouterConfig(n_hosts=n_hosts, handoff_threshold=handoff_threshold))
    reqs = []
    step = 0
    for i, (p, g) in enumerate(zip(prompts, gens)):
        sess = sessions[i] if sessions else str(i % n_hosts)
        reqs.append(router.submit(p, g, session=sess, strict=True))
        router.step()
        step += 1
        if drain_at is not None and step == drain_at:
            router.drain(0)
    router.run_until_complete()
    outs = [list(r.tokens) for r in reqs]
    stats = router.stats()
    router.close()
    return outs, stats, reqs


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_multi_host_bit_identical_to_sequential(params, kv_dtype):
    """Requests spread across hosts by affinity and load, including a
    mid-run drain() that hands host 0's in-flight generations to host 1,
    give exactly the tokens each request gets alone on one engine."""
    cfg = CFG.replace(kv_cache_dtype=kv_dtype)
    prompts = _prompts([5, 9, 4, 7], cfg=cfg)
    gens = [8, 6, 8, 5]
    sequential = _sequential(params, prompts, gens, cfg=cfg)

    plain, _, _ = _fleet_staggered(params, prompts, gens, cfg=cfg)
    assert plain == sequential                    # bit-identical, not allclose

    drained, s_drain, reqs = _fleet_staggered(params, prompts, gens, cfg=cfg, drain_at=2)
    assert drained == sequential                  # ... across drain/handoff
    assert s_drain["router"]["handoffs"] >= 1     # the drain really handed off
    assert any(len(r.hosts) > 1 for r in reqs)


def test_moe_multi_host_bit_identical_to_sequential():
    """The reference's MoE case of the test above: a MoE fleet (decode masks
    idle slots out of the expert capacity, a handed-off continuation
    re-admits row-isolated) gives each request's tokens alone."""
    cfg = get_config("moonshot-v1-16b-a3b").smoke()
    moe_params = init_model(cfg, torch.Generator().manual_seed(1))
    prompts = _prompts([5, 9, 4, 7], cfg=cfg)
    gens = [8, 6, 8, 5]
    sequential = _sequential(moe_params, prompts, gens, cfg=cfg)
    plain, _, _ = _fleet_staggered(moe_params, prompts, gens, cfg=cfg)
    assert plain == sequential
    drained, s_drain, reqs = _fleet_staggered(moe_params, prompts, gens, cfg=cfg,
                                              drain_at=2)
    assert drained == sequential
    assert s_drain["router"]["handoffs"] >= 1
    assert any(len(r.hosts) > 1 for r in reqs)


def test_drain_handoff_stitches_streams_and_empties_host(params):
    """drain() step by step: host 0's in-flight request hands off
    mid-generation, its queued request re-places, the stitched stream is
    the undrained one, the host reports is_drained once empty, and
    undrain() returns it to the placement pool."""
    prompts = _prompts([6, 5, 4])
    gens = [10, 8, 6]
    sequential = _sequential(params, prompts, gens)

    router = _router(CFG, params, EngineConfig(max_slots=1, max_seq_len=32),
                     RouterConfig(n_hosts=2, handoff_threshold=0))
    r0 = router.submit(prompts[0], gens[0], session="a")
    router.step()
    router.step()
    r1 = router.submit(prompts[1], gens[1], session="a")   # affinity: host 0
    r2 = router.submit(prompts[2], gens[2], session="b")   # least-loaded: 1
    assert [r.hosts[0] for r in (r0, r1, r2)] == [0, 0, 1]
    eng0 = router.engines[0]
    assert eng0.scheduler.n_active == 1 and eng0.scheduler.queue_depth == 1

    router.drain(0)
    assert eng0.metrics.preempted == 1 and eng0.metrics.evicted == 1
    assert not eng0.has_work() and router.is_drained(0)
    s = router.stats()["router"]
    assert s["handoffs"] == 1 and s["requeued"] == 1 and s["drains"] == 1
    assert len(r0.tokens) >= 1 and not r0.done    # segment 1 stands, not done

    router.run_until_complete()
    assert [list(r.tokens) for r in (r0, r1, r2)] == sequential
    assert r0.hosts == [0, 1]                     # the handoff trail
    assert r1.hosts == [0, 1]                     # evicted -> re-placed

    router.undrain(0)
    r3 = router.submit(_prompts([4])[0], 4)
    assert r3.hosts == [0]                        # least-loaded again
    router.run_until_complete()
    assert len(r3.tokens) == 4
    router.close()


def test_drain_short_tail_finishes_in_place(params):
    """A request with at most handoff_threshold tokens left rides out the
    drain on the draining engine, and still finishes bit-identically."""
    prompts = _prompts([6])
    gens = [4]
    sequential = _sequential(params, prompts, gens)
    router = _router(CFG, params, EngineConfig(max_slots=2, max_seq_len=32),
                     RouterConfig(n_hosts=2, handoff_threshold=8))
    r = router.submit(prompts[0], gens[0])
    router.step()                                 # 1 token in, 3 < 8 remain
    router.drain(0)
    assert router.stats()["router"]["handoffs"] == 0
    assert router.engines[0].has_work()           # finishing in place
    router.run_until_complete()
    assert [list(r.tokens)] == sequential
    assert r.hosts == [0]
    assert router.is_drained(0)
    router.close()


def test_affinity_pins_sessions_and_counts_like_opq(params):
    """Same-session requests pin to the host that served the session last,
    ledgered the way OPQ ledgers lane affinity; fresh sessions spread by
    load; identical prompts without a session hash together."""
    prompts = _prompts([4, 4, 4, 4])
    router = _router(CFG, params, EngineConfig(max_slots=4, max_seq_len=32),
                     RouterConfig(n_hosts=2))
    ra = router.submit(prompts[0], 4, session="a")
    rb = router.submit(prompts[1], 4, session="b")
    ra2 = router.submit(prompts[2], 4, session="a")
    rb2 = router.submit(prompts[3], 4, session="b")
    assert ra.hosts != rb.hosts
    assert ra2.hosts == ra.hosts and rb2.hosts == rb.hosts
    s = router.stats()["router"]
    assert s["placed"] == 4 and s["affinity_hits"] == 2 and s["spills"] == 0
    rh1 = router.submit(prompts[0], 4)
    rh2 = router.submit(prompts[0], 4)
    assert rh1.hosts == rh2.hosts
    assert router.stats()["router"]["affinity_hits"] == 3
    router.run_until_complete()
    router.close()


def test_spill_on_dry_pinned_pool(params):
    """The pinned host's paged pool is fully leased, so the next
    same-session request sheds to the least-loaded host (spill counted) and
    the fleet decodes both concurrently."""
    ecfg = EngineConfig(max_slots=2, max_seq_len=16, cache_backend="paged",
                        block_size=8, n_blocks=3)
    router = _router(CFG, params, ecfg, RouterConfig(n_hosts=2))
    p = _prompts([8, 8])
    r0 = router.submit(p[0], 8, session="a")
    router.step()                                  # host 0's pool: dry
    assert not router.engines[r0.hosts[0]].lease_headroom(8, 8)
    r1 = router.submit(p[1], 8, session="a")       # pinned to a dry host
    s = router.stats()["router"]
    assert r1.hosts[0] != r0.hosts[0]
    assert s["spills"] == 1 and s["affinity_hits"] == 0
    router.step()
    assert all(e.scheduler.n_active == 1 for e in router.engines)
    router.run_until_complete()
    assert [list(r0.tokens), list(r1.tokens)] == _sequential(
        params, p, [8, 8], cache_backend="paged", block_size=8, n_blocks=3,
        max_seq_len=16, max_slots=2)
    router.close()


def test_router_rejects_when_no_host_accepts(params):
    """The fleet door: a request no host can serve bounces (None, QueueFull
    when strict), counted on the ledger; draining every host closes it."""
    router = _router(CFG, params, EngineConfig(max_slots=2, max_seq_len=16),
                     RouterConfig(n_hosts=2))
    assert router.submit(_prompts([8])[0], 20) is None
    with pytest.raises(QueueFull):
        router.submit(_prompts([8])[0], 20, strict=True)
    ok = router.submit(_prompts([8])[0], 4)
    assert ok is not None
    router.drain(0)
    router.drain(1)
    assert router.submit(_prompts([4])[0], 4) is None
    assert router.stats()["router"]["rejected"] == 3
    router.run_until_complete()
    assert len(ok.tokens) == 4
    router.close()


def test_drain_tolerates_direct_engine_submits(params):
    """Requests submitted to an engine directly are not router-placed: a
    drain re-enqueues the queued one on its engine and lets the in-flight
    one finish in place."""
    router = _router(CFG, params, EngineConfig(max_slots=1, max_seq_len=32),
                     RouterConfig(n_hosts=2, handoff_threshold=0))
    eng0 = router.engines[0]
    d_active = eng0.submit(_prompts([5])[0], 6)
    router.step()
    d_queued = eng0.submit(_prompts([4])[0], 4)
    router.drain(0)
    assert router.stats()["router"]["handoffs"] == 0
    assert eng0.scheduler.queue_depth == 1
    router.run_until_complete()
    assert d_active.done and d_queued.done
    assert len(d_active.tokens) == 6 and len(d_queued.tokens) == 4
    router.close()


def test_router_config_validation(params):
    with pytest.raises(ValueError, match="n_hosts"):
        _router(CFG, params, None, RouterConfig(n_hosts=0))
    with pytest.raises(ValueError, match="handoff_threshold"):
        _router(CFG, params, None, RouterConfig(n_hosts=1, handoff_threshold=-1))
    router = _router(CFG, params, EngineConfig(max_slots=1, max_seq_len=16),
                     RouterConfig(n_hosts=1))
    with pytest.raises(ValueError, match="no host"):
        router.drain(5)
    router.close()


def test_engine_drain_hooks(params):
    """would_accept mirrors submit's door without side effects,
    evict_queued empties only the FIFO, preempt retires only the named
    request's slot and scrubs its rows."""
    eng = Engine(CFG, params, EngineConfig(max_slots=1, max_seq_len=32), device="cpu")
    assert eng.would_accept(4, 4)
    assert not eng.would_accept(4, 40)
    assert not eng.would_accept(0, 4)
    assert eng.lease_headroom(4, 4)               # contiguous: always now

    r_active = eng.submit(_prompts([5])[0], 8)
    eng.step()
    r_q1 = eng.submit(_prompts([4])[0], 4)
    r_q2 = eng.submit(_prompts([6])[0], 4)
    evicted = eng.evict_queued()
    assert evicted == [r_q1, r_q2]
    assert all(r.state == RequestState.PREEMPTED for r in evicted)
    assert eng.scheduler.queue_depth == 0
    assert eng.scheduler.n_active == 1

    tokens_before = list(r_active.tokens)
    preempted = eng.preempt(r_active.id)
    assert preempted is r_active
    assert preempted.tokens == tokens_before
    assert eng.scheduler.n_active == 0
    assert eng.store.slot_index(0) == 0
    assert eng.metrics.preempted == 1 and eng.metrics.evicted == 2
    with pytest.raises(KeyError):
        eng.preempt(r_active.id)
    eng.close()


def test_paged_available_now_tracks_occupancy(params):
    """available_now (the spill signal) is occupancy-aware where fits is
    total-capacity-aware."""
    from repro_torch.serving import make_store
    store = make_store(CFG, 2, 16, backend="paged", block_size=8, n_blocks=3, device="cpu")
    assert store.fits(8, 8) and store.available_now(8, 8)
    assert store.lease(0, 8, 8)
    assert store.fits(8, 8)
    assert not store.available_now(8, 8)
    store.reset(0)
    assert store.available_now(8, 8)


def test_router_stats_three_levels(params):
    """stats(): the placement ledger, fleet sums that reconcile with the
    per-host engine counters, and each host's own stats (OPQ included);
    format_router_stats renders it."""
    prompts = _prompts([5, 9, 4, 7])
    gens = [6, 5, 8, 3]
    _, s, _ = _fleet_staggered(params, prompts, gens, drain_at=2)
    assert s["router"]["hosts"] == 2 and s["router"]["draining"] == [0]
    assert s["router"]["placed"] == 4
    assert s["router"]["completed"] == 4
    assert len(s["per_host"]) == 2
    for key in ("completed", "tokens_generated", "decode_steps", "preempted", "evicted"):
        assert s["fleet"][key] == sum(h[key] for h in s["per_host"])
    assert s["fleet"]["tokens_generated"] == sum(gens)
    assert all(h["opq"]["issued"] > 0 for h in s["per_host"] if h["decode_steps"] > 0)
    line = format_router_stats(s)
    assert "2 hosts" in line and "affinity" in line and "handoffs" in line


# ---------------------------------------------------------------------------
# the port's fleet against the reference's (W8A8 weights, margin rule)
# ---------------------------------------------------------------------------

def _traffic(lens, gens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,), dtype=np.int32) for n in lens], gens


CASES = {
    "placement": {"kv": "bfloat16", "ecfg": dict(max_slots=2, max_seq_len=32),
                  "traffic": _traffic([5, 9, 4, 7], [12, 10, 12, 9], 21),
                  "sessions": ["0", "1", "0", "1"], "rcfg": {}, "drain_at": None},
    "spill": {"kv": "bfloat16",
              "ecfg": dict(max_slots=2, max_seq_len=16, cache_backend="paged",
                           block_size=8, n_blocks=3),
              "traffic": _traffic([6, 6, 6], [10, 10, 10], 22),
              "sessions": ["a", "a", "a"], "rcfg": {}, "drain_at": None},
    **{f"drain-{kv}": {"kv": kv,
                       "ecfg": dict(max_slots=2, max_seq_len=32, cache_backend="paged",
                                    block_size=8, paged_native=True),
                       "traffic": _traffic([6, 9, 4, 7], [12, 10, 12, 9], 24),
                       "sessions": ["0", "1", "0", "1"],
                       "rcfg": dict(handoff_threshold=0), "drain_at": 2}
       for kv in P.KV_DTYPES},
}


def run_case(Router, RouterConfig, EngineConfig, build_fleet, cfg, params, case):
    router = Router(cfg, params, EngineConfig(**case["ecfg"]),
                    RouterConfig(n_hosts=2, **case["rcfg"]))
    prompts, gens = case["traffic"]
    return P.drive_router(router, prompts, gens, sessions=case["sessions"],
                          drain_at=case["drain_at"])


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("ref") / "router.pkl")


@pytest.fixture(scope="module")
def ports(references):
    from repro_torch.testing.params import params_from_numpy
    return P.fleet_port(params_from_numpy(references["params"], device="cpu"), CASES, run_case)


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_fleet_streams_and_counters_match_reference(references, ports, name, dtype):
    ref, got = references[name, dtype], ports[name, dtype]
    P.check_tokens(ref, got, dtype, name)
    assert got["counters"] == ref["counters"]
    assert got["hosts"] == ref["hosts"]
    assert got["flags"] == ref["flags"]
    if name.startswith("drain"):
        assert got["counters"]["handoffs"] >= 1
    if name == "spill":
        assert got["counters"]["spills"] >= 1


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(P.fleet_reference(CASES, run_case), f)
