"""The port's HostTransport (repro_torch.serving.transport, host_main.py) on
the CPU: the ports of tests/test_transport.py with the same traffic, seeds
and assertions. Worker processes rebuild their weights from a model spec
with a seeded ``torch.Generator`` (bitwise the parent's on one device
type), so every fleet is held to the port's own single Engine, bitwise.

  * protocol isolation — router.py reaches hosts only through HostTransport
    (grep); the default fleet is in-process
  * codec        — JSON (and msgpack where importable) frames round-trip the
    wire surface; engine configs and requests survive the wire
  * bit-identity — a seeded, staggered, mid-run-drained fleet of worker
    processes emits the single engine's streams, bf16 and int8 KV
  * crash safety — SIGKILL of a worker mid-decode: its streams recover on
    the survivor, bitwise, nothing double-emitted
  * fault injection — dropped, duplicated and stale frames: idempotent calls
    retry with fresh seqs, non-idempotent ones raise TransportError
  * TOCTOU       — a door that closes between would_accept and submit is
    skipped for the next candidate

Worker processes start with a 120 s connect timeout and every wait loop has
a deadline, so no test can hang the run.
"""

import os
import pathlib
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serving import Engine, EngineConfig, Router, RouterConfig, SamplingParams
from repro_torch.serving import transport as tp
from repro_torch.serving.transport import (
    EngineHost, SubprocessTransport, TransportError, build_inproc_fleet, build_model_spec,
    decode_frame, encode_frame, engine_cfg_from_wire, engine_cfg_to_wire,
)

CFG = get_config("tinyllama-1.1b").smoke()
RNG = np.random.default_rng(7)
CONNECT_S = 120.0
WAIT_S = 120.0


@pytest.fixture(scope="module")
def params():
    return init_model(CFG, torch.Generator().manual_seed(0))


def _prompts(lens, cfg=CFG, rng=None):
    rng = RNG if rng is None else rng
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _sampling(i):
    """Mixed traffic: even requests sample (per-request seed), odd greedy."""
    if i % 2 == 0:
        return SamplingParams(temperature=0.8, top_k=40, seed=100 + i)
    return None


def _sequential(params, prompts, gens, samplings, cfg=CFG, **ecfg_kw):
    """Reference: one in-process engine, one request at a time."""
    kw = dict(max_slots=2, max_seq_len=48)
    kw.update(ecfg_kw)
    eng = Engine(cfg, params, EngineConfig(**kw), device="cpu")
    outs = []
    for p, g, sp in zip(prompts, gens, samplings):
        req = eng.submit(p, g, sampling=sp)
        eng.run_until_complete()
        outs.append(list(req.tokens))
    eng.close()
    return outs


# --------------------------------------------------------------------- codec

@pytest.mark.parametrize("codec", ["json"] + (["msgpack"] if tp.msgpack else []))
def test_codec_round_trip(codec):
    obj = {
        "ints": [1, 2, 3], "f": 1.5, "none": None, "flag": True,
        "nested": {"deep": {"arr": np.arange(6, dtype=np.int32).reshape(2, 3)}},
        "f32": np.float32(2.5), "i64": np.int64(9),
        "emb": np.linspace(0, 1, 5, dtype=np.float32),
        "words": np.arange(4, dtype=np.uint16),          # a bf16 leaf's bits
    }
    out = decode_frame(encode_frame(obj, codec))
    assert out["ints"] == [1, 2, 3] and out["f"] == 1.5
    assert out["none"] is None and out["flag"] is True
    nd = out["nested"]["deep"]["arr"]
    assert isinstance(nd, np.ndarray) and nd.dtype == np.int32
    np.testing.assert_array_equal(nd, np.arange(6).reshape(2, 3))
    np.testing.assert_allclose(out["emb"], np.linspace(0, 1, 5), rtol=0)
    assert out["words"].dtype == np.uint16
    assert encode_frame({}, "json")[:1] == b"J"


def test_engine_cfg_wire_round_trip():
    ecfg = EngineConfig(max_slots=3, max_seq_len=32, buckets=(16, 32),
                        cache_backend="paged", block_size=8, n_blocks=9, prefix_cache=True)
    back = engine_cfg_from_wire(engine_cfg_to_wire(ecfg))
    assert back == ecfg
    spec_ecfg = EngineConfig(speculative=True, spec_k=3, draft=CFG)
    wire = engine_cfg_to_wire(spec_ecfg)
    assert "draft" not in wire
    rebuilt = engine_cfg_from_wire(wire, draft_cfg=CFG)
    assert rebuilt.draft == CFG and rebuilt.spec_k == 3


def test_request_wire_form(params):
    eng = Engine(CFG, params, EngineConfig(max_slots=1, max_seq_len=32), device="cpu")
    req = eng.submit(_prompts([5])[0], 4,
                     sampling=SamplingParams(temperature=0.5, seed=3, stop=((7, 8),)),
                     want_logprobs=2)
    eng.run_until_complete()
    wire = decode_frame(encode_frame(req.to_wire()))
    assert wire["tokens"] == list(req.tokens)
    assert wire["sampling"]["seed"] == 3
    assert wire["sampling"]["stop"] == [[7, 8]]
    assert len(wire["logprobs"]) == len(req.tokens)
    assert all(len(row) >= 2 for row in wire["top_logprobs"])
    assert len(req.token_ts) == len(req.tokens)
    eng.close()


# -------------------------------------------------------- protocol isolation

def test_router_speaks_only_the_transport_protocol():
    """router.py holds no direct engine access: every host interaction goes
    through HostTransport."""
    src = (pathlib.Path(__file__).parent.parent
           / "src/repro_torch/serving/router.py").read_text()
    for forbidden in ("repro_torch.serving.engine", "Engine(", ".scheduler",
                      ".opq", ".store", ".completed[", "run_engine"):
        assert forbidden not in src, (
            f"router.py reaches around the transport protocol: {forbidden!r}")


def test_default_fleet_is_in_process(params):
    router = Router(CFG, params, EngineConfig(max_slots=2, max_seq_len=32),
                    RouterConfig(n_hosts=2), device="cpu")
    assert [t.kind for t in router.transports] == ["in-process"] * 2
    assert len(router.engines) == 2
    assert all(e.device.type == "cpu" for e in router.engines)
    r = router.submit(_prompts([5])[0], 4)
    router.run_until_complete()
    assert len(r.tokens) == 4 and r.done
    s = router.stats()["router"]
    assert [t["kind"] for t in s["transport"]] == ["in-process"] * 2
    assert all(t["rpcs"] > 0 for t in s["transport"])
    router.close()


def test_engine_host_poll_is_cursor_idempotent(params):
    """poll never re-emits: identical cursors give identical deltas, and an
    advanced cursor excludes exactly the harvested prefix; done rides the
    final tokens' delta."""
    host = EngineHost(Engine(CFG, params, EngineConfig(max_slots=1, max_seq_len=32),
                             device="cpu"))
    eid = host.submit(_prompts([5])[0], 4)
    while host.has_work():
        host.pump()
    d1 = host.poll({eid: 0})
    d2 = host.poll({eid: 0})
    assert d1 == d2 and len(d1[eid]["t"]) == 4
    assert d1[eid]["done"] and d1[eid]["reason"] == "length"
    tail = host.poll({eid: 3})
    assert tail[eid]["t"] == d1[eid]["t"][3:]
    host.poll({}, drop=[eid])
    assert host.poll({eid: 0}) == {}
    host.close()


# --------------------------------------------------------------- TOCTOU door

class _FlakyDoor:
    """Transport wrapper whose door lies: would_accept says yes but the next
    submits return None."""

    def __init__(self, inner):
        self.inner = inner
        self.deny_submits = 0
        self.denied = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def submit(self, *args, **kwargs):
        if self.deny_submits > 0:
            self.deny_submits -= 1
            self.denied += 1
            return None
        return self.inner.submit(*args, **kwargs)


def test_submit_revalidates_and_falls_through(params):
    fleet = build_inproc_fleet(CFG, params, EngineConfig(max_slots=2, max_seq_len=32),
                               n_hosts=2, device="cpu")
    flaky = _FlakyDoor(fleet[0])
    router = Router(transports=[flaky, fleet[1]])
    flaky.deny_submits = 1
    r = router.submit(_prompts([5])[0], 4, session="x")
    assert r is not None and flaky.denied == 1
    assert r.hosts == [1]
    s = router.stats()["router"]
    assert s["placed"] == 1 and s["rejected"] == 0
    flaky.deny_submits = 10
    router2 = Router(transports=[flaky])
    assert router2.submit(_prompts([5])[0], 4) is None
    assert router2.stats()["router"]["rejected"] == 1
    router.close()


# ----------------------------------------------------- loss recovery (fast)

class _Breakable:
    """Transport wrapper that raises TransportError on command: an
    in-process dead worker."""

    def __init__(self, inner):
        self.inner = inner
        self.broken = False

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr) or name == "close":
            return attr

        def wrapped(*args, **kwargs):
            if self.broken:
                raise TransportError("injected host failure")
            return attr(*args, **kwargs)
        return wrapped


def test_lost_host_streams_recover_bit_identically(params):
    prompts = _prompts([6, 5, 7, 4])
    gens = [10, 9, 8, 10]
    samplings = [_sampling(i) for i in range(4)]
    sequential = _sequential(params, prompts, gens, samplings)

    fleet = build_inproc_fleet(CFG, params, EngineConfig(max_slots=2, max_seq_len=48),
                               n_hosts=2, device="cpu")
    breakable = _Breakable(fleet[0])
    router = Router(transports=[breakable, fleet[1]],
                    router_cfg=RouterConfig(handoff_threshold=0))
    reqs = []
    for i in range(4):
        reqs.append(router.submit(prompts[i], gens[i], session=str(i % 2),
                                  sampling=samplings[i], strict=True))
        router.step()
    assert {r.hosts[0] for r in reqs} == {0, 1}
    host0_reqs = [r for r in reqs if r.hosts[0] == 0]
    assert any(len(r.tokens) > 0 for r in host0_reqs)
    breakable.broken = True
    router.run_until_complete()

    assert [list(r.tokens) for r in reqs] == sequential
    s = router.stats()["router"]
    assert s["lost"] == [0] and s["hosts_lost"] == 1
    assert s["recovered"] >= len(host0_reqs)
    assert all(r.hosts[-1] == 1 for r in host0_reqs)
    router.close()


# ---------------------------------------------------- subprocess: real fleet
#
# A scaled-up smoke model: a 96-token generation is a window long enough on
# a free-running worker that a drain or a SIGKILL issued right after
# submit lands mid-decode. Streams preempted mid-decode (drained or killed,
# re-admitted at a timing-dependent cut point) are greedy, as in the
# reference's tests; sampled streams run pinned to the surviving host. The
# prompts come from the reference's fixed seeds (21/22/13), which
# tests/test_torch_disagg.py::test_pinned_transport_seeds_verified sweeps
# through the port's Engine.

BIG = dict(n_layers=4, d_model=256, n_heads=8, n_kv=4, d_ff=1024, vocab=512, head_dim=32)
BIG_CFG = CFG.replace(**BIG)


def _spec(overrides=None):
    return build_model_spec("tinyllama-1.1b", smoke=True, seed=0,
                            overrides=dict(BIG, **(overrides or {})), device="cpu")


def _spawn_fleet(n, ecfg, overrides=None):
    fleet = []
    try:
        for _ in range(n):
            fleet.append(SubprocessTransport(_spec(overrides), ecfg,
                                             connect_timeout_s=CONNECT_S,
                                             request_timeout_s=CONNECT_S))
    except Exception:
        for t in fleet:
            t.close()
        raise
    return fleet


def _close(router, fleet):
    """Close the fleet through its router, or each worker if none was built."""
    if router is not None:
        router.close()
    else:
        for t in fleet:
            t.close()


def _big_params(cfg):
    """The weights a worker rebuilds from the spec: the same generator."""
    return init_model(cfg, torch.Generator().manual_seed(0))


def _warm(fleet):
    """One tiny greedy request per worker before the timed traffic."""
    rng = np.random.default_rng(99)
    for t in fleet:
        eid = t.submit(_prompts([4], rng=rng)[0], 2)
        deadline = time.monotonic() + WAIT_S
        while not t.poll({eid: 0}).get(eid, {}).get("done"):
            assert time.monotonic() < deadline, "warmup never finished"
            time.sleep(0.01)
        t.poll({}, drop=[eid])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_subprocess_fleet_bit_identical_to_sequential(kv_dtype):
    """A seeded, staggered, mid-run-drained fleet of worker processes (free
    running, tokens through framed RPC polls) emits the single engine's
    streams."""
    cfg = BIG_CFG.replace(kv_cache_dtype=kv_dtype)
    params = _big_params(cfg)
    prompts = _prompts([6, 9, 4, 7], cfg=cfg, rng=np.random.default_rng(21))
    gens = [48, 96, 8, 6]
    samplings = [_sampling(i) for i in range(4)]
    sequential = _sequential(params, prompts, gens, samplings, cfg=cfg, max_seq_len=128)

    ecfg = EngineConfig(max_slots=2, max_seq_len=128)
    fleet = _spawn_fleet(2, ecfg, overrides={"kv_cache_dtype": kv_dtype})
    router = None
    try:
        _warm(fleet)
        router = Router(transports=fleet, router_cfg=RouterConfig(handoff_threshold=0))
        reqs = []
        for i in range(4):
            reqs.append(router.submit(prompts[i], gens[i], session=str(i % 2),
                                      sampling=samplings[i],
                                      want_logprobs=2 if i == 0 else None, strict=True))
            router.step()
        victim = reqs[1].hosts[0]
        assert reqs[0].hosts[0] != victim
        deadline = time.monotonic() + WAIT_S
        while not 0 < len(reqs[1].tokens) < reqs[1].max_new_tokens:
            router.step()
            assert time.monotonic() < deadline, "req 1 never got mid-decode"
        router.drain(victim)
        router.run_until_complete()

        assert [list(r.tokens) for r in reqs] == sequential
        assert len(reqs[1].hosts) > 1
        assert len(reqs[0].logprobs) == len(reqs[0].tokens)
        assert all(len(row) >= 2 for row in reqs[0].top_logprobs)
        s = router.stats()
        assert s["router"]["drains"] == 1 and s["router"]["handoffs"] >= 1
        assert s["router"]["hosts_lost"] == 0
        assert [t["kind"] for t in s["router"]["transport"]] == ["subprocess"] * 2
        assert s["fleet"]["tokens_generated"] >= sum(gens)
    finally:
        _close(router, fleet)
    assert all(t.proc.poll() is not None for t in fleet)


def test_sigkill_mid_decode_recovers_bit_identically():
    """SIGKILL one worker while it decodes: the router detects the loss on
    the next RPC, re-places the dead host's streams as continuations from
    the harvested tokens, and the streams equal the single engine's; the
    un-harvested tokens died with the process and were regenerated."""
    params = _big_params(BIG_CFG)
    prompts = _prompts([6, 5, 7, 4], rng=np.random.default_rng(22))
    gens = [96, 80, 96, 80]
    samplings = [_sampling(i) for i in range(4)]
    sequential = _sequential(params, prompts, gens, samplings, cfg=BIG_CFG, max_seq_len=128)

    fleet = _spawn_fleet(2, EngineConfig(max_slots=2, max_seq_len=128))
    router = None
    try:
        _warm(fleet)
        router = Router(transports=fleet, router_cfg=RouterConfig(handoff_threshold=0))
        reqs = [router.submit(prompts[i], gens[i], session=str(i % 2),
                              sampling=samplings[i], strict=True) for i in range(4)]
        victim = reqs[1].hosts[0]
        victim_reqs = [r for r in reqs if r.hosts[0] == victim]
        survivor = next(h for h in (0, 1) if h != victim)
        assert victim_reqs and len(victim_reqs) < 4
        victim_pid = fleet[victim].pid
        deadline = time.monotonic() + WAIT_S
        while not any(0 < len(r.tokens) < r.max_new_tokens for r in victim_reqs):
            router.step()
            assert time.monotonic() < deadline, "victim never got mid-decode"
        os.kill(victim_pid, signal.SIGKILL)
        router.run_until_complete()

        assert [list(r.tokens) for r in reqs] == sequential
        s = router.stats()["router"]
        assert s["lost"] == [victim] and s["hosts_lost"] == 1
        assert s["recovered"] >= 1
        assert all(r.hosts[-1] == survivor for r in victim_reqs)
    finally:
        _close(router, fleet)
    assert all(t.proc.poll() is not None for t in fleet)


def test_flaky_frames_retry_and_error_semantics():
    """On a live worker channel: a dropped reply retries an idempotent call
    (fresh seq, counted); a stale-seq frame is discarded; a dropped reply on
    a non-idempotent call raises TransportError instead of retrying."""
    fleet = _spawn_fleet(1, EngineConfig(max_slots=2, max_seq_len=32))
    t = fleet[0]
    try:
        chan = t.chan
        real_recv = chan.recv

        state = {"drops": 1}

        def dropping_recv(timeout=None):
            if state["drops"] > 0:
                state["drops"] -= 1
                raise TransportError("injected drop")
            return real_recv(timeout)
        chan.recv = dropping_recv
        assert t.load() == 0
        assert t.metrics.retries == 1 and t.metrics.errors == 1
        chan.recv = real_recv

        state2 = {"extra": 1}

        def duplicating_recv(timeout=None):
            if state2["extra"] > 0:
                state2["extra"] -= 1
                return {"seq": -12345, "ok": True, "val": 987654}
            return real_recv(timeout)
        chan.recv = duplicating_recv
        assert t.would_accept(4, 4) is True
        chan.recv = real_recv

        errors_before = t.metrics.errors

        def always_drop(timeout=None):
            raise TransportError("injected drop")
        chan.recv = always_drop
        with pytest.raises(TransportError):
            t.submit(_prompts([4])[0], 4)
        assert t.metrics.errors == errors_before + 1
        chan.recv = real_recv
        assert t.probe() is True
    finally:
        t.close()
    assert t.proc.poll() is not None


def test_lost_host_never_double_emits_over_flaky_transport():
    """Break the channel under a live stream: the host goes lost and the
    stream re-admits elsewhere, equal to the single engine's, with the
    harvested prefix kept and no token twice."""
    params = _big_params(BIG_CFG)
    prompts = _prompts([6, 5], rng=np.random.default_rng(13))
    gens = [96, 24]
    samplings = [None, None]
    sequential = _sequential(params, prompts, gens, samplings, cfg=BIG_CFG, max_seq_len=128)

    fleet = _spawn_fleet(2, EngineConfig(max_slots=2, max_seq_len=128))
    router = None
    try:
        _warm(fleet)
        router = Router(transports=fleet, router_cfg=RouterConfig(handoff_threshold=0))
        reqs = [router.submit(prompts[i], gens[i], session=str(i), sampling=samplings[i],
                              strict=True) for i in range(2)]
        victim = reqs[0].hosts[0]
        deadline = time.monotonic() + WAIT_S
        while not 0 < len(reqs[0].tokens) < reqs[0].max_new_tokens:
            router.step()
            assert time.monotonic() < deadline
        harvested_prefix = list(reqs[0].tokens)
        fleet[victim].chan.sock.close()
        router.run_until_complete()

        assert [list(r.tokens) for r in reqs] == sequential
        assert reqs[0].tokens[:len(harvested_prefix)] == harvested_prefix
        s = router.stats()["router"]
        assert s["hosts_lost"] == 1 and s["recovered"] >= 1
    finally:
        _close(router, fleet)
    assert all(t.proc.poll() is not None for t in fleet)
