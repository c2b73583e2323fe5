"""The port's SlotStore layer (repro_torch.serving.store) and the routes
through it, on the CPU at smoke widths: the counterparts of the reference's
store tests (tests/test_serving.py, tests/test_prefix_cache.py) and the
bit-identity invariants of docs/architecture.md held inside the port.

Bitwise, never allclose, for bf16 and int8 KV:
  * contiguous == paged gather bridge == block-native without the kernel:
    tokens, and cache entries on every valid position;
  * chunked prefill == fused prefill: first tokens, seeded cache, stream;
  * a prefix-cache hit == a cold admission: tokens and cache entries;
  * a reset slot == a freshly allocated one (``pristine_value``);
  * every step run twice (an OPQ backup re-issue) == run once.
The block census of the port's paged store equals the reference store's
after every operation of a seeded random lifecycle.
"""

import threading
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving.store import PagedKVStore as JPagedKVStore
from repro_torch.configs import get_config
from repro_torch.core import opq as topq
from repro_torch.core import tensorizer as tz
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import init_model
from repro_torch.serving import (ContiguousKVStore, Engine, EngineConfig, PagedKVStore,
                                 format_memory_stats, make_store, pristine_value)
from repro_torch.serving.kv import KVSlotManager
from repro_torch.serving.store import RecurrentStateStore

CFG = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
KV_DTYPES = ["bfloat16", "int8"]
ROUTES = {
    "contiguous": {"cache_backend": "contiguous"},
    "bridge": {"cache_backend": "paged", "block_size": 8},
    "native_plain": {"cache_backend": "paged", "block_size": 8, "paged_native": True},
}


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return tz.quantize_params(init_model(CFG, gen), predicate=quant_predicate)


def _prompts(lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,), dtype=np.int32) for n in lens]


def _engine(params, kv_dtype="bfloat16", opq=None, **kw):
    ecfg = EngineConfig(**{"max_slots": 2, "max_seq_len": 32, **kw})
    return Engine(CFG.replace(kv_cache_dtype=kv_dtype), params, ecfg, device="cpu", opq=opq)


def _staggered(eng, prompts, gens):
    """Two joins mid-flight, the rest queued behind them; returns the
    requests and the contiguous view of the cache after the second step."""
    reqs = [eng.submit(prompts[0], gens[0])]
    eng.step()
    reqs.append(eng.submit(prompts[1], gens[1]))
    eng.step()
    view = {n: t.clone() for n, t in eng.store.gather_view().items()}
    reqs += [eng.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]
    eng.run_until_complete()
    return reqs, view


def _valid_equal(a, b):
    for slot, n in enumerate(a["index"].tolist()):
        for name in a:
            if name != "index":
                assert torch.equal(a[name][:, slot, :n], b[name][:, slot, :n]), (name, slot)


# ------------------------------------------------------ route bit-identity

@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_contiguous_bridge_native_plain_bit_identical(params, kv_dtype):
    """The SlotStore invariant: the same staggered traffic through the
    contiguous rows, the paged gather bridge and block-native decode without
    the kernel gives the same tokens and the same cache entries on every
    valid position."""
    prompts, gens = _prompts([5, 9, 4, 7]), [6, 5, 8, 3]
    runs = {}
    for route, kw in ROUTES.items():
        eng = _engine(params, kv_dtype, **kw)
        reqs, view = _staggered(eng, prompts, gens)
        runs[route] = ([r.tokens for r in reqs], view, eng.stats()["opq"]["flags"])
        eng.close()
    for route in ("bridge", "native_plain"):
        assert runs[route][0] == runs["contiguous"][0], route
        assert runs[route][2] == runs["contiguous"][2], route
        _valid_equal(runs[route][1], runs["contiguous"][1])
    assert set(runs["contiguous"][1]) == {"k", "v", "index"} | (
        {"k_scale", "v_scale"} if kv_dtype == "int8" else set())


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_chunked_prefill_bit_identical_to_fused(params, kv_dtype):
    """Prompts admitted by the chunked scan (8-token chunks; 20 is past the
    widest fused bucket, 8) give the fused path's first tokens, seeded cache
    (every leaf, pad tails included) and continuation, bitwise."""
    prompts, gens = _prompts([5, 9, 4, 20]), [6, 5, 8, 3]
    eng_f = _engine(params, kv_dtype)
    eng_c = _engine(params, kv_dtype, buckets=(8,), prefill_chunk=8)
    reqs_f = [eng_f.submit(p, g) for p, g in zip(prompts, gens)]
    reqs_c = [eng_c.submit(p, g) for p, g in zip(prompts, gens)]
    eng_f._admit()
    eng_c._admit()
    for name in eng_f.store.cache:
        assert torch.equal(eng_f.store.cache[name], eng_c.store.cache[name]), name
    eng_f.run_until_complete()
    eng_c.run_until_complete()
    assert [r.tokens for r in reqs_c] == [r.tokens for r in reqs_f]
    flags = eng_c.stats()["opq"]["flags"]
    assert flags["prefill_chunked/24"] == 1 and flags["prefill/8"] >= 1
    eng_f.close()
    eng_c.close()


def test_long_prompt_admits_only_with_chunking(params):
    prompt = _prompts([20])[0]
    eng = _engine(params, buckets=(8,))
    assert eng.submit(prompt, 5) is None             # 20 > the widest bucket
    eng.close()
    eng = _engine(params, buckets=(8,), prefill_chunk=8, cache_backend="paged",
                  block_size=8, paged_native=True, paged_kernel=True)
    req = eng.submit(prompt, 5)
    eng.run_until_complete()
    assert req.done and eng.stats()["cache"]["decode_view_bytes"] == 0
    eng.close()


def _snapshot(eng, prompt, gen):
    """One request: admit + one decode, its slot's valid cache rows, drain."""
    req = eng.submit(prompt, gen, strict=True)
    eng.step()
    slot = next(s for s, r in eng.scheduler.active.items() if r.id == req.id)
    view = eng.store.gather_view()
    n = int(view["index"][slot])
    row = {k: t[:, slot, :n].clone() for k, t in view.items() if k != "index"}
    eng.run_until_complete()
    return req.tokens, row


def _prefix_ecfg(prefix, **kw):
    return {"cache_backend": "paged", "block_size": 8, "paged_native": True,
            "prefix_cache": prefix, **kw}


@pytest.mark.parametrize("chunk", [None, 8], ids=["one_piece", "chunked"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_prefix_hit_bit_identical_to_cold(params, kv_dtype, chunk):
    """Admissions that lease cached preamble blocks and prefill only the
    suffix (in one piece, or in pieces of ``prefill_chunk`` beside a cold
    chunked scan) give a cold admission's tokens and cache entries,
    bitwise."""
    rng = np.random.default_rng(5)
    pre = rng.integers(0, CFG.vocab, (16,), dtype=np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, CFG.vocab, (8,), dtype=np.int32)])
               for _ in range(3)]
    hot = _engine(params, kv_dtype, prefill_chunk=chunk, **_prefix_ecfg(True))
    cold = _engine(params, kv_dtype, prefill_chunk=chunk, **_prefix_ecfg(False))
    for p in prompts:
        th, rh = _snapshot(hot, p, 5)
        tc, rc = _snapshot(cold, p, 5)
        assert th == tc
        for name in rc:
            assert torch.equal(rh[name], rc[name]), name
    s = hot.stats()
    assert s["prefix_hits"] == 2 and s["prefix_blocks_reused"] == 4
    assert s["prefix_tokens_reused"] == 32 and s["cache"]["prefix_hits"] == 2
    bucket = 24 if chunk else 32
    assert s["opq"]["flags"][f"prefill_prefix/{bucket}"] == 2
    # block-size chunks computed: the cold bucket whole, each hit past its 2
    assert s["prefill_chunks"] == bucket // 8 + 2 * (bucket // 8 - 2)
    hot.close()
    cold.close()


def test_cow_fork_mid_block_preserves_cached_original(params):
    """A prompt diverging MID-block forks the divergence block before its
    slot writes into it: the forked request equals cold, and the cached
    original still serves a later full-match hit bit-intact."""
    A = _prompts([24], seed=3)[0]                     # 3 full blocks
    B = A[:20].copy()                                 # 2 blocks + 4 of block 2
    hot = _engine(params, **_prefix_ecfg(True))
    cold = _engine(params, **_prefix_ecfg(False))
    for p in (A, B, A):
        th, rh = _snapshot(hot, p, 5)
        tc, rc = _snapshot(cold, p, 5)
        assert th == tc
        for name in rc:
            assert torch.equal(rh[name], rc[name]), name
    st = hot.stats()["cache"]
    assert st["cow_forks"] == 1 and st["prefix_hits"] == 2
    assert st["prefix_blocks_reused"] == 2 + 3
    hot.close()
    cold.close()


def test_buggy_scrub_of_shared_block_is_caught(params):
    """Teeth for the refcount-aware reset: with A and B in flight sharing
    cached preamble blocks, retiring A the pre-fix way (scrub every block on
    A's lease) corrupts B's view, which the bitwise comparison catches; the
    real reset leaves B's entries untouched."""
    rng = np.random.default_rng(9)
    pre = rng.integers(0, CFG.vocab, (16,), dtype=np.int32)
    pa, pb = (np.concatenate([pre, rng.integers(0, CFG.vocab, (8,), dtype=np.int32)])
              for _ in range(2))

    def spin_up():
        eng = _engine(params, **_prefix_ecfg(True))
        ra = eng.submit(pa, 8, strict=True)
        eng.step()
        rb = eng.submit(pb, 8, strict=True)
        eng.step()
        slots = {r.id: s for s, r in eng.scheduler.active.items()}
        b = slots[rb.id]
        before = {k: t[:, b].clone() for k, t in eng.store.gather_view().items()
                  if k != "index"}
        return eng, slots[ra.id], b, before

    def view_of(eng, b):
        return {k: t[:, b] for k, t in eng.store.gather_view().items() if k != "index"}

    eng, a, b, before = spin_up()
    assert eng.stats()["prefix_hits"] == 1
    eng.scheduler.retire(a)
    eng.store.reset(a)
    assert all(torch.equal(before[k], t) for k, t in view_of(eng, b).items())
    eng.close()

    eng, a, b, before = spin_up()
    eng.store._scrub_blocks(list(eng.store._leased[a]))      # the pre-fix retire
    assert not all(torch.equal(before[k], t) for k, t in view_of(eng, b).items())
    eng.close()


# -------------------------------------------------------- store lifecycle

def _census_ok(store):
    c = store.debug_block_census()
    everything = c["free"] + c["referenced"] + c["cached_unreferenced"]
    assert len(everything) == len(set(everything)), c
    assert sorted(everything) == list(range(1, store.n_blocks)), c
    leases = Counter(b for bs in store._leased.values() for b in bs)
    assert sorted(leases) == c["referenced"]
    for b, n in leases.items():
        assert store._ref[b] == n


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_block_conservation_under_random_lifecycle(seed):
    """Seeded random lease/commit/retire/drain traffic over a small pool
    with a tiny token alphabet (collisions, partial tails, forks and
    evictions all fire): after every operation the port's census is the
    reference store's, and the pool partitions into free / referenced /
    cached-unreferenced."""
    rng = np.random.default_rng(seed)
    kw = dict(n_slots=3, max_seq_len=16, block_size=4, n_blocks=10, prefix_cache=True)
    store = PagedKVStore(CFG, device="cpu", **kw)
    ref = JPagedKVStore(jget_config("tinyllama-1.1b").smoke(), **kw)
    for _ in range(60):
        op = int(rng.integers(0, 4))
        if op in (0, 3):
            slot = int(rng.integers(0, 3))
            if slot in store._leased:
                continue
            plen = int(rng.integers(1, 13))
            gen = int(rng.integers(1, 17 - plen))
            tokens = rng.integers(0, 3, (plen,), dtype=np.int32)
            ok = store.lease(slot, plen, gen, tokens=tokens)
            assert ok == ref.lease(slot, plen, gen, tokens=tokens)
            assert store.prefix_lease_info(slot) == ref.prefix_lease_info(slot)
            if ok and op == 0:
                store.commit_prefix(slot)
                ref.commit_prefix(slot)
        elif op == 1:
            leased = sorted(store._leased)
            if leased:
                slot = int(rng.choice(leased))
                store.reset(slot)
                ref.reset(slot)
        else:
            for slot in sorted(store._leased):
                store.reset(slot)
                ref.reset(slot)
        _census_ok(store)
        assert store.debug_block_census() == ref.debug_block_census()
        assert np.array_equal(store._tables, ref._tables)
    assert (store.prefix_hits, store.prefix_evictions, store.cow_forks) == (
        ref.prefix_hits, ref.prefix_evictions, ref.cow_forks)


def test_paged_pool_exhaustion_evicts_cached_prefixes_before_refusal(params):
    """A dry pool whose only spare block is a retired request's cached
    prompt block: a non-matching request admits by evicting it (no
    deferral, no livelock), with the tokens the contiguous store gives."""
    pa, pb = _prompts([8, 8])
    eng = _engine(params, max_seq_len=16, cache_backend="paged", block_size=8,
                  n_blocks=3, prefix_cache=True)
    ra = eng.submit(pa, 8, strict=True)
    eng.run_until_complete()
    ms = eng.store.memory_stats()
    assert ms["prefix_cached_blocks"] == 1 and ms["blocks_free"] == 1
    assert eng.store.available_now(8, 8)
    rb = eng.submit(pb, 8, strict=True)
    eng.run_until_complete()
    s = eng.stats()
    assert s["completed"] == 2 and s["admissions_deferred"] == 0
    assert eng.store.prefix_evictions == 1
    eng.close()
    eng_c = _engine(params, max_seq_len=16)
    toks = []
    for p in (pa, pb):
        r = eng_c.submit(p, 8, strict=True)
        eng_c.run_until_complete()
        toks.append(r.tokens)
    assert [ra.tokens, rb.tokens] == toks
    eng_c.close()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_reset_slot_equals_fresh_store(backend, kv_dtype):
    """A store written with junk and retired is bit-equal, leaf by leaf, to
    a fresh one, which holds the pristine fill everywhere."""
    cfg = CFG.replace(kv_cache_dtype=kv_dtype)
    store = make_store(cfg, 2, 16, backend=backend, block_size=8, device="cpu")
    fresh = make_store(cfg, 2, 16, backend=backend, block_size=8, device="cpu")
    for name, leaf in fresh.cache.items():
        if name != "tables":
            assert torch.equal(leaf, torch.full_like(leaf, pristine_value(name))), name
    gen = torch.Generator().manual_seed(1)
    store.lease(0, 8, 8)
    kv = {}
    for name, leaf in store.cache.items():
        if name in ("index", "tables"):
            continue
        shape = (leaf.shape[0], 1, 8) + tuple(leaf.shape[3:])
        kv[name] = torch.randint(1, 5, shape, generator=gen).to(leaf.dtype)
    store.write_slots([0], kv, [8])
    assert not torch.equal(store.cache["k"], fresh.cache["k"])
    store.reset(0)
    for name in fresh.cache:
        assert torch.equal(store.cache[name], fresh.cache[name]), name


def test_make_store_backend_selection():
    assert isinstance(make_store(CFG, 2, 32, device="cpu"), ContiguousKVStore)
    assert isinstance(make_store(CFG, 2, 32, backend="paged", device="cpu"), PagedKVStore)
    with pytest.raises(ValueError, match="supports ssm/hybrid state caches, not dense"):
        make_store(CFG, 2, 32, backend="recurrent")
    # the ssm family (xlstm) gets the recurrent store, with its sentinels
    ssm = make_store(CFG.replace(family="ssm"), 2, 32, device="cpu")
    assert isinstance(ssm, RecurrentStateStore)
    assert bool((ssm.cache["mlstm_m"] == -60.0).all())
    with pytest.raises(ValueError, match="divide"):
        make_store(CFG, 2, 32, backend="paged", block_size=12)
    with pytest.raises(ValueError, match="unknown cache backend"):
        make_store(CFG, 2, 32, backend="mmap")
    with pytest.raises(ValueError, match="paged"):
        make_store(CFG, 2, 32, backend="contiguous", native=True)
    with pytest.raises(ValueError, match="paged"):
        make_store(CFG, 2, 32, backend="contiguous", prefix_cache=True)


def test_kvslotmanager_shim_warns():
    with pytest.warns(DeprecationWarning, match="make_store"):
        mgr = KVSlotManager(CFG, n_slots=2, max_seq_len=16)
    assert isinstance(mgr, ContiguousKVStore)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_store(CFG, 2, 16, backend="contiguous")


def test_memory_stats_surface(params):
    """memory_stats flows from the store through Engine.stats() to the
    report line; the bridge reports its transient view, native mode none."""
    stats = {}
    for name, kw in (("bridge", {}), ("native", {"paged_native": True})):
        eng = _engine(params, cache_backend="paged", block_size=8, **kw)
        eng.submit(_prompts([6])[0], 4)
        eng.step()
        ms = eng.stats()["cache"]
        assert ms["backend"] == "paged" and ms["blocks_used"] > 0
        assert ms["bytes"] == eng.store.nbytes() > 0
        line = format_memory_stats(ms)
        assert "paged" in line and "blocks" in line
        eng.run_until_complete()
        assert eng.stats()["cache"]["blocks_used"] == 0
        stats[name] = ms
        eng.close()
    assert stats["bridge"]["decode_view_bytes"] > 0
    assert stats["native"]["decode_view_bytes"] == 0
    assert stats["bridge"]["bytes"] == stats["native"]["bytes"]
    assert "contiguous" in format_memory_stats(make_store(CFG, 2, 32).memory_stats())


def test_paged_lease_batches_table_uploads():
    store = make_store(CFG, 4, 32, backend="paged", block_size=8)
    for slot in range(3):
        assert store.lease(slot, 8, 8)
    assert store.table_uploads == 0
    store.decode_cache()
    store.decode_cache()
    assert store.table_uploads == 1
    assert np.array_equal(store.cache["tables"].numpy(), store._tables)


# --------------------------------------------------------- engine config

@pytest.mark.parametrize("kw,match", [
    ({"paged_kernel": True, "cache_backend": "paged"}, "paged_kernel requires paged_native"),
    ({"paged_native": True}, "paged_native requires cache_backend='paged'"),
    ({"prefix_cache": True}, "prefix_cache .* requires cache_backend='paged'"),
    ({"prefill_chunk": 64}, r"prefill_chunk 64 must be in \[1, max_seq_len 32\]"),
    ({"cache_backend": "paged", "block_size": 12}, "must divide max_seq_len"),
    ({"cache_backend": "paged", "block_size": 8, "prefix_cache": True,
      "buckets": (12, 32)}, "to divide every prefill bucket"),
    ({"buckets": (64,)}, "exceeds max_seq_len"),
    ({"cache_backend": "recurrent"}, "supports ssm/hybrid state caches, not dense"),
])
def test_engine_rejects_bad_configs(params, kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(params, **kw)


def test_auto_backend_is_contiguous(params):
    eng = _engine(params)
    assert eng.store.kind == "contiguous"
    eng.close()


# ------------------------------------------------------ backup re-issue

class _ReissueExecutor:
    """Runs every instruction, then reports its first run as a straggler, so
    the OPQ re-issues it on the backup lane: each step runs twice. Counted
    per instruction, since admission dispatches several at once."""

    def __init__(self):
        self.runs = 0
        self._seen = []
        self._lock = threading.Lock()

    def __call__(self, ins, device):
        out = ins.fn(*(b.to_device(device) for b in ins.buffers))
        with self._lock:
            self.runs += 1
            first = not any(i is ins for i in self._seen)
            self._seen.append(ins)
        if first:
            raise topq._StragglerTimeout()
        return out


@pytest.mark.parametrize("route", ["contiguous", "bridge", "prefix_cow", "chunked"])
def test_backup_reissue_runs_steps_twice_without_effect(params, route):
    """Every prefill and decode step run twice — contiguous decode, the
    bridge's gather and write-back, a COW fork and suffix prefill over
    cached prefix rows, the chunked scan — leaves the tokens and the final
    cache unchanged."""
    kw = {"contiguous": ROUTES["contiguous"], "bridge": ROUTES["bridge"],
          "prefix_cow": _prefix_ecfg(True), "chunked": {"prefill_chunk": 8}}[route]
    A = _prompts([24], seed=4)[0]
    prompts = [A, _prompts([9])[0], A[:20].copy(), A[:12].copy()]

    def serve(opq=None):
        eng = _engine(params, opq=opq, **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run_until_complete()
        cache = {k: t.clone() for k, t in eng.store.cache.items()}
        stats = eng.stats()
        eng.close()
        return [r.tokens for r in reqs], cache, stats

    toks, cache, stats = serve()
    ex = _ReissueExecutor()
    opq = topq.OPQ([torch.device("cpu")], executor=ex)
    toks2, cache2, _ = serve(opq)
    assert opq.stats["backups_issued"] > 0 and ex.runs == 2 * opq.stats["issued"]
    assert toks2 == toks
    for name in cache:
        assert torch.equal(cache2[name], cache[name]), name
    if route == "prefix_cow":
        assert stats["cache"]["cow_forks"] >= 1 and stats["prefix_hits"] >= 2
    opq.shutdown()


def test_cli_routes_on_cpu(capsys):
    """The serve CLI's store routes: contiguous by default; the prefix cache
    over a shared half-prompt preamble with chunked prefill; the reference's
    flag checks."""
    from repro_torch.launch import serve as tserve
    base = ["--smoke", "--device", "cpu", "--quantize", "serve", "--slots", "2",
            "--stagger-steps", "2"]
    _, stats = tserve.run(base + ["--requests", "3", "--prompt-len", "8", "--gen", "8"])
    assert stats["cache"]["backend"] == "contiguous" and stats["completed"] == 3
    assert "[serve] cache: contiguous:" in capsys.readouterr().out
    reqs, stats = tserve.run(base + ["--requests", "4", "--prompt-len", "32", "--gen", "16",
                                     "--cache-backend", "paged", "--paged-native",
                                     "--prefix-cache", "--prefill-chunk", "16"])
    out = capsys.readouterr().out
    assert stats["prefix_hits"] == 3 and "[serve] prefix cache: 3 hits" in out
    assert all(r.prompt[:16].tolist() == reqs[0].prompt[:16].tolist() for r in reqs)
    assert any(f.startswith("prefill_prefix/") for f in stats["opq"]["flags"])
    with pytest.raises(SystemExit):
        tserve.run(base + ["--prefix-cache"])
