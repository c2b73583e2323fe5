"""Seeded sampling, stop sequences, logprobs and ``embed``: the port
(repro_torch.serving.sampling and the Engine) against the JAX package.

  * threefry — the key of fold_in(PRNGKey(seed), position), the random bits
    and the uniform are BITWISE jax.random's; the Gumbel value is within
    GUMBEL_ULPS units of f32 epsilon times max(1, |g|) of it (torch's and
    XLA's ``log`` differ in the last bit: 1.81 measured over 160 keys at
    V = 32000).
  * sample_tokens — the same tokens as the JAX function on 64 seeded rows
    per case over a grid of (temperature, top_k, top_p, repetition
    penalty, presence), and ports of the reference's unit cases, each also
    held to the JAX function on its inputs.
  * logprob_info — within LP_TOL of the JAX function, top ids equal
    wherever the values differ.
  * engine parity — mixed sampled (even requests) and greedy (odd) traffic
    with stop sequences and ``want_logprobs=5`` through the reference
    Engine (a subprocess, ``XLA_FLAGS=--xla_allow_excess_precision=false``,
    tests/_torch_parity.py) and the port's, in the f32 compute dtype with
    float weights, on every store route, int8 KV, chunked prefill and the
    prefix cache: token streams, finish reasons and ``stop_hits`` equal,
    logprobs within LP_TOL. The stop sequences come from a probe run of the
    same traffic without stops, so that they fire. Float weights, because
    W8A8 turns the last-bit differences of the two libraries' transcendentals
    (layer 0's RoPE: 4.8e-7 in K) into whole int8 activation codes, which
    moved a smoke prompt's logits by 0.026; a sampled token whose Gumbel
    margin is below that may then differ, where greedy streams are held to
    the reference by tests/_torch_parity.py's margin rule. Inside the port,
    each seeded stream served alone equals its stream in the batch.
  * embed — the port's ``Engine.embed`` against the reference's: embedding
    and logits within EMBED_TOL (the reference's embed forward is its
    training attention, the port's its prefill's).
"""

import itertools
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import _torch_parity as P  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

from repro.serving import sampling as J  # noqa: E402
from repro_torch.core.opq import to_device  # noqa: E402
from repro_torch.serving import sampling as S  # noqa: E402

GUMBEL_ULPS = 4.0
LP_TOL = 1e-5
EMBED_TOL = 1e-4
RNG = np.random.default_rng(11)
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# threefry, fold_in, bits, uniform, gumbel
# ---------------------------------------------------------------------------

def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), pos)


@pytest.mark.parametrize("vocab", [32000, 256])
@pytest.mark.parametrize("pos", [0, 1, 127, 2047])
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**32 - 1])
def test_threefry_bits_uniform_gumbel_match_jax(seed, pos, vocab):
    key = _jax_key(seed, pos)
    tkey = S.fold_in(torch.tensor([seed]), torch.tensor([pos]))
    assert [int(w[0]) for w in tkey] == [int(w) for w in np.asarray(key)]
    bits = np.asarray(jax.random.bits(key, (vocab,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(S.random_bits(tkey, vocab)[0].numpy(), bits)
    tiny = np.finfo(np.float32).tiny
    u = np.asarray(jax.random.uniform(key, (vocab,), jnp.float32, minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(S.uniform(tkey, vocab)[0].numpy().view(np.int32),
                                  u.view(np.int32))
    g = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32)).astype(np.float64)
    tg = S.gumbel(tkey, vocab)[0].numpy().astype(np.float64)
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(tg - g) <= GUMBEL_ULPS * eps * np.maximum(1.0, np.abs(g)))


def test_threefry_batches_rows_independently():
    """A batch of (seed, position) pairs gives each row the bits it gets
    alone: the noise is a function of the row's own pair only."""
    seeds, pos = torch.tensor([3, 2**32 - 1, 3]), torch.tensor([5, 9, 6])
    batch = S.random_bits(S.fold_in(seeds, pos), 300)
    for i in range(3):
        alone = S.random_bits(S.fold_in(seeds[i:i + 1], pos[i:i + 1]), 300)
        assert torch.equal(batch[i], alone[0])


# ---------------------------------------------------------------------------
# sample_tokens against the JAX function
# ---------------------------------------------------------------------------

def _params(kw_list, mod):
    return [mod.SamplingParams(**kw) for kw in kw_list]


def _both(logits, kw_list, positions, presence=None):
    """(JAX tokens, port tokens) of one batch."""
    logits = np.asarray(logits, np.float32)
    if presence is None:
        presence = np.zeros(logits.shape, bool)
    jt = J.sample_tokens(jnp.asarray(logits), J.stack_params(_params(kw_list, J), presence),
                         jnp.asarray(positions, jnp.int32))
    sp = to_device(S.stack_params(_params(kw_list, S), presence), CPU)
    tt = S.sample_tokens(torch.from_numpy(logits), sp,
                         torch.as_tensor(np.asarray(positions, np.int32)))
    return np.asarray(jt), tt.numpy()


GRID = list(itertools.product([0.0, 0.5, 1.0, 1.7], [0, 1, 5, 40], [1.0, 0.9, 0.3],
                              [1.0, 1.3]))


@pytest.mark.parametrize("vocab", [256, 32000])
@pytest.mark.parametrize("case", range(3))
def test_sample_tokens_matches_jax_over_a_grid(case, vocab):
    rng = np.random.default_rng(100 + case)
    B = 64
    logits = (rng.standard_normal((B, vocab)) * 3).astype(np.float32)
    kws = [dict(temperature=t, top_k=k, top_p=p, repetition_penalty=r,
                seed=int(rng.integers(0, 2**32)))
           for t, k, p, r in (GRID[i] for i in rng.integers(0, len(GRID), B))]
    presence = rng.random((B, vocab)) < 0.1
    pos = rng.integers(0, 2048, B)
    jt, tt = _both(logits, kws, pos, presence)
    np.testing.assert_array_equal(tt, jt)


def test_top_k_one_is_greedy():
    logits = RNG.standard_normal((4, 64)).astype(np.float32)
    jt, tt = _both(logits, [dict(temperature=0.9, top_k=1, seed=s) for s in (0, 1, 7, 123)],
                   np.arange(4))
    np.testing.assert_array_equal(tt, logits.argmax(-1))
    np.testing.assert_array_equal(tt, jt)


def test_tiny_top_p_is_greedy():
    logits = RNG.standard_normal((3, 32)).astype(np.float32)
    jt, tt = _both(logits, [dict(temperature=1.3, top_p=1e-6, seed=s) for s in (3, 5, 9)],
                   np.zeros(3))
    np.testing.assert_array_equal(tt, logits.argmax(-1))
    np.testing.assert_array_equal(tt, jt)


def test_greedy_rows_bit_exact_in_mixed_batch():
    logits = RNG.standard_normal((4, 48)).astype(np.float32)
    kws = [{}, dict(temperature=1.0, seed=4), dict(temperature=0.0, top_k=5, seed=9),
           dict(temperature=0.7, top_p=0.8, seed=2)]
    jt, tt = _both(logits, kws, np.arange(4))
    ref = logits.argmax(-1)
    assert tt[0] == ref[0] and tt[2] == ref[2]
    np.testing.assert_array_equal(tt, jt)
    # greedy batches skip the sampled pipeline and give the same tokens
    greedy = S.sample_tokens(torch.from_numpy(logits),
                             to_device(S.stack_params([S.GREEDY] * 4, np.zeros((4, 48), bool)),
                                       CPU), torch.arange(4))
    np.testing.assert_array_equal(greedy.numpy(), ref)


def test_repetition_penalty_flips_near_tie():
    row = np.full(16, -5.0, np.float32)
    row[3], row[7] = 2.0, 1.9
    presence = np.zeros((2, 16), bool)
    presence[0, 3] = True
    kw = dict(temperature=0.01, repetition_penalty=5.0, seed=0)
    jt, tt = _both(np.stack([row, row]), [kw, kw], np.zeros(2), presence)
    assert tt[0] == 7 and tt[1] == 3
    np.testing.assert_array_equal(tt, jt)


def test_sampled_token_respects_topk_mask():
    logits = RNG.standard_normal((8, 40)).astype(np.float32)
    order = np.argsort(-logits, axis=-1)
    kws = [dict(temperature=1.5, top_k=4, seed=s) for s in range(8)]
    for pos in range(6):
        jt, tt = _both(logits, kws, np.full(8, pos))
        np.testing.assert_array_equal(tt, jt)
        for b in range(8):
            assert tt[b] in order[b, :4]


def test_stop_match_is_suffix_only():
    assert S.stop_match([1, 2, 3], ((2, 3),)) == (2, 3)
    assert S.stop_match([1, 2, 3], ((1, 2),)) is None
    assert S.stop_match([1, 2, 3], ((9,), (3,))) == (3,)
    assert S.stop_match([1, 2], ((1, 2, 3),)) is None
    assert S.stop_match([1, 2], ()) is None


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5),
                dict(repetition_penalty=0.0), dict(stop=[[]])):
        with pytest.raises(ValueError):
            S.SamplingParams(**bad)
    assert S.SamplingParams(stop=5).stop == ((5,),)
    assert S.SamplingParams(stop=[[1, 2], 3]).stop == ((1, 2), (3,))
    sp = S.SamplingParams(temperature=0.8, top_k=3, top_p=0.5, repetition_penalty=1.2,
                          seed=9, stop=[[4, 5]])
    assert S.sampling_from_wire(S.sampling_to_wire(sp)) == sp
    assert S.sampling_to_wire(sp) == J.sampling_to_wire(J.SamplingParams(
        temperature=0.8, top_k=3, top_p=0.5, repetition_penalty=1.2, seed=9, stop=[[4, 5]]))


def _port_tokens(logits, kws, positions):
    sp = to_device(S.stack_params(_params(kws, S), np.zeros(logits.shape, bool)), CPU)
    return S.sample_tokens(torch.from_numpy(np.asarray(logits, np.float32)), sp,
                           torch.as_tensor(np.asarray(positions, np.int32))).numpy()


def test_sampled_row_ignores_batchmates_slot_and_padding():
    row = RNG.standard_normal((1, 64)).astype(np.float32)
    me = dict(temperature=0.9, top_k=12, top_p=0.9, seed=42)
    others = [dict(temperature=t, top_k=k, seed=s) for t, k, s in
              ((0.0, 0, 0), (1.7, 3, 9), (0.4, 0, 5))]
    for pos in (0, 3, 17):
        alone = int(_port_tokens(row, [me], [pos])[0])
        noise = RNG.standard_normal((3, 64)).astype(np.float32)
        first = _port_tokens(np.concatenate([row, noise]), [me] + others, [pos, 1, 2, 3])
        last = _port_tokens(np.concatenate([noise, row]), others + [me], [5, 6, 7, pos])
        assert int(first[0]) == alone == int(last[3])
        assert alone == int(_both(row, [me], [pos])[0][0])


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.05, max_value=2.0, allow_nan=False),
       st.integers(min_value=0, max_value=48),
       st.floats(min_value=0.05, max_value=1.0, allow_nan=False),
       st.integers(min_value=0, max_value=1000))
def test_property_batch_composition_never_changes_a_row(seed, temp, k, p, pos):
    rng = np.random.default_rng(seed ^ 0x5EED)
    row = rng.standard_normal((1, 48)).astype(np.float32)
    me = dict(temperature=float(temp), top_k=int(k), top_p=float(p), seed=int(seed))
    alone = int(_port_tokens(row, [me], [pos])[0])
    mates = rng.standard_normal((2, 48)).astype(np.float32)
    batch = _port_tokens(np.concatenate([mates[:1], row, mates[1:]]),
                         [{}, me, dict(temperature=1.0, seed=seed + 1)], [0, pos, 9])
    assert int(batch[1]) == alone
    assert alone == int(_both(row, [me], [pos])[0][0])


# ---------------------------------------------------------------------------
# logprob_info
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 320)])
def test_logprob_info_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    row = (rng.standard_normal(shape) * 4).astype(np.float32)
    row[..., 1] = row[..., 2]                              # a tie at the top
    row[..., 1] = row[..., 2] = row.max(-1) + 1.0
    vocab = shape[-1] - 6                                  # padded columns
    chosen = rng.integers(0, vocab, shape[:-1])
    ref = J.logprob_info(jnp.asarray(row), jnp.asarray(chosen, jnp.int32), vocab)
    got = S.logprob_info(torch.from_numpy(row), torch.from_numpy(chosen), vocab)
    np.testing.assert_allclose(got["lp"].numpy(), np.asarray(ref["lp"]), atol=LP_TOL, rtol=0)
    np.testing.assert_allclose(got["top_lps"].numpy(), np.asarray(ref["top_lps"]),
                               atol=LP_TOL, rtol=0)
    assert got["top_ids"].shape == tuple(shape[:-1]) + (S.TOP_LOGPROBS,)
    _check_top_ids(got["top_ids"].numpy(), np.asarray(ref["top_ids"]),
                   np.asarray(ref["top_lps"]))
    assert np.all(got["top_ids"].numpy() < vocab)


def _check_top_ids(got, ref, ref_lps):
    """Top ids equal wherever the value at that rank differs from both its
    neighbours (ties may list their ids in another order)."""
    lps = ref_lps.reshape(-1, ref_lps.shape[-1])
    g, r = got.reshape(lps.shape), ref.reshape(lps.shape)
    for i in range(lps.shape[0]):
        for j in range(lps.shape[1]):
            tied = (j > 0 and lps[i, j] == lps[i, j - 1]) or (
                j + 1 < lps.shape[1] and lps[i, j] == lps[i, j + 1])
            if tied:
                assert set(g[i][lps[i] == lps[i, j]]) == set(r[i][lps[i] == lps[i, j]])
            else:
                assert g[i, j] == r[i, j], (i, j)


# ---------------------------------------------------------------------------
# engine parity: the reference Engine (subprocess) against the port's
# ---------------------------------------------------------------------------

ROUTES = {
    "contiguous": ({"cache_backend": "contiguous"}, "bfloat16"),
    "bridge": ({"cache_backend": "paged"}, "bfloat16"),
    "native_plain": ({"cache_backend": "paged", "paged_native": True}, "bfloat16"),
    "native_kernel": ({"cache_backend": "paged", "paged_native": True,
                       "paged_kernel": True}, "bfloat16"),
    "int8_kv": ({"cache_backend": "paged", "paged_native": True}, "int8"),
    "chunked": ({"cache_backend": "paged", "paged_native": True, "prefill_chunk": 8},
                "bfloat16"),
    "prefix_cache": ({"cache_backend": "paged", "paged_native": True,
                      "prefix_cache": True}, "bfloat16"),
}
DTYPE = "float32"
GEN = 24
TRAFFIC = {"plain": P.traffic([5, 9, 12, 7], GEN),
           "preamble": P.traffic([12, 17, 20, 14], GEN, seed=8, preamble=8)}
EMBED_PROMPTS = [P.traffic([n], 1, seed=9)[0][0] for n in (7, 16, 23)]


def _traffic_of(name):
    return TRAFFIC["preamble" if name == "prefix_cache" else "plain"]


def _sampling_kw(i, stops):
    """Request i's SamplingParams fields: the CLI's mix (even requests
    sample with seed 100 + i, odd ones greedy), one request with a
    repetition penalty, every request with the stop sequences."""
    if i % 2 == 0:
        return dict(temperature=0.8, top_k=50, top_p=0.9, seed=100 + i,
                    repetition_penalty=1.3 if i == 2 else 1.0, stop=stops)
    return dict(stop=stops)


def _stops_from(streams):
    """Stop sequences that fire: a greedy request's 7th token alone, and a
    sampled request's 9th and 10th tokens as a pair."""
    return ((int(streams[1][6]),), (int(streams[0][8]), int(streams[0][9])))


def _serve_case(Engine, EngineConfig, SP, cfg, params, ecfg, prompts, gens, stops, **kw):
    eng = Engine(cfg, params, EngineConfig(**{**P.BASE_ECFG, **ecfg}), **kw)
    it = itertools.count()

    def submit(e, p, g):
        return e.submit(p, g, sampling=SP(**_sampling_kw(next(it), stops)), want_logprobs=5)
    reqs, census = P.drive(eng, submit, prompts, gens, eng.store.kind == "paged")
    stats = eng.stats()
    eng.close()
    return {"tokens": [list(r.tokens) for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "logprobs": [list(r.logprobs) for r in reqs],
            "top": [[[(int(t), float(v)) for t, v in row] for row in r.top_logprobs]
                    for r in reqs],
            "stop_hits": stats["stop_hits"], "sampled_tokens": stats["sampled_tokens"],
            "flags": dict(stats["opq"]["flags"]), "census": census}


def _reference():
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.models import init_model
    from repro.serving import Engine, EngineConfig, SamplingParams
    base = get_config("tinyllama-1.1b").smoke().replace(dtype=DTYPE)
    out = {}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = init_model(base, jax.random.PRNGKey(0))
        out["params"] = P._numpy_tree(params)
        stops = {}
        for traffic, (prompts, gens) in TRAFFIC.items():
            probe = _serve_case(Engine, EngineConfig, SamplingParams, base, params,
                                {"cache_backend": "contiguous"}, prompts, gens, ())
            stops[traffic] = _stops_from(probe["tokens"])
        out["stops"] = stops
        for name, (ecfg, kv) in ROUTES.items():
            traffic = "preamble" if name == "prefix_cache" else "plain"
            out[name] = _serve_case(Engine, EngineConfig, SamplingParams,
                                    base.replace(kv_cache_dtype=kv), params, ecfg,
                                    *TRAFFIC[traffic], stops[traffic])
        eng = Engine(base, params, EngineConfig(**P.BASE_ECFG))
        out["embed"] = [{k: np.asarray(v) for k, v in eng.embed(p).items()}
                        for p in EMBED_PROMPTS]
        out["embed_flags"] = dict(eng.stats()["opq"]["flags"])
        eng.close()
    return out


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("ref") / "sampling.pkl")


@pytest.fixture(scope="module")
def params(references):
    from repro_torch.testing.params import params_from_numpy
    return params_from_numpy(references["params"], device="cpu")


def _port_cfg(kv="bfloat16"):
    from repro_torch.configs import get_config
    return get_config("tinyllama-1.1b").smoke().replace(dtype=DTYPE,
                                                       kv_cache_dtype=kv)


@pytest.fixture(scope="module")
def ports(references, params):
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    out = {}
    for name, (ecfg, kv) in ROUTES.items():
        traffic = "preamble" if name == "prefix_cache" else "plain"
        out[name] = _serve_case(Engine, EngineConfig, SamplingParams, _port_cfg(kv), params,
                                ecfg, *TRAFFIC[traffic], references["stops"][traffic],
                                device="cpu")
    return out


@pytest.mark.parametrize("name", list(ROUTES))
def test_engine_streams_stops_and_logprobs_match_reference(references, ports, name):
    ref, got = references[name], ports[name]
    assert got["tokens"] == ref["tokens"]
    assert got["finish"] == ref["finish"]
    assert "stop" in got["finish"] and got["stop_hits"] == ref["stop_hits"] > 0
    assert got["sampled_tokens"] == ref["sampled_tokens"] > 0
    assert got["flags"] == ref["flags"]
    assert got["census"] == ref["census"]
    for r_lp, g_lp, r_top, g_top in zip(ref["logprobs"], got["logprobs"], ref["top"],
                                        got["top"]):
        assert len(g_lp) == len(r_lp) == len(g_top)
        np.testing.assert_allclose(g_lp, r_lp, atol=LP_TOL, rtol=0)
        r_ids = np.asarray([[t for t, _ in row] for row in r_top])
        r_vals = np.asarray([[v for _, v in row] for row in r_top])
        g_ids = np.asarray([[t for t, _ in row] for row in g_top])
        np.testing.assert_allclose([[v for _, v in row] for row in g_top], r_vals,
                                   atol=LP_TOL, rtol=0)
        _check_top_ids(g_ids, r_ids, r_vals)


def test_greedy_logprob_is_the_top_logprob(ports):
    """A greedy token's logprob is the largest of its row."""
    got = ports["native_kernel"]
    for i in range(1, len(got["tokens"]), 2):                  # greedy requests
        for lp, top in zip(got["logprobs"][i], got["top"][i]):
            assert lp == top[0][1]


@pytest.mark.parametrize("name", ["contiguous", "native_kernel", "prefix_cache"])
def test_seeded_stream_alone_equals_batched(references, ports, params, name):
    """Each request served again alone (a one-slot engine) gets the stream
    it got in the staggered batch: its noise depends on (seed, position)
    only, never on its batchmates or its slot."""
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    ecfg, kv = ROUTES[name]
    traffic = "preamble" if name == "prefix_cache" else "plain"
    prompts, gens = TRAFFIC[traffic]
    eng = Engine(_port_cfg(kv), params, EngineConfig(**{**P.BASE_ECFG, **ecfg,
                                                        "max_slots": 1}), device="cpu")
    for i, (p, g) in enumerate(zip(prompts, gens)):
        req = eng.submit(p, g, sampling=SamplingParams(
            **_sampling_kw(i, references["stops"][traffic])))
        eng.run_until_complete()
        assert list(req.tokens) == ports[name]["tokens"][i], i
    eng.close()


def test_embed_matches_reference_and_the_prefill_row(references, params):
    from repro_torch.models import serve as SV, steps as ST
    from repro_torch.serving import Engine, EngineConfig
    cfg = _port_cfg()
    eng = Engine(cfg, params, EngineConfig(**P.BASE_ECFG), device="cpu")
    prefill = ST.make_prefill_with_cache_step(cfg)
    for prompt, ref in zip(EMBED_PROMPTS, references["embed"]):
        got = eng.embed(prompt)
        assert got["embedding"].shape == (cfg.d_model,) and got["logits"].shape == (cfg.vocab,)
        np.testing.assert_allclose(got["embedding"], ref["embedding"], atol=EMBED_TOL, rtol=0)
        np.testing.assert_allclose(got["logits"], ref["logits"], atol=EMBED_TOL, rtol=0)
        # the logits row is the fused prefill's, bit for bit
        bucket = 16 if len(prompt) <= 16 else 32
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(prompt)] = prompt
        first, _ = prefill(params, torch.from_numpy(toks),
                           torch.tensor([len(prompt) - 1], dtype=torch.int32))
        logits, _ = SV.prefill_with_cache(params, cfg, torch.from_numpy(toks))
        assert np.array_equal(got["logits"], logits[0, len(prompt) - 1, :cfg.vocab].numpy())
        assert int(np.argmax(got["logits"])) == int(first[0])
    stats = eng.stats()
    eng.close()
    assert stats["embed_requests"] == len(EMBED_PROMPTS)
    assert stats["opq"]["flags"] == references["embed_flags"]
    with pytest.raises(ValueError, match="non-empty"):
        Engine(cfg, params, EngineConfig(**P.BASE_ECFG), device="cpu").embed([])


def test_submit_checks_and_stop_history(params):
    """``want_logprobs`` past the capture width is refused at the door; a
    stop sequence that began in ``stop_history`` (an earlier segment of the
    stream) fires on the first generated token that completes it."""
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    eng = Engine(_port_cfg(), params, EngineConfig(**P.BASE_ECFG), device="cpu")
    with pytest.raises(ValueError, match="want_logprobs"):
        eng.submit([1, 2, 3], 4, want_logprobs=S.TOP_LOGPROBS + 1)
    first = eng.submit([1, 2, 3], 6)
    eng.run_until_complete()
    t0 = first.tokens[0]
    req = eng.submit([1, 2, 3], 6, sampling=SamplingParams(stop=[[255, t0]]),
                     stop_history=[255])
    eng.run_until_complete()
    eng.close()
    assert req.tokens == [t0] and req.finish_reason == "stop"
    assert first.finish_reason == "length"


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
