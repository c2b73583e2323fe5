"""The ssm family behind the port's Engine: xlstm-125m's smoke config (W8A8,
2 layers, and 4) on the recurrent state store.

  * staggered arrivals equal sequential serving (a port of
    tests/test_serving.py's ``test_ssm_staggered_matches_sequential``);
  * a retired slot leaks no state: its row is pristine again, the mLSTM
    and sLSTM sentinels included, and a request served through it decodes
    as on a fresh engine (``test_recurrent_slot_reset_has_teeth``);
  * the port's Engine against the reference Engine on the same weights
    (carried by ``params_from_numpy``), f32 and bf16: greedy tokens equal up
    to the first step whose reference top-2 logit margin falls below
    tests/_torch_parity.py's LOGIT_TOL (1e-4 in f32, 0.1 in bf16), OPQ flag
    counts identical; ``Engine.embed`` in f32 within 1e-4 of the
    reference's (tests/test_torch_sampling.py's bound);
  * speculative decode of a dense target (tinyllama's smoke config, the
    same vocab) with an xlstm draft: tokens bitwise plain decode's and the
    draft's slot index in lockstep with the target's after every step (a
    port of tests/test_speculative.py's
    ``test_recurrent_draft_bit_identical_and_lockstep``), and each slot's
    draft state a replay of its consumed tokens after every round;
  * the reference's refusals, with its messages: an xlstm speculative
    target, the contiguous and paged stores and chunked prefill;
  * the serve CLI on the recurrent backend, and with an xlstm draft.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``.
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
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import quant_predicate  # noqa: E402
from repro_torch.models import serve as SV  # noqa: E402
from repro_torch.models.model import init_model_quantized  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.store import make_store  # noqa: E402
from repro_torch.testing.params import params_from_numpy  # noqa: E402

CFG = get_config("xlstm-125m").smoke().replace(quantize="serve")
TARGET = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
LAYERS = [2, 4]
ECFG = dict(max_slots=2, max_seq_len=32)
EMBED_TOL = 1e-4
PARITY_GENS = (12, 10, 12)
EMBED_PROMPTS = [P.traffic([n], 1, seed=9)[0][0] for n in (7, 16)]


def _cfg(n_layers, **kw):
    return CFG.replace(n_layers=n_layers, **kw)


def _params(cfg, seed):
    return init_model_quantized(cfg, torch.Generator().manual_seed(seed), quant_predicate,
                                device="cpu")


@pytest.fixture(scope="module")
def xlstm_params():
    return {n: _params(_cfg(n), 3) for n in LAYERS}


def _traffic(lens=(5, 9, 4, 7), gens=(6, 5, 8, 3), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,), dtype=np.int32) for n in lens], list(gens)


def _row(cache, slot):
    return {n: (t[slot] if n == "index" else t[:, slot]) for n, t in cache.items()}


def _serve(cfg, params, prompts, gens, sequential=False, draft_params=None, **kw):
    eng = Engine(cfg, params, EngineConfig(**{**ECFG, **kw}), device="cpu",
                 draft_params=draft_params)
    if sequential:
        out = []
        for p, g in zip(prompts, gens):
            req = eng.submit(p, g)
            eng.run_until_complete()
            out.append(list(req.tokens))
    else:
        reqs = [eng.submit(prompts[0], gens[0])]
        eng.step()
        reqs.append(eng.submit(prompts[1], gens[1]))
        eng.step()
        reqs += [eng.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]
        eng.run_until_complete()
        out = [list(r.tokens) for r in reqs]
    stats = eng.stats()
    eng.close()
    return out, stats


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("n_layers", LAYERS)
def test_ssm_staggered_matches_sequential(xlstm_params, n_layers):
    cfg = _cfg(n_layers)
    prompts, gens = _traffic()
    staggered, stats = _serve(cfg, xlstm_params[n_layers], prompts, gens)
    sequential, _ = _serve(cfg, xlstm_params[n_layers], prompts, gens, sequential=True)
    assert staggered == sequential
    assert [len(t) for t in staggered] == gens
    assert stats["cache"]["backend"] == "recurrent"
    assert stats["opq"]["flags"]["decode"] == stats["decode_steps"]


def test_recurrent_slot_reset_has_teeth(xlstm_params):
    params = xlstm_params[2]
    prompts, _ = _traffic(lens=(6, 9))
    eng = Engine(CFG, params, EngineConfig(max_slots=1, max_seq_len=32), device="cpu")
    r0 = eng.submit(prompts[0], 5)
    eng.run_until_complete()
    assert r0.metrics.n_generated == 5
    fresh = make_store(CFG, 1, 32, backend="recurrent", device="cpu")
    got, want = _row(eng.store.cache, 0), _row(fresh.cache, 0)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), f"retired slot leaf {name} not pristine"
    # the sentinels are not zeros: a zero reset would not be pristine
    assert bool((want["mlstm_m"] == -60.0).all()) and bool((want["slstm_m"] == -1e30).all())
    assert bool((want["slstm_n"] == np.float32(1e-6)).all())
    r1 = eng.submit(prompts[1], 5)
    eng.run_until_complete()
    eng.close()
    eng2 = Engine(CFG, params, EngineConfig(max_slots=1, max_seq_len=32), device="cpu")
    r1_fresh = eng2.submit(prompts[1], 5)
    eng2.run_until_complete()
    eng2.close()
    assert r1.tokens == r1_fresh.tokens


def _reference_run():
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config as jget_config
    from repro.core import tensorizer as jtz
    from repro.distributed import sharding as shd
    from repro.launch.serve import _quant_predicate
    from repro.models import init_model
    from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
    out = {}
    prompts, gens = _traffic(lens=(5, 9, 4), gens=PARITY_GENS)
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        for n_layers in LAYERS:
            base = jget_config("xlstm-125m").smoke().replace(n_layers=n_layers,
                                                            quantize="serve")
            params = jtz.quantize_params(init_model(base, jax.random.PRNGKey(6)),
                                         predicate=_quant_predicate)
            out["params", n_layers] = P._numpy_tree(params)
            for dtype in P.DTYPES:
                eng = JEngine(base.replace(dtype=dtype), params, JEngineConfig(**ECFG))
                reqs, _ = P.drive(eng, lambda e, p, g: e.submit(p, g, want_logprobs=2),
                                  prompts, gens, False)
                out[n_layers, dtype] = {
                    "tokens": [list(r.tokens) for r in reqs],
                    "margins": [[row[0][1] - row[1][1] for row in r.top_logprobs]
                                for r in reqs],
                    "flags": dict(eng.stats()["opq"]["flags"])}
                if dtype == "float32":
                    out[n_layers, "embed"] = [eng.embed(p) for p in EMBED_PROMPTS]
                eng.close()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("xl") / "ref.pkl")


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("n_layers", LAYERS)
def test_engine_tokens_match_the_reference(reference, n_layers, dtype):
    cfg = _cfg(n_layers, dtype=dtype)
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    prompts, gens = _traffic(lens=(5, 9, 4), gens=PARITY_GENS)
    eng = Engine(cfg, params, EngineConfig(**ECFG), device="cpu")
    reqs, _ = P.drive(eng, lambda e, p, g: e.submit(p, g), prompts, gens, False)
    flags = dict(eng.stats()["opq"]["flags"])
    eng.close()
    ref = reference[n_layers, dtype]
    P.check_tokens(ref, {"tokens": [list(r.tokens) for r in reqs]}, dtype,
                   f"xlstm n_layers={n_layers}")
    assert flags == ref["flags"]


@pytest.mark.parametrize("n_layers", LAYERS)
def test_embed_matches_the_reference(reference, n_layers):
    cfg = _cfg(n_layers, dtype="float32")
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    eng = Engine(cfg, params, EngineConfig(**ECFG), device="cpu")
    for prompt, ref in zip(EMBED_PROMPTS, reference[n_layers, "embed"]):
        got = eng.embed(prompt)
        assert got["embedding"].shape == (cfg.d_model,) and got["logits"].shape == (cfg.vocab,)
        for key in ("embedding", "logits"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=EMBED_TOL)
    eng.close()


# ------------------------------------------------ the recurrent draft

@pytest.mark.parametrize("n_layers", LAYERS)
def test_recurrent_draft_bit_identical_and_lockstep(xlstm_params, n_layers):
    dcfg = _cfg(n_layers)
    assert dcfg.vocab == TARGET.vocab
    tparams = _params(TARGET, 0)
    dparams = xlstm_params[n_layers]
    prompts, gens = _traffic(lens=(6, 11), gens=(8, 5))
    plain, _ = _serve(TARGET, tparams, prompts, gens)
    spec = Engine(TARGET, tparams, EngineConfig(**ECFG, speculative=True, spec_k=2,
                                                draft=dcfg),
                  device="cpu", draft_params=dparams)
    assert spec.draft_store.kind == "recurrent"
    reqs = [spec.submit(p, g, strict=True) for p, g in zip(prompts, gens)]
    checked = 0
    while spec.scheduler.has_work():
        spec.step()
        for slot, req in spec.scheduler.active.items():
            assert spec.draft_store.slot_index(slot) == spec.store.slot_index(slot)
            consumed = np.concatenate([req.prompt, req.tokens[:-1]]).astype(np.int32)
            _, want = SV.prefill_recurrent(dparams, dcfg, torch.as_tensor(consumed)[None],
                                           torch.tensor([len(consumed) - 1],
                                                        dtype=torch.int32),
                                           ECFG["max_seq_len"])
            got = _row(spec.draft_store.cache, slot)
            for name, leaf in _row(want, 0).items():
                assert torch.equal(got[name], leaf), (name, slot)
            checked += 1
    stats = spec.stats()
    spec.close()
    assert [list(r.tokens) for r in reqs] == plain
    assert stats["spec_rounds"] > 0 and checked > 0


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kw,match", [
    ({"speculative": True, "draft": CFG}, "TARGET must be a dense-family arch, got ssm"),
    ({"cache_backend": "contiguous"}, "ContiguousKVStore supports dense-family caches, "
                                      "not ssm"),
    ({"cache_backend": "paged"}, "paged KV cache is a dense-family layout, not ssm"),
    ({"prefill_chunk": 16}, r"prefill_chunk applies to the dense-family score-matrix "
                            r"prefill, not the recurrent scan \(ssm\)"),
])
def test_engine_refuses_what_the_reference_refuses(xlstm_params, kw, match):
    with pytest.raises(ValueError, match=match):
        Engine(CFG, xlstm_params[2], EngineConfig(**{**ECFG, **kw}), device="cpu",
               draft_params=xlstm_params[2] if kw.get("speculative") else None)


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("backend", ["recurrent", "auto"])
def test_cli_serves_xlstm(backend, capsys):
    reqs, stats = tserve.run(["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
                              "--quantize", "serve", "--cache-backend", backend,
                              "--requests", "3", "--prompt-len", "8", "--gen", "4",
                              "--slots", "2", "--stagger-steps", "1"])
    assert [len(r.tokens) for r in reqs] == [4, 4, 4]
    assert stats["cache"]["backend"] == "recurrent"
    assert "12 weight tensors quantized" in capsys.readouterr().out


def test_cli_speculative_with_an_xlstm_draft(capsys):
    reqs, stats = tserve.run(["--smoke", "--device", "cpu", "--quantize", "serve",
                              "--requests", "2", "--prompt-len", "8", "--gen", "6",
                              "--slots", "2", "--speculative", "--spec-k", "2",
                              "--draft-config", "xlstm-125m"])
    assert [len(r.tokens) for r in reqs] == [6, 6] and stats["spec_rounds"] > 0
    assert "speculative:" in capsys.readouterr().out


def test_cli_refuses_an_xlstm_target_for_speculative(capsys):
    with pytest.raises(SystemExit):
        tserve.run(["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--speculative"])
    assert "dense-family TARGET" in capsys.readouterr().err


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference_run(), f)
