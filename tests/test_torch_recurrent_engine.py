"""The hybrid family behind the port's Engine (zamba2-7b's smoke config,
W8A8, and at n_layers=5 with a tail layer) on the recurrent state store:

  * ``RecurrentStateStore``: a reset row equals a fresh one, ``write_slots``
    copies whole state rows, ``adopt_selected`` picks each slot's snapshot
    (a port of tests/test_speculative.py's
    ``test_adopt_selected_picks_per_slot_snapshot``), the pristine table
    and xlstm's sentinel are the reference's;
  * staggered arrivals equal sequential serving (a port of
    tests/test_serving.py's ``test_hybrid_serves_end_to_end``);
  * the port's Engine against the reference Engine on the same weights
    (carried by ``params_from_numpy``), f32 and bf16: greedy tokens equal up
    to the first step whose reference top-2 logit margin falls below
    tests/_torch_parity.py's LOGIT_TOL (1e-4 in f32, 0.1 in bf16), OPQ flag
    counts identical; ``Engine.embed`` in f32 within 1e-4 of the
    reference's (tests/test_torch_sampling.py's bound);
  * speculative decode of a dense target (tinyllama's smoke config) with a
    zamba2 draft: tokens bitwise plain decode's and the draft's slot index
    in lockstep with the target's after every step (a port of
    ``test_recurrent_draft_bit_identical_and_lockstep``); after every round
    each slot's draft state equals a replay of its consumed tokens through
    the draft alone, and no snapshot shares storage with the live cache or
    another snapshot;
  * the reference's refusals, with its messages; the ssm family (xlstm)
    gets the recurrent store too (tests/test_torch_xlstm.py serves it);
  * the serve CLI on the recurrent backend, and with a zamba2 draft.

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
from repro_torch.serving import store as ST  # noqa: E402
from repro_torch.serving.store import RecurrentStateStore, make_store  # noqa: E402
from repro_torch.testing.params import params_from_numpy  # noqa: E402

CFG = get_config("zamba2-7b").smoke().replace(quantize="serve")
TARGET = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
LAYERS = [4, 5]
ECFG = dict(max_slots=2, max_seq_len=32)
EMBED_TOL = 1e-4
# the engine parity traffic: long enough that f32 compares at least
# tests/_torch_parity.py's MIN_COMPARED tokens of each request
PARITY_GENS = (12, 10, 12)
EMBED_PROMPTS = [P.traffic([n], 1, seed=9)[0][0] for n in (7, 16)]


def _cfg(n_layers, **kw):
    return CFG.replace(n_layers=n_layers, **kw)


def _params(cfg, seed):
    return init_model_quantized(cfg, torch.Generator().manual_seed(seed), quant_predicate,
                                device="cpu")


@pytest.fixture(scope="module")
def hybrid_params():
    return {n: _params(_cfg(n), 3) for n in LAYERS}


def _traffic(lens=(5, 9, 4), gens=(4, 3, 5), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,), dtype=np.int32) for n in lens], list(gens)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif tree is not None:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------- store

@pytest.mark.parametrize("n_layers", LAYERS)
def test_store_reset_and_write_slots(hybrid_params, n_layers):
    cfg = _cfg(n_layers)
    store = RecurrentStateStore(cfg, 3, 16, device="cpu")
    fresh = RecurrentStateStore(cfg, 3, 16, device="cpu")
    assert store.kind == "recurrent" and (store.cache["tail"] is None) == (n_layers == 4)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 6), dtype=np.int32))
    _, states = SV.prefill_recurrent(hybrid_params[n_layers], cfg, toks,
                                     torch.tensor([3, 5], dtype=torch.int32), 16)
    store.write_slots([2, 0], states, [4, 6])
    assert store.slot_index(2) == 4 and store.slot_index(0) == 6 and store.slot_index(1) == 0
    for path, leaf in _leaves(store.cache):
        if path != ("index",):
            assert torch.equal(leaf[:, 2], _at(states, path)[:, 0]), path
            assert torch.equal(leaf[:, 0], _at(states, path)[:, 1]), path
            assert torch.equal(leaf[:, 1], _at(fresh.cache, path)[:, 1]), path
    store.reset(2)
    store.reset(0)
    for path, leaf in _leaves(store.cache):
        assert torch.equal(leaf, _at(fresh.cache, path)), path
    assert store.nbytes() == fresh.nbytes() > 0


def test_adopt_selected_picks_per_slot_snapshot():
    store = RecurrentStateStore(_cfg(5), 3, 8, device="cpu")

    def filled(i):
        return {k: (None if v is None else
                    {n: torch.full_like(t, i) for n, t in v.items()} if isinstance(v, dict)
                    else torch.full_like(v, i)) for k, v in store.cache.items()}
    snaps = [filled(i) for i in range(4)]
    sel = [2, 0, 3]
    store.adopt_selected(snaps, sel)
    for path, leaf in _leaves(store.cache):
        for slot, s in enumerate(sel):
            row = leaf[slot] if path == ("index",) else leaf[:, slot]
            assert bool((row == s).all()), (path, slot, s)


def test_adopt_selected_keeps_the_live_snapshot_rows():
    store = RecurrentStateStore(_cfg(4), 2, 8, device="cpu")
    live = store.cache
    snap = store.snapshot()
    for _, leaf in _leaves(snap):
        leaf.fill_(7)
    for path, leaf in _leaves(live):
        assert not bool((leaf == 7).any()), path      # the snapshot owns its storage
    store.adopt_selected([snap, live], [1, 0])
    for path, leaf in _leaves(store.cache):
        row0 = leaf[0] if path == ("index",) else leaf[:, 0]
        row1 = leaf[1] if path == ("index",) else leaf[:, 1]
        assert not bool((row0 == 7).any()) and bool((row1 == 7).all()), path


def test_pristine_table_is_the_references():
    from repro.models.xlstm import M_INIT
    from repro.serving import store as JST
    assert ST.M_INIT == M_INIT
    assert ST._PRISTINE == JST._PRISTINE
    for name in ("k", "conv", "ssm", "k_scale", "mlstm_m", "slstm_n", "slstm_m"):
        assert ST.pristine_value(name) == JST.pristine_value(name), name
    assert ST.RECURRENT_FAMILIES == JST.RECURRENT_FAMILIES


# ---------------------------------------------------------------- engine

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


@pytest.mark.parametrize("n_layers", LAYERS)
def test_hybrid_staggered_matches_sequential(hybrid_params, n_layers):
    cfg = _cfg(n_layers)
    prompts, gens = _traffic()
    staggered, stats = _serve(cfg, hybrid_params[n_layers], prompts, gens)
    sequential, _ = _serve(cfg, hybrid_params[n_layers], prompts, gens, sequential=True)
    assert staggered == sequential
    assert [len(t) for t in staggered] == gens
    assert stats["cache"]["backend"] == "recurrent"
    assert stats["opq"]["flags"]["decode"] == stats["decode_steps"]


def _numpy_tree(tree):
    """tests/_torch_parity.py's conversion, keeping the hybrid's None tail."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return P._numpy_tree(tree)


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
    prompts, gens = _traffic(gens=PARITY_GENS)
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        for n_layers in LAYERS:
            base = jget_config("zamba2-7b").smoke().replace(n_layers=n_layers,
                                                           quantize="serve")
            params = jtz.quantize_params(init_model(base, jax.random.PRNGKey(6)),
                                         predicate=_quant_predicate)
            out["params", n_layers] = _numpy_tree(params)
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
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("hyb") / "ref.pkl")


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("n_layers", LAYERS)
def test_engine_tokens_match_the_reference(reference, n_layers, dtype):
    cfg = _cfg(n_layers, dtype=dtype)
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    prompts, gens = _traffic(gens=PARITY_GENS)
    eng = Engine(cfg, params, EngineConfig(**ECFG), device="cpu")
    reqs, _ = P.drive(eng, lambda e, p, g: e.submit(p, g), prompts, gens, False)
    flags = dict(eng.stats()["opq"]["flags"])
    eng.close()
    ref = reference[n_layers, dtype]
    P.check_tokens(ref, {"tokens": [list(r.tokens) for r in reqs]}, dtype,
                   f"zamba2 n_layers={n_layers}")
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

class _WatchedEngine(Engine):
    """Checks every recurrent-draft rollback: no snapshot shares storage
    with the live cache (but the live one itself) or with another."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rollbacks = 0
        adopt = self.draft_store.adopt_selected

        def watched(snapshots, sel):
            live = self.draft_store.cache
            owners = {}
            for i, snap in enumerate(snapshots):
                if snap is live:
                    assert i == len(snapshots) - 1
                for _, t in _leaves(snap):
                    ptr = t.untyped_storage().data_ptr()
                    assert owners.setdefault(ptr, i) == i, (i, owners[ptr])
            self.rollbacks += 1
            return adopt(snapshots, sel)
        self.draft_store.adopt_selected = watched


def _draft_replay(dcfg, dparams, tokens, max_seq_len):
    _, cache = SV.prefill_recurrent(dparams, dcfg, torch.as_tensor(tokens)[None],
                                    torch.tensor([len(tokens) - 1], dtype=torch.int32),
                                    max_seq_len)
    return cache


@pytest.mark.parametrize("n_layers", LAYERS)
def test_recurrent_draft_bit_identical_and_lockstep(hybrid_params, n_layers):
    dcfg = _cfg(n_layers)
    assert dcfg.vocab == TARGET.vocab
    tparams = _params(TARGET, 0)
    dparams = hybrid_params[n_layers]
    prompts, gens = _traffic(lens=(6, 11), gens=(8, 5))
    plain, _ = _serve(TARGET, tparams, prompts, gens)
    spec = _WatchedEngine(TARGET, tparams, EngineConfig(**ECFG, speculative=True, spec_k=2,
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
            want = _draft_replay(dcfg, dparams, consumed, ECFG["max_seq_len"])
            for path, leaf in _leaves(spec.draft_store.cache):
                got = leaf[slot] if path == ("index",) else leaf[:, slot]
                ref = _at(want, path)[0] if path == ("index",) else _at(want, path)[:, 0]
                assert torch.equal(got, ref), (path, slot)
            checked += 1
    stats = spec.stats()
    spec.close()
    assert [list(r.tokens) for r in reqs] == plain
    assert spec.rollbacks == stats["spec_rounds"] > 0 and checked > 0
    assert stats["opq"]["flags"]["draft_prefill/16"] == stats["prefill_batches"]


def test_recurrent_draft_with_itself_as_target_is_refused(hybrid_params):
    with pytest.raises(ValueError, match="TARGET must be a dense-family arch, got hybrid"):
        Engine(CFG, hybrid_params[4], EngineConfig(**ECFG, speculative=True, draft=CFG),
               device="cpu", draft_params=hybrid_params[4])


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kw,match", [
    ({"cache_backend": "contiguous"}, "ContiguousKVStore supports dense-family caches, "
                                      "not hybrid"),
    ({"cache_backend": "paged"}, "paged KV cache is a dense-family layout, not hybrid"),
    ({"cache_backend": "paged", "paged_native": True},
     "paged KV cache is a dense-family layout, not hybrid"),
    ({"prefix_cache": True}, "prefix_cache .* requires cache_backend='paged'"),
    ({"prefill_chunk": 16}, r"prefill_chunk applies to the dense-family score-matrix "
                            r"prefill, not the recurrent scan \(hybrid\)"),
])
def test_engine_refuses_what_the_reference_refuses(hybrid_params, kw, match):
    with pytest.raises(ValueError, match=match):
        Engine(CFG, hybrid_params[4], EngineConfig(**{**ECFG, **kw}), device="cpu")


def test_recurrent_store_refusals():
    with pytest.raises(ValueError, match="supports ssm/hybrid state caches, not dense"):
        make_store(TARGET, 2, 32, backend="recurrent", device="cpu")
    # the ssm family (xlstm) gets the recurrent store too
    assert isinstance(make_store(TARGET.replace(family="ssm"), 2, 32, device="cpu"),
                      RecurrentStateStore)
    assert isinstance(make_store(CFG, 2, 32, device="cpu"), RecurrentStateStore)


def test_auto_backend_is_recurrent(hybrid_params):
    eng = Engine(CFG, hybrid_params[4], EngineConfig(**ECFG), device="cpu")
    assert eng.store.kind == "recurrent"
    eng.close()


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("backend", ["recurrent", "auto"])
def test_cli_serves_zamba2(backend, capsys):
    reqs, stats = tserve.run(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                              "--quantize", "serve", "--cache-backend", backend,
                              "--requests", "3", "--prompt-len", "8", "--gen", "4",
                              "--slots", "2", "--stagger-steps", "1"])
    assert [len(r.tokens) for r in reqs] == [4, 4, 4]
    assert stats["cache"]["backend"] == "recurrent"
    assert "weight tensors quantized" in capsys.readouterr().out


def test_cli_speculative_with_a_zamba2_draft(capsys):
    reqs, stats = tserve.run(["--smoke", "--device", "cpu", "--quantize", "serve",
                              "--requests", "2", "--prompt-len", "8", "--gen", "6",
                              "--slots", "2", "--speculative", "--spec-k", "2",
                              "--draft-config", "zamba2-7b"])
    assert [len(r.tokens) for r in reqs] == [6, 6] and stats["spec_rounds"] > 0
    assert "speculative:" in capsys.readouterr().out


def test_cli_refuses_a_hybrid_target_for_speculative(capsys):
    with pytest.raises(SystemExit):
        tserve.run(["--arch", "zamba2-7b", "--smoke", "--device", "cpu", "--speculative"])
    assert "dense-family TARGET" in capsys.readouterr().err


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference_run(), f)
