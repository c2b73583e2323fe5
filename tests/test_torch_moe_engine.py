"""The MoE family behind the port's Engine (deepseek-moe-16b's smoke config,
W8A8), bitwise inside the port on the CPU:

  * staggered arrivals equal each request served alone (the reference's
    ``test_moe_staggered_matches_sequential``): decode masks idle slots out
    of the expert capacity, prefill routes row-isolated;
  * every store route (contiguous, paged gather bridge, block-native plain
    and through the paged-attention kernel's route, its plain version
    here), bf16 and int8 KV: tokens and retire-time cache rows equal;
  * fused, chunked and prefix-cache admissions: tokens and rows equal;
  * speculative decode with a MoE target and a MoE draft (the target's
    weights: every proposal accepted; other weights: every window
    rejected) equals plain decode, tokens and retire-time rows (the
    reference's ``moe-good`` case, tests/test_speculative.py);
  * ``Engine.embed`` against the reference Engine's ``embed`` (a subprocess,
    f32 float weights carried by ``params_from_numpy``) within 1e-4, the
    bound of tests/test_torch_sampling.py; its forward bins the experts with
    the shared, dropping capacity, so its logits row is not the fused
    prefill's (row-isolated), as in the reference.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import _torch_parity as P  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import quant_predicate  # noqa: E402
from repro_torch.models import serve as SV  # noqa: E402
from repro_torch.models.model import init_model_quantized  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.testing.params import params_from_numpy  # noqa: E402

CFG = get_config("deepseek-moe-16b").smoke().replace(quantize="serve")
RNG = np.random.default_rng(31)
EMBED_TOL = 1e-4
EMBED_PROMPTS = [P.traffic([n], 1, seed=9)[0][0] for n in (7, 16, 23)]


def _params(seed):
    return init_model_quantized(CFG, torch.Generator().manual_seed(seed), quant_predicate)


@pytest.fixture(scope="module")
def params():
    return _params(0)


@pytest.fixture(scope="module")
def other_params():
    return _params(5)


class SnapshotEngine(Engine):
    """Keeps each request's cache row at retire, before the reset scrubs it
    (positions up to prompt + max_new)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rows = {}

    def _retire(self, slot):
        req = self.scheduler.active[slot]
        ext = len(req.prompt) + req.max_new_tokens
        view = self.store.gather_view()
        self.rows[req.id] = {n: (leaf[slot] if n == "index" else leaf[:, slot, :ext]).clone()
                             for n, leaf in view.items()}
        super()._retire(slot)


def _serve(cfg, params, ecfg, prompts, gens, stagger=1, draft_params=None, sequential=False):
    eng = SnapshotEngine(cfg, params, EngineConfig(**ecfg), device="cpu",
                         draft_params=draft_params)
    reqs = []
    for p, g in zip(prompts, gens):
        reqs.append(eng.submit(p, g, strict=True))
        if sequential:
            eng.run_until_complete()
        for _ in range(stagger):
            eng.step()
    eng.run_until_complete()
    stats = eng.stats()
    eng.close()
    return [list(r.tokens) for r in reqs], [eng.rows[r.id] for r in reqs], stats


def _same_rows(a, b):
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for name in ra:
            assert torch.equal(ra[name], rb[name]), name


def _traffic(lens=(5, 9, 4, 7), gens=(6, 5, 8, 3), preamble=0):
    pre = RNG.integers(0, CFG.vocab, (preamble,), dtype=np.int32)
    return ([np.concatenate([pre, RNG.integers(0, CFG.vocab, (n - preamble,), dtype=np.int32)])
             for n in lens], list(gens))


ROUTES = {
    "contiguous": dict(cache_backend="contiguous"),
    "bridge": dict(cache_backend="paged", block_size=8),
    "native_plain": dict(cache_backend="paged", block_size=8, paged_native=True),
    "native_kernel": dict(cache_backend="paged", block_size=8, paged_native=True,
                          paged_kernel=True),
}


@pytest.mark.parametrize("route", ["contiguous", "native_kernel"])
def test_moe_staggered_matches_sequential(params, route):
    prompts, gens = _traffic()
    ecfg = dict(max_slots=2, max_seq_len=32, **ROUTES[route])
    staggered, rows, _ = _serve(CFG, params, ecfg, prompts, gens)
    alone, alone_rows, _ = _serve(CFG, params, ecfg, prompts, gens, stagger=0,
                                  sequential=True)
    assert staggered == alone
    _same_rows(rows, alone_rows)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_moe_routes_bitwise(params, kv_dtype):
    cfg = CFG.replace(kv_cache_dtype=kv_dtype)
    prompts, gens = _traffic()
    runs = {name: _serve(cfg, params, dict(max_slots=2, max_seq_len=32, **kw), prompts, gens)
            for name, kw in ROUTES.items()}
    tokens, rows, _ = runs["contiguous"]
    for name, (t, r, _) in runs.items():
        assert t == tokens, name
        _same_rows(r, rows)


def test_moe_admissions_bitwise(params):
    """Fused single-shot, chunked (8-token chunks) and prefix-cache
    admissions on the block-native kernel route: the same tokens and rows,
    with real prefix hits."""
    prompts, gens = _traffic(lens=(20, 24, 18, 22), gens=(6, 5, 7, 4), preamble=16)
    base = dict(max_slots=2, max_seq_len=32, **ROUTES["native_kernel"])
    fused = _serve(CFG, params, base, prompts, gens)
    chunked = _serve(CFG, params, dict(base, prefill_chunk=8), prompts, gens)
    prefix = _serve(CFG, params, dict(base, prefix_cache=True), prompts, gens)
    assert any(f.startswith("prefill_chunked/") for f in chunked[2]["opq"]["flags"])
    assert prefix[2]["prefix_hits"] > 0
    for run in (chunked, prefix):
        assert run[0] == fused[0]
        _same_rows(run[1], fused[1])


@pytest.mark.parametrize("route,draft", [("contiguous", "good"), ("contiguous", "bad"),
                                         ("native_plain", "good"), ("bridge", "bad")])
def test_moe_speculative_matches_plain(params, other_params, route, draft):
    """A MoE target verifying row-isolated, a MoE draft decoding with the
    idle mask: tokens and retire-time rows bitwise plain decode's."""
    prompts, gens = _traffic(gens=(6, 7, 8, 5))
    ecfg = dict(max_slots=2, max_seq_len=32, **ROUTES[route])
    plain_t, plain_r, _ = _serve(CFG, params, ecfg, prompts, gens)
    dparams = params if draft == "good" else other_params
    spec_t, spec_r, stats = _serve(CFG, params, dict(ecfg, speculative=True, spec_k=3,
                                                     draft=CFG),
                                   prompts, gens, draft_params=dparams)
    assert spec_t == plain_t
    _same_rows(spec_r, plain_r)
    assert stats["spec_rounds"] > 0
    if draft == "good":
        assert stats["accepted_tokens"] > 0


def test_moe_decode_is_dropless_only_with_active(params):
    """The decode step's ``active`` makes it dropless: four slots feeding
    the same token pick the same experts, and without ``active`` the step
    bins the shared capacity ceil(4 * topk / E * 1.25) = 3 (the reference's
    default), dropping the last slot's experts; with it every slot's logits
    are the first's."""
    tokens = torch.full((4, 1), 3, dtype=torch.int32)
    runs = {}
    for name, active in (("shared", None), ("dropless", torch.ones(4, dtype=torch.bool))):
        cache = SV.init_cache(CFG, 4, 16, per_slot_index=True)
        runs[name], _ = SV.decode(params, CFG, cache, tokens, active=active)
    assert torch.equal(runs["dropless"][3], runs["dropless"][0])
    assert not torch.equal(runs["shared"][3], runs["shared"][0])


# ---------------------------------------------------------------- embed

def _reference_embed():
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config as jget_config
    from repro.distributed import sharding as shd
    from repro.models import init_model
    from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
    cfg = jget_config("deepseek-moe-16b").smoke().replace(dtype="float32")
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = init_model(cfg, jax.random.PRNGKey(0))
        eng = JEngine(cfg, params, JEngineConfig(**P.BASE_ECFG))
        out = {"params": P._numpy_tree(params),
               "embed": [{k: np.asarray(v) for k, v in eng.embed(p).items()}
                         for p in EMBED_PROMPTS]}
        eng.close()
    return out


@pytest.fixture(scope="module")
def embed_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_embed") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True, timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


def test_moe_embed_matches_reference(embed_reference):
    cfg = get_config("deepseek-moe-16b").smoke().replace(dtype="float32")
    params = params_from_numpy(embed_reference["params"], device="cpu")
    eng = Engine(cfg, params, EngineConfig(**P.BASE_ECFG), device="cpu")
    for prompt, ref in zip(EMBED_PROMPTS, embed_reference["embed"]):
        got = eng.embed(prompt)
        assert got["embedding"].shape == (cfg.d_model,) and got["logits"].shape == (cfg.vocab,)
        np.testing.assert_allclose(got["embedding"], ref["embedding"], atol=EMBED_TOL, rtol=0)
        np.testing.assert_allclose(got["logits"], ref["logits"], atol=EMBED_TOL, rtol=0)
    assert eng.stats()["embed_requests"] == len(EMBED_PROMPTS)
    eng.close()


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference_embed(), f)
