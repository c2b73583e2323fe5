"""Shared harness of the engine-route parity tests (test_torch_routes.py,
test_torch_prefill_routes.py, test_torch_speculative.py): the same
traffic through the reference Engine (repro.serving, run in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``) and the port's
(repro_torch.serving) on the same converted W8A8 weights.

The rule of tests/test_torch_engine.py: each request's tokens equal the
reference's up to the first step whose reference top-2 logit margin falls
below LOGIT_TOL (1e-4 in f32, 0.1 in bf16, the served dtype); in f32 at
least MIN_COMPARED tokens must be compared before any cut-off. OPQ flag
counts and, on the paged routes, the block census after every engine step
are IDENTICAL.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
MIN_COMPARED = {"float32": 1 + 8, "bfloat16": 0}
DTYPES = list(LOGIT_TOL)
KV_DTYPES = ["bfloat16", "int8"]
BASE_ECFG = dict(max_slots=2, max_seq_len=48, block_size=8)


def traffic(prompt_lens, gen, seed=7, preamble=0):
    """(prompts, gens): staggered requests; with ``preamble`` every prompt
    opens with the same ``preamble`` tokens."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, (preamble,), dtype=np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, 256, (n - preamble,), dtype=np.int32)])
               for n in prompt_lens]
    return prompts, [gen] * len(prompts)


def engine_kw(ecfg, cfg):
    """EngineConfig fields of a case: BASE_ECFG under the case's, and with
    ``speculative`` the target's own config as the draft (the draft's
    params are the target's: acceptance is total)."""
    kw = {**BASE_ECFG, **ecfg}
    if kw.get("speculative"):
        kw["draft"] = cfg
    return kw


def drive(engine, submit, prompts, gens, census):
    """Two joins mid-flight, the rest queued behind them; the block census
    after every engine step when ``census``."""
    out = []

    def step():
        engine.step()
        if census:
            out.append(engine.store.debug_block_census())
    reqs = [submit(engine, prompts[0], gens[0])]
    step()
    reqs.append(submit(engine, prompts[1], gens[1]))
    step()
    reqs += [submit(engine, p, g) for p, g in zip(prompts[2:], gens[2:])]
    while engine.has_work():
        step()
    return reqs, out


def _numpy_tree(tree):
    from repro.core import tensorizer as jtz
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree)


def run_reference(cases):
    """Every case (name -> (ecfg kwargs, kv dtype, prompts, gens)) through
    the reference Engine, in both compute dtypes. Runs in the subprocess."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.core import tensorizer as jtz
    from repro.distributed import sharding as shd
    from repro.launch.serve import _quant_predicate
    from repro.models import init_model
    from repro.serving import Engine, EngineConfig
    base = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
    out = {}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(base, jax.random.PRNGKey(0)),
                                     predicate=_quant_predicate)
        out["params"] = _numpy_tree(params)
        for name, (ecfg, kv_dtype, prompts, gens) in cases.items():
            for dtype in DTYPES:
                cfg = base.replace(dtype=dtype, kv_cache_dtype=kv_dtype)
                eng = Engine(cfg, params, EngineConfig(**engine_kw(ecfg, cfg)),
                             draft_params=params if ecfg.get("speculative") else None)
                reqs, census = drive(eng, lambda e, p, g: e.submit(p, g, want_logprobs=2),
                                     prompts, gens, eng.store.kind == "paged")
                stats = eng.stats()
                out[name, dtype] = {
                    "tokens": [list(r.tokens) for r in reqs],
                    "margins": [[row[0][1] - row[1][1] for row in r.top_logprobs]
                                for r in reqs],
                    "flags": dict(stats["opq"]["flags"]), "census": census,
                    "prefix": {k: stats[k] for k in ("prefix_hits", "prefix_blocks_reused",
                                                    "prefix_tokens_reused", "prefill_chunks")}}
                eng.close()
    return out


def reference_in_subprocess(test_file, out_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, test_file, str(out_path)], env=env, check=True,
                   timeout=900)
    with open(out_path, "rb") as f:
        return pickle.load(f)


def run_port(params, name, case, dtype):
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, EngineConfig
    ecfg, kv_dtype, prompts, gens = case
    cfg = get_config("tinyllama-1.1b").smoke().replace(
        quantize="serve", dtype=dtype, kv_cache_dtype=kv_dtype)
    eng = Engine(cfg, params, EngineConfig(**engine_kw(ecfg, cfg)), device="cpu",
                 draft_params=params if ecfg.get("speculative") else None)
    reqs, census = drive(eng, lambda e, p, g: e.submit(p, g), prompts, gens,
                         eng.store.kind == "paged")
    stats = eng.stats()
    eng.close()
    return {"tokens": [list(r.tokens) for r in reqs], "flags": dict(stats["opq"]["flags"]),
            "census": census, "stats": stats,
            "prefix": {k: stats[k] for k in ("prefix_hits", "prefix_blocks_reused",
                                            "prefix_tokens_reused", "prefill_chunks")}}


def check_tokens(ref, got, dtype, label):
    for i, (r, g, margins) in enumerate(zip(ref["tokens"], got["tokens"], ref["margins"])):
        low = [j for j, m in enumerate(margins) if m < LOGIT_TOL[dtype]]
        n = low[0] if low else len(r)
        print(f"{label} {dtype} request {i}: compared {n} of {len(r)} tokens")
        assert n >= MIN_COMPARED[dtype], (label, i, n, margins)
        assert g[:n] == r[:n], (label, i, g, r)
        assert len(g) == len(r)


def main(cases):
    with open(sys.argv[1], "wb") as f:
        pickle.dump(run_reference(cases), f)
