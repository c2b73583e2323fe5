"""Shared harness of the engine-route and fleet parity tests
(test_torch_routes.py, test_torch_prefill_routes.py,
test_torch_speculative.py, test_torch_router.py, test_torch_disagg.py): the same
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

import dataclasses
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
# The port's ArchConfig fields that the JAX package's lacks, at the values
# of the JAX package's MoE block: no leading dense layer, the k gates
# renormalised. deepseek-moe-16b states the published block instead, so a
# test that holds it to the JAX package pins it to these.
JAX_BLOCK = {"first_k_dense": 0, "dense_d_ff": None, "norm_topk_prob": True}


def jax_block(cfg):
    """Port config ``cfg`` with the JAX package's MoE block (JAX_BLOCK)."""
    return cfg.replace(**JAX_BLOCK)


def jax_fields(cfg) -> dict:
    """The fields of port config ``cfg`` that the JAX package's has."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in JAX_BLOCK}


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


# ---------------------------------------------------------------------------
# the fleet (test_torch_router.py, test_torch_disagg.py)
# ---------------------------------------------------------------------------

ROUTER_COUNTERS = ("placed", "affinity_hits", "spills", "rejected", "drains", "handoffs",
                   "requeued", "hosts_lost", "recovered", "ships", "shipped_blocks",
                   "ship_fallbacks")


def drive_router(router, prompts, gens, *, sessions, stagger=1, drain_at=None):
    """Submit request i (session ``sessions[i]``, logprobs top 2) and step
    the fleet ``stagger`` times; with ``drain_at`` host 0 drains after that
    many fleet steps. The same code drives the reference Router and the
    port's. Returns tokens, top-2 margins, the router's counters, each
    request's host trail and each host's OPQ flags."""
    reqs, steps = [], 0
    for i, (p, g) in enumerate(zip(prompts, gens)):
        reqs.append(router.submit(p, g, session=sessions[i], want_logprobs=2, strict=True))
        for _ in range(stagger):
            router.step()
            steps += 1
            if drain_at is not None and steps == drain_at:
                router.drain(0)
    router.run_until_complete()
    stats = router.stats()
    router.close()
    return {"tokens": [list(r.tokens) for r in reqs],
            "margins": [[row[0][1] - row[1][1] for row in r.top_logprobs] for r in reqs],
            "counters": {k: stats["router"][k] for k in ROUTER_COUNTERS},
            "hosts": [list(r.hosts) for r in reqs],
            "flags": [dict(h["opq"]["flags"]) for h in stats["per_host"]]}


def fleet_reference(cases, run_case):
    """Every fleet case (name -> case) through ``run_case(Router,
    RouterConfig, EngineConfig, build_inproc_fleet, cfg, params, case)``
    of the reference package on W8A8 weights, in both compute dtypes.
    Runs in the subprocess; returns the results and the weights."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.core import tensorizer as jtz
    from repro.distributed import sharding as shd
    from repro.launch.serve import _quant_predicate
    from repro.models import init_model
    from repro.serving import EngineConfig, Router, RouterConfig
    from repro.serving.transport import build_inproc_fleet
    base = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
    out = {}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(base, jax.random.PRNGKey(0)),
                                     predicate=_quant_predicate)
        out["params"] = _numpy_tree(params)
        for name, case in cases.items():
            for dtype in DTYPES:
                cfg = base.replace(dtype=dtype, kv_cache_dtype=case["kv"])
                out[name, dtype] = run_case(Router, RouterConfig, EngineConfig,
                                            build_inproc_fleet, cfg, params, case)
    return out


def fleet_port(params, cases, run_case):
    """The same cases through the port's fleet on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, Router, RouterConfig
    from repro_torch.serving.transport import build_inproc_fleet
    base = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")

    def cpu_router(*a, **kw):
        return Router(*a, **kw, device="cpu") if "transports" not in kw else Router(*a, **kw)

    def cpu_fleet(*a, **kw):
        return build_inproc_fleet(*a, **kw, device="cpu")
    return {(name, dtype): run_case(cpu_router, RouterConfig, EngineConfig, cpu_fleet,
                                    base.replace(dtype=dtype, kv_cache_dtype=case["kv"]),
                                    params, case)
            for name, case in cases.items() for dtype in DTYPES}
