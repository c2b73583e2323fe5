"""The slice as a whole: the port's Engine (repro_torch.serving) against the
reference Engine (repro.serving) on the same converted W8A8 weights —
greedy, paged-native, through the paged-attention kernel (the reference's
Pallas kernel in interpret mode; the port's kernel wrapper takes its plain
version on the CPU), with staggered arrivals.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` so its compiled steps round
where their source says (see tests/test_torch_model.py).

Two compute dtypes, both W8A8:
  * float32 — token streams EQUAL, each compared up to the first step whose
    reference top-2 logit margin falls below LOGIT_TOL["float32"] = 1e-4,
    about 100x the largest port-vs-reference logit difference measured on
    this config (1.2e-6, prefill and paged decode: f32 contraction order,
    and the Pallas kernel's online softmax against the plain full-row
    softmax). Every request must be compared over at least 16 decode steps
    before any cut-off.
  * bfloat16 (the served dtype) — the same rule with LOGIT_TOL 0.1 (above the
    0.08 measured in tests/test_torch_model.py, where a last-bit f32
    difference moves a bf16 rounding and then an int8 code). Here bf16
    logits of this random model tie exactly (margin 0) within the first
    few steps, so no minimum number of compared steps is asserted.
OPQ flag counts and the block census must be IDENTICAL, step by step, for
both.
"""

import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config
from repro.core import tensorizer as jtz
from repro.distributed import sharding as shd
from repro.launch.serve import _quant_predicate
from repro.models import init_model
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.core import opq as topq
from repro_torch.serving import Engine, EngineConfig, QueueFull
from repro_torch.testing.params import params_from_numpy

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
# tokens compared before any cut-off: the prefill token + 16 decode steps
MIN_COMPARED = {"float32": 1 + 16, "bfloat16": 0}
PROMPT_LENS = [5, 9, 12, 7]
GEN = 24
ECFG = dict(max_slots=2, max_seq_len=48, cache_backend="paged", block_size=8,
            paged_native=True, paged_kernel=True)
CFG = get_config("tinyllama-1.1b").smoke().replace(quantize="serve")
TCFG = tget_config("tinyllama-1.1b").smoke().replace(quantize="serve")


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab, (n,), dtype=np.int32) for n in PROMPT_LENS]


def _drive(engine, submit):
    """Staggered traffic: two joins mid-flight, the rest queued behind them;
    the block census after every engine step."""
    prompts = _prompts()
    reqs = [submit(engine, prompts[0])]
    census = []
    engine.step()
    census.append(engine.store.debug_block_census())
    reqs.append(submit(engine, prompts[1]))
    engine.step()
    census.append(engine.store.debug_block_census())
    reqs += [submit(engine, p) for p in prompts[2:]]
    while engine.has_work():
        engine.step()
        census.append(engine.store.debug_block_census())
    return reqs, census


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree)


def _reference():
    """The reference Engine runs, by dtype (in a subprocess, see module doc)."""
    return {dt: _reference_one(dt) for dt in LOGIT_TOL}


def _reference_one(dtype):
    cfg = CFG.replace(dtype=dtype)
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(cfg, jax.random.PRNGKey(0)),
                                     predicate=_quant_predicate)
        eng = JEngine(cfg, params, JEngineConfig(**ECFG))
        reqs, census = _drive(
            eng, lambda e, p: e.submit(p, GEN, want_logprobs=2))
        out = {
            "params": _numpy_tree(params),
            "tokens": [list(r.tokens) for r in reqs],
            "margins": [[row[0][1] - row[1][1] for row in r.top_logprobs]
                        for r in reqs],
            "flags": dict(eng.stats()["opq"]["flags"]),
            "census": census,
        }
        eng.close()
    return out


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "engine_ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True,
                   timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=list(LOGIT_TOL))
def dtype(request):
    return request.param


@pytest.fixture(scope="module")
def reference(references, dtype):
    return dict(references[dtype],
                params=params_from_numpy(references[dtype]["params"], device="cpu"))


@pytest.fixture(scope="module")
def port(reference, dtype):
    eng = Engine(TCFG.replace(dtype=dtype), reference["params"],
                 EngineConfig(**ECFG), device="cpu")
    reqs, census = _drive(eng, lambda e, p: e.submit(p, GEN))
    out = {"tokens": [list(r.tokens) for r in reqs], "census": census,
           "stats": eng.stats(), "reqs": reqs}
    eng.close()
    return out


def test_slice_tokens_match_reference(reference, port, dtype):
    for i, (ref, got, margins) in enumerate(zip(reference["tokens"], port["tokens"],
                                                reference["margins"])):
        low = [j for j, m in enumerate(margins) if m < LOGIT_TOL[dtype]]
        n = low[0] if low else len(ref)
        print(f"{dtype} request {i}: compared {n} of {len(ref)} tokens "
              f"(first low-margin step: {low[0] if low else None})")
        assert n >= MIN_COMPARED[dtype], (i, n, margins)
        assert got[:n] == ref[:n], (i, got, ref)
        assert len(got) == len(ref) == GEN


def test_slice_flags_and_census_match_reference(reference, port):
    assert port["stats"]["opq"]["flags"] == reference["flags"]
    assert port["census"] == reference["census"]
    assert port["census"][-1]["referenced"] == []


def test_slice_metrics_reconcile(port):
    s = port["stats"]
    assert s["completed"] == len(PROMPT_LENS)
    assert s["tokens_generated"] == sum(r.metrics.n_generated for r in port["reqs"])
    assert s["cache"]["decode_view_bytes"] == 0 and s["cache"]["native"]
    assert s["prefill_tokens"] == sum(PROMPT_LENS)
    assert all(r.done and r.finish_reason == "length" for r in port["reqs"])


# ------------------------------------------------------ port-only behaviour

def _params():
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import tensorizer as ttz
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import init_model as tinit
    return ttz.quantize_params(tinit(TCFG, gen), predicate=quant_predicate)


@pytest.fixture(scope="module")
def tparams():
    return _params()


class _ReissueExecutor:
    """Runs every instruction, then reports it as a straggler once, so the
    OPQ re-issues it on the backup lane: each step runs twice."""

    def __init__(self):
        self.runs = 0

    def __call__(self, ins, device):
        out = ins.fn(*(b.to_device(device) for b in ins.buffers))
        self.runs += 1
        if self.runs % 2 == 1:
            raise topq._StragglerTimeout()
        return out


def _serve(params, opq=None, **kw):
    eng = Engine(TCFG, params, EngineConfig(**{**ECFG, **kw}), device="cpu", opq=opq)
    reqs = [eng.submit(p, 10) for p in _prompts()[:3]]
    eng.run_until_complete()
    pool = eng.store.cache["k"].clone()
    eng.close()
    return [r.tokens for r in reqs], pool


def test_backup_reissue_runs_steps_twice_without_effect(tparams):
    """Idempotent steps: with every prefill and decode run twice (an OPQ
    backup re-issue), tokens and the final pool are unchanged."""
    toks, pool = _serve(tparams)
    ex = _ReissueExecutor()
    opq = topq.OPQ([torch.device("cpu")], executor=ex)
    toks2, pool2 = _serve(tparams, opq=opq)
    assert opq.stats["backups_issued"] > 0 and ex.runs == 2 * opq.stats["issued"]
    assert toks2 == toks and torch.equal(pool2, pool)
    opq.shutdown()


def test_use_opq_false_gives_same_tokens(tparams):
    assert _serve(tparams, use_opq=False)[0] == _serve(tparams)[0]


@pytest.mark.parametrize("kw,match", [
    ({"cache_backend": "contiguous", "paged_native": False,
      "paged_kernel": False}, "item 7"),
    ({"cache_backend": "auto", "paged_native": False, "paged_kernel": False},
     "item 7"),
    ({"paged_native": False, "paged_kernel": False}, "item 7"),
    ({"paged_kernel": False}, "item 7"),
    ({"prefill_chunk": 16}, "item 9"),
    ({"prefix_cache": True}, "item 9"),
    ({"speculative": True}, "item 9"),
])
def test_unported_options_raise(tparams, kw, match):
    with pytest.raises(ValueError, match=f"ROADMAP queue 1 {match}"):
        Engine(TCFG, tparams, EngineConfig(**{**ECFG, **kw}), device="cpu")


def test_unported_int8_kv_and_sampling_raise(tparams):
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 9"):
        Engine(TCFG.replace(kv_cache_dtype="int8"), tparams,
               EngineConfig(**ECFG), device="cpu")
    eng = Engine(TCFG, tparams, EngineConfig(**ECFG), device="cpu")

    class Sampled:
        greedy = False
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 9"):
        eng.submit([1, 2, 3], 4, sampling=Sampled())
    eng.close()


def test_cuda_requested_without_card_raises(tparams, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Engine(TCFG, tparams, EngineConfig(**ECFG), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Engine(TCFG, tparams, EngineConfig(**ECFG))
    from repro_torch.launch import serve as tserve
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserve.main(["--smoke", "--quantize", "serve", "--cache-backend", "paged",
                     "--paged-native", "--paged-kernel"])


def test_admission_control_and_retire_scrub(tparams):
    eng = Engine(TCFG, tparams, EngineConfig(**{**ECFG, "max_queue": 1}),
                 device="cpu")
    assert eng.submit(np.arange(40), 9) is None          # over max_seq_len
    with pytest.raises(QueueFull):
        eng.submit(np.arange(40), 9, strict=True)
    req = eng.submit(np.arange(5), 3)
    assert eng.submit(np.arange(5), 3) is None           # queue bound
    eng.step()
    leased = eng.store.debug_block_census()["referenced"]
    assert leased and bool((eng.store.cache["k"][:, leased] != 0).any())
    eng.run_until_complete()
    assert req.done and len(req.tokens) == 3
    # retire scrubbed the blocks back to pristine zeros and freed them
    assert not bool((eng.store.cache["k"][:, leased] != 0).any())
    assert eng.store.debug_block_census()["referenced"] == []
    assert eng.stats()["rejected"] == 3
    eng.close()


def test_cli_on_cpu_reports(capsys):
    from repro_torch.launch import serve as tserve
    reqs, stats = tserve.run(["--smoke", "--device", "cpu", "--quantize", "serve",
                              "--cache-backend", "paged", "--paged-native",
                              "--paged-kernel", "--requests", "3",
                              "--prompt-len", "8", "--gen", "8", "--slots", "2",
                              "--stagger-steps", "2"])
    out = capsys.readouterr().out
    assert "Tensorizer W8A8: 8 weight tensors quantized" in out
    assert "block-native decode" in out and "sample generation (req 0)" in out
    assert stats["completed"] == 3 and all(len(r.tokens) == 8 for r in reqs)
    assert stats["opq"]["flags"]["prefill/16"] == 3


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
