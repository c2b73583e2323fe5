"""Port parity: fused prefill-with-cache and paged decode of the dense model
(repro_torch.models) against repro.models on the same converted W8A8
weights, for tinyllama smoke (GQA, rep = 2) and an MHA variant (rep = 1).

The reference forward is compiled by XLA, and XLA may keep bf16
intermediates in f32 inside a fusion (``silu(h) * g`` would reach the next
int8 quantization unrounded), which moves int8 codes. The reference
therefore runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, so the compiled program
rounds where its source says; op for op the port computes the same IEEE
operations (tests/test_torch_layers.py holds each layer bitwise).

Tolerance, with the bf16 compute dtype of the served model: logits and
K/V entries in cache layout within 3% of the reference tensor's absolute
max, RMS difference within 0.5% of it. The one order-dependent step left
is the f32 contraction of the attention einsums (XLA's dot and torch's bmm
sum in different orders): a last-bit change there can move a bf16 rounding
and then one int8 activation code, which is 1/127 of its row's range.
Measured here: the GQA config is bitwise equal; the MHA config differs by
at most 2.1% (logits) and 1.2% (K/V) of the absolute max, RMS 0.23%, and
0.08 in logit units. With the f32 compute dtype no bf16 rounding can
amplify that order difference: within 1e-5 absolute (measured: 1.2e-6).
First tokens equal wherever the reference's top-2 margin exceeds
LOGIT_TOL (0.1 for bf16, 1e-4 for f32).
"""

import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config
from repro.core import tensorizer as jtz
from repro.distributed import sharding as shd
from repro.launch.serve import _quant_predicate
from repro.models import init_model
from repro.models import serve as JSV
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as TA
from repro_torch.models import serve as TSV
from repro_torch.models import steps as TST
from repro_torch.testing.params import params_from_numpy

CONFIGS = {"gqa": {}, "mha": {"n_kv": 4},
           "gqa-f32": {"dtype": "float32"}, "mha-f32": {"n_kv": 4, "dtype": "float32"}}


def _cfgs(name):
    kw = CONFIGS[name]
    return (get_config("tinyllama-1.1b").smoke().replace(quantize="serve", **kw),
            tget_config("tinyllama-1.1b").smoke().replace(quantize="serve", **kw))


def _numpy_tree(tree):
    """JAX params -> numpy, each QTensor as a q/scale namespace (picklable
    without the JAX package)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree)


def _reference():
    """The compiled reference prefill for every config (run in a subprocess,
    see module doc)."""
    return {name: _reference_one(name) for name in CONFIGS}


def _reference_one(name):
    cfg, _ = _cfgs(name)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(cfg, jax.random.PRNGKey(0)),
                                     predicate=_quant_predicate)
        logits, kv = jax.jit(lambda p, t: JSV.prefill_with_cache(
            p, cfg, {"tokens": t}))(params, jnp.asarray(tokens))
    return {
        "tokens": tokens, "params": _numpy_tree(params),
        "logits": np.asarray(logits.astype(jnp.float32)),
        "kv": {k: np.asarray(v.astype(jnp.float32)) for k, v in kv.items()},
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True,
                   timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, reference):
    ref = reference[request.param]
    return dict(ref, tcfg=_cfgs(request.param)[1],
                last=np.array([15, 6, 10], np.int32),
                params=params_from_numpy(ref["params"], device="cpu"))


LOGIT_TOL = {"bfloat16": 0.1, "float32": 1e-4}


def _close(out, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        return
    scale = np.abs(ref).max()
    d = np.abs(out - ref)
    assert d.max() <= 0.03 * scale, (d.max(), scale)
    assert np.sqrt((d ** 2).mean()) <= 0.005 * scale, (np.sqrt((d ** 2).mean()), scale)


def test_prefill_logits_and_kv(case):
    logits, kv = TSV.prefill_with_cache(case["params"], case["tcfg"],
                                        torch.from_numpy(case["tokens"]))
    dt = case["tcfg"].dtype
    assert logits.dtype == getattr(torch, dt)
    _close(logits.float().numpy(), case["logits"], dt)
    for name in ("k", "v"):
        assert kv[name].shape == case["kv"][name].shape   # (L, B, S, KV, hd)
        _close(kv[name].float().numpy(), case["kv"][name], dt)


@pytest.mark.parametrize("rows", [(24, None), (24, 8)], ids=["plain", "kernel"])
def test_prefill_engine_rows_match_jax(case, rows):
    """The engine's prefill formulation against the reference prefill: each
    query a one-query decode row of a 24-position row (an engine's
    max_seq_len past the 16 prompt positions), plain or through the kernel
    route's 8-position blocks (the paged-attention kernel's plain version
    on the CPU), under test_prefill_logits_and_kv's tolerances."""
    logits, kv = TSV.prefill_with_cache(case["params"], case["tcfg"],
                                        torch.from_numpy(case["tokens"]),
                                        TA.DecodeRows(*rows))
    dt = case["tcfg"].dtype
    _close(logits.float().numpy(), case["logits"], dt)
    for name in ("k", "v"):
        _close(kv[name].float().numpy(), case["kv"][name], dt)


def test_prefill_step_first_tokens(case):
    step = TST.make_prefill_with_cache_step(case["tcfg"])
    first, _ = step(case["params"], torch.from_numpy(case["tokens"]),
                    torch.from_numpy(case["last"]))
    rows = np.arange(len(case["last"]))
    ref_rows = case["logits"][rows, case["last"]]
    top2 = np.sort(ref_rows, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL[case["tcfg"].dtype]
    assert clear.sum() >= 2
    np.testing.assert_array_equal(first.numpy()[clear], ref_rows.argmax(-1)[clear])


def test_paged_decode_step_is_idempotent(case):
    """A decode step run twice on the same cache, as an OPQ backup re-issue
    would run it, returns the same tokens and leaves the pool bit-identical:
    the index advances in a new tensor, the pool writes rewrite the same
    cells with the same values."""
    tcfg, params = case["tcfg"], case["params"]
    _, kv = TSV.prefill_with_cache(params, tcfg, torch.from_numpy(case["tokens"]))
    bs, MB, B = 4, 6, 3
    cache = TSV.init_paged_cache(tcfg, B, B * MB + 1, bs, MB)
    tables = torch.arange(1, B * MB + 1, dtype=torch.int32).reshape(B, MB)
    S = 16
    pos = torch.arange(S)
    phys = tables[:, pos // bs].long()
    cache["k"][:, phys, pos % bs] = kv["k"]
    cache["v"][:, phys, pos % bs] = kv["v"]
    cache = dict(cache, tables=tables,
                 index=torch.from_numpy(case["last"] + 1).to(torch.int32))
    step = TST.make_paged_decode_step(tcfg)
    toks = torch.from_numpy(case["tokens"][:, :1].copy())
    index_before = cache["index"].clone()
    tok1, c1 = step(params, cache, toks)
    pool1 = (c1["k"].clone(), c1["v"].clone())
    tok2, c2 = step(params, cache, toks)
    assert torch.equal(cache["index"], index_before)
    assert torch.equal(c1["index"], index_before + 1)
    assert torch.equal(tok1, tok2)
    assert torch.equal(c2["k"], pool1[0]) and torch.equal(c2["v"], pool1[1])
    # the only cells written besides the seeded S positions per slot are at
    # each slot's index (new cells where the index lies past them)
    written = (c1["k"] != 0).any(dim=(-1, -2))[:, 1:]
    new_cells = int((index_before >= S).sum())
    assert int(written.sum()) == tcfg.n_layers * (B * S + new_cells)


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
