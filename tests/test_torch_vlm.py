"""vlm-family parity: qwen2-vl-2b's smoke config (W8A8) in the port against
the JAX package, on the same weights (JAX's init, quantized by its serve
predicate, carried by ``params_from_numpy``) and the same inputs (a numpy
seed): precomputed patch embeddings with seeded (t, h, w) M-RoPE position
ids, then text tokens.

  * ``apply_mrope`` against JAX's, f32 and bf16; with the three position
    rows equal it is plain RoPE, bitwise;
  * ``forward`` over embeds and ``positions3``: logits and the per-layer K/V
    against the reference's ``prefill_with_cache`` (its decode-mirrored
    attention) at f32 and bf16, and the logits against the reference's
    ``forward`` (its training attention) at f32; ``make_prefill_step``
    against the reference's;
  * ``decode`` from a cache seeded by ``prefill_with_cache`` (the default
    positions3: the index on all three sections; and given positions3),
    and ``decode_paged`` on the plain route from the same seeded pool,
    logits and the written cache entries against the reference's steps;
  * in the port: ``decode_paged`` plain bitwise ``decode``; the kernel route
    on the CPU is the kernel's plain version (within the paged-attention
    tests' 1e-5 of plain in f32); the streamed build bitwise the whole
    build quantized (7 projections a layer and the lm_head); the paged and
    contiguous caches accept vlm.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``. Tolerances, each with its
reason: M-RoPE within 1e-6 absolute in f32 (cos and sin in the last bit)
and within one bf16 ulp of the value in bf16; f32 logits and K/V within
2e-5 absolute plus 1e-5 relative (f32 sums in another order; measured
below 1e-6); bf16 (the served dtype) within 3% of the reference's absolute
max and 0.5% RMS for one pass and 10% and 2.5% over the decode steps
(tests/test_torch_hybrid.py's rule: a last-bit difference moves a bf16
rounding and, through an int8 requantization, a code), with greedy tokens
equal where the reference's top-2 margin exceeds 0.1.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import serve as JSV
from repro.models import steps as JST
from repro_torch.configs import get_config as tget_config
from repro_torch.core import tensorizer as tz
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import init_model as tinit
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models import steps as TST
from repro_torch.serving.store import make_store
from repro_torch.testing.params import params_from_numpy

DTYPES = ["float32", "bfloat16"]
B, S, SEQ, BS = 2, 16, 32, 8       # rows, patch positions, cache rows, block size
DECODE_STEPS = 4
GRID = 4                            # a 4 x 4 patch grid


def _cfg(dtype="float32"):
    return get_config("qwen2-vl-2b").smoke().replace(dtype=dtype, quantize="serve")


def _tcfg(dtype="float32"):
    return tget_config("qwen2-vl-2b").smoke().replace(dtype=dtype, quantize="serve")


def _inputs():
    """Patch embeddings, their (t, h, w) ids over a GRID x GRID grid (t per
    row), text tokens, and explicit decode positions3 (text after the
    image: every section at the index)."""
    rng = np.random.default_rng(11)
    cfg = _cfg()
    hw = np.arange(S)
    p3 = np.stack([np.broadcast_to(rng.integers(0, 3, (B, 1)), (B, S)),
                   np.broadcast_to(hw // GRID, (B, S)), np.broadcast_to(hw % GRID, (B, S))])
    return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "positions3": p3.astype(np.int32),
            "tokens": rng.integers(0, 256, (B, DECODE_STEPS), dtype=np.int32),
            "rope_x": rng.standard_normal((B, 5, 4, 16)).astype(np.float32),
            "rope_p3": rng.integers(0, 50, (3, B, 5)).astype(np.int32),
            "step_p3": (S + 3 + np.zeros((3, B, 1))).astype(np.int32)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree)


def _seeded_pool(cfg, kv):
    """A paged cache for B slots of SEQ positions seeded with prefill K/V
    (L, B, S, KV, hd): slot b owns blocks 1 + b * MB.. in order."""
    MB = SEQ // BS
    cache = JSV.init_paged_cache(cfg, B, 1 + B * MB, BS, MB)
    tables = 1 + np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    k, v = (np.asarray(kv[n]) for n in ("k", "v"))
    pool_k, pool_v = np.asarray(cache["k"]).copy(), np.asarray(cache["v"]).copy()
    for b in range(B):
        for j in range(S // BS):
            pool_k[:, tables[b, j]] = k[:, b, j * BS:(j + 1) * BS]
            pool_v[:, tables[b, j]] = v[:, b, j * BS:(j + 1) * BS]
    dt = cache["k"].dtype
    return dict(cache, k=jnp.asarray(pool_k, dt), v=jnp.asarray(pool_v, dt),
                tables=jnp.asarray(tables), index=jnp.full((B,), S, jnp.int32))


def _reference():
    out = {}
    inp = _inputs()
    for dtype in DTYPES:
        x = jnp.asarray(inp["rope_x"]).astype(dtype)
        out["mrope", dtype] = _numpy_tree(JL.apply_mrope(x, jnp.asarray(inp["rope_p3"]),
                                                         10000.0, (2, 3, 3)))
    batch = {"embeds": jnp.asarray(inp["embeds"]),
             "positions3": jnp.asarray(inp["positions3"])}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(_cfg(), jax.random.PRNGKey(4)),
                                     predicate=_quant_predicate)
        out["params"] = _numpy_tree(params)
        for dtype in DTYPES:
            cfg = _cfg(dtype)
            if dtype == "float32":
                out["forward"] = np.asarray(JM.forward(params, cfg, batch)[0])
                out["prefill_step"] = np.asarray(JST.make_prefill_step(cfg)(params, batch))
            logits, kv = JSV.prefill_with_cache(params, cfg, batch)
            out["prefill", dtype] = (_numpy_tree(logits), _numpy_tree(kv))
            for mode in ("contiguous", "contiguous_p3", "paged"):
                if mode == "paged":
                    cache = _seeded_pool(cfg, kv)
                else:
                    cache = JSV.init_cache(cfg, B, SEQ, per_slot_index=True)
                    cache = dict(cache, index=jnp.full((B,), S, jnp.int32), **{
                        n: cache[n].at[:, :, :S].set(kv[n]) for n in ("k", "v")})
                steps = []
                for t in range(DECODE_STEPS):
                    sb = {"tokens": jnp.asarray(inp["tokens"][:, t:t + 1])}
                    if mode == "contiguous_p3":
                        sb["positions3"] = jnp.asarray(inp["step_p3"] + t)
                    if mode == "paged":
                        logits, cache = JSV.decode_paged(params, cfg, cache, sb)
                    else:
                        logits, cache = JSV.decode(params, cfg, cache, sb)
                    steps.append(np.asarray(logits.astype(jnp.float32)))
                out["decode", mode, dtype] = (steps, _numpy_tree(cache))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("vlm") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True, timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(out, ref, dtype, drift=False):
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5)
        return
    most, rms = (0.10, 0.025) if drift else (0.03, 0.005)
    scale = np.abs(ref).max()
    d = np.abs(out - ref)
    assert d.max() <= most * scale, (d.max(), scale)
    assert np.sqrt((d ** 2).mean()) <= rms * scale, (np.sqrt((d ** 2).mean()), scale)


def _clear_tokens_equal(out, ref, margin):
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > margin
    np.testing.assert_array_equal(out.argmax(-1)[clear], ref.argmax(-1)[clear])
    return int(clear.sum())


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _params(reference):
    return params_from_numpy(reference["params"], device="cpu")


# ------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mrope_matches_jax(reference, dtype):
    inp = _inputs()
    got = TL.apply_mrope(_t(inp["rope_x"], dtype), _t(inp["rope_p3"]), 10000.0, (2, 3, 3))
    assert got.dtype == getattr(torch, dtype)
    ref = reference["mrope", dtype]
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), ref, rtol=2 ** -8, atol=0)
    x, pos = _t(inp["rope_x"]), _t(inp["rope_p3"][0])
    same = TL.apply_mrope(x, pos[None].expand(3, *pos.shape), 10000.0, (2, 3, 3))
    assert torch.equal(same, TL.apply_rope(x, pos, 10000.0))


def test_apply_mrope_refuses_sections_that_do_not_split_the_rotary_dims():
    with pytest.raises(ValueError, match="do not split"):
        TL.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2, dtype=torch.int32),
                       1e4, (2, 3, 4))


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_over_embeds_matches_the_references_prefill(reference, dtype):
    inp = _inputs()
    logits, kv = TM.forward(_params(reference), _tcfg(dtype), None,
                            embeds=_t(inp["embeds"]), positions3=_t(inp["positions3"]))
    rlogits, rkv = reference["prefill", dtype]
    _close(_np(logits), rlogits, dtype)
    assert sorted(kv) == ["k", "v"]
    for n in ("k", "v"):
        assert kv[n].dtype == getattr(torch, dtype)
        _close(_np(kv[n]), rkv[n], dtype)
    margin = 1e-4 if dtype == "float32" else 0.1
    assert _clear_tokens_equal(_np(logits), rlogits, margin) >= 8


def test_forward_and_prefill_step_match_the_references_forward(reference):
    inp = _inputs()
    cfg, params = _tcfg(), _params(reference)
    logits, hidden = TM.forward(params, cfg, None, embeds=_t(inp["embeds"]),
                                positions3=_t(inp["positions3"]), return_hidden=True)
    assert tuple(hidden.shape) == (B, S, cfg.d_model)
    _close(_np(logits), reference["forward"], "float32")
    row = TST.make_prefill_step(cfg)(params, None, embeds=_t(inp["embeds"]),
                                     positions3=_t(inp["positions3"]))
    _close(_np(row), reference["prefill_step"], "float32")
    with pytest.raises(ValueError, match="mrope requires"):
        TM.forward(params, cfg, None, embeds=_t(inp["embeds"]))


# ------------------------------------------------------------- decode

def _seeded(cfg, kv, mode):
    """The port's cache seeded with the prefill K/V, as the reference's."""
    if mode == "paged":
        MB = SEQ // BS
        cache = TSV.init_paged_cache(cfg, B, 1 + B * MB, BS, MB, device="cpu")
        cache["tables"] = 1 + torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
        for b in range(B):
            for j in range(S // BS):
                for n in ("k", "v"):
                    cache[n][:, 1 + b * MB + j] = kv[n][:, b, j * BS:(j + 1) * BS]
    else:
        cache = TSV.init_cache(cfg, B, SEQ, per_slot_index=True, device="cpu")
        for n in ("k", "v"):
            cache[n][:, :, :S] = kv[n]
    cache["index"] = torch.full((B,), S, dtype=torch.int32)
    return cache


def _run(params, cfg, cache, mode, use_kernel=False):
    inp, steps = _inputs(), []
    for t in range(DECODE_STEPS):
        toks = _t(inp["tokens"][:, t:t + 1])
        if mode == "paged":
            logits, cache = TSV.decode_paged(params, cfg, cache, toks, use_kernel=use_kernel)
        else:
            p3 = _t(inp["step_p3"] + t) if mode == "contiguous_p3" else None
            logits, cache = TSV.decode(params, cfg, cache, toks, positions3=p3)
        steps.append(logits)
    return steps, cache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["contiguous", "contiguous_p3", "paged"])
def test_decode_matches_jax(reference, dtype, mode):
    cfg, params = _tcfg(dtype), _params(reference)
    inp = _inputs()
    _, kv = TSV.prefill_with_cache(params, cfg, None, embeds=_t(inp["embeds"]),
                                   positions3=_t(inp["positions3"]))
    steps, cache = _run(params, cfg, _seeded(cfg, kv, mode), mode)
    rsteps, rcache = reference["decode", mode, dtype]
    compared = 0
    for got, ref in zip(steps, rsteps):
        _close(_np(got), ref, dtype, drift=True)
        compared += _clear_tokens_equal(_np(got), ref, 1e-4 if dtype == "float32" else 0.1)
    assert compared >= 4
    for n in ("k", "v"):
        _close(_np(cache[n]), rcache[n], dtype, drift=True)
    np.testing.assert_array_equal(cache["index"].numpy(), rcache["index"])


def test_paged_routes_against_contiguous_decode(reference):
    """Within the port: the paged plain route is contiguous decode's bits
    (logits and the written pool cells); the kernel route, which on the CPU
    runs the kernel's plain version, stays within 1e-5 of plain in f32."""
    cfg, params = _tcfg(), _params(reference)
    inp = _inputs()
    _, kv = TSV.prefill_with_cache(params, cfg, None, embeds=_t(inp["embeds"]),
                                   positions3=_t(inp["positions3"]))
    contiguous, ccache = _run(params, cfg, _seeded(cfg, kv, "contiguous"), "contiguous")
    plain, pcache = _run(params, cfg, _seeded(cfg, kv, "paged"), "paged")
    kernel, _ = _run(params, cfg, _seeded(cfg, kv, "paged"), "paged", use_kernel=True)
    MB = SEQ // BS
    for a, b, c in zip(contiguous, plain, kernel):
        assert torch.equal(a, b)
        np.testing.assert_allclose(_np(c), _np(b), rtol=0, atol=1e-5)
    for b in range(B):
        rows = pcache["k"][:, 1 + b * MB:1 + (b + 1) * MB].reshape(ccache["k"][:, b].shape)
        assert torch.equal(rows, ccache["k"][:, b])


# --------------------------------------------------------- build, stores

def test_streamed_build_is_the_whole_build_quantized():
    cfg = _tcfg()
    streamed = TM.init_model_quantized(cfg, torch.Generator().manual_seed(3),
                                       quant_predicate, device="cpu")
    whole = tz.quantize_params(tinit(cfg, torch.Generator().manual_seed(3), device="cpu"),
                               quant_predicate)
    layers = streamed["layers"]
    for part, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wg", "wo"))):
        for n in names:
            a, b = layers[part][n], whole["layers"][part][n]
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), (part, n)
    assert torch.equal(streamed["lm_head"].q, whole["lm_head"].q)
    assert torch.equal(streamed["embed"], whole["embed"])
    assert TM.count_qtensors(streamed) == 7 + 1


def test_stores_accept_the_vlm():
    cfg = _tcfg()
    assert make_store(cfg, 2, 32, device="cpu").kind == "contiguous"
    assert make_store(cfg, 2, 32, backend="paged", native=True, device="cpu").kind == "paged"


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
