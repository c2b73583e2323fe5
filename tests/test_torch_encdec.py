"""encdec-family parity: seamless-m4t-medium's smoke config (W8A8: 2 encoder
and 2 decoder layers, LayerNorm, GeLU) in the port against the JAX
package, on the same weights (JAX's init, quantized by its serve
predicate, carried by ``params_from_numpy``) and the same inputs (a numpy
seed): frame embeddings for the encoder, tokens for the decoder.

  * ``attention`` in both forms (plain at 12 positions, the online-softmax
    chunked form at 40 > attn_chunk 16), causal and bidirectional, and as
    cross-attention (``kv=``, whose K/V come from ``project_kv_for_cross``)
    against JAX at f32 and bf16; ``project_kv_for_cross`` against JAX;
    within the port the two forms agree where both apply;
  * ``forward`` against the reference's at f32 and bf16, and
    ``make_prefill_step`` against the reference's;
  * ``decode`` steps from a fresh cache against the reference's, logits
    and every cache leaf: the reference never writes its cross cache (only
    ``init_cache`` makes it, zero-filled), so its decode attends an
    all-zero cross cache, and the port's does exactly that;
  * the streamed build bitwise the whole build quantized (6 projections an
    encoder layer, 10 a decoder layer, the lm_head); per-slot indices
    refused as the reference refuses them.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``. Tolerances, each with its
reason: f32 within 2e-5 absolute plus 1e-5 relative (f32 sums in another
order; measured below 1e-6); bf16 (the served dtype) within 3% of the
reference's absolute max and 0.5% RMS for one layer's attention or
projection, 10% and 2.5% for the whole forward (4 layers; measured 0.58%
RMS) and over the decode steps (tests/test_torch_hybrid.py's rule: a
last-bit difference moves a bf16 rounding and, through an int8
requantization, a code, which the layers after it carry; the attention
forms measured bitwise in bf16), with greedy tokens equal where the
reference's top-2 margin exceeds the rule's LOGIT_TOL.
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
from repro.models import attention as JA
from repro.models import init_model
from repro.models import model as JM
from repro.models import serve as JSV
from repro.models import steps as JST
from repro_torch.configs import get_config as tget_config
from repro_torch.core import tensorizer as tz
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import attention as TA
from repro_torch.models import init_model as tinit
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models import steps as TST
from repro_torch.testing.params import params_from_numpy

DTYPES = ["float32", "bfloat16"]
B, S, SEQ = 2, 16, 24               # rows, decoder positions, cache rows
LENGTHS = [12, 40]                  # plain (<= attn_chunk 16) and chunked
DECODE_STEPS = 4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _cfg(dtype="float32"):
    return get_config("seamless-m4t-medium").smoke().replace(dtype=dtype, quantize="serve")


def _tcfg(dtype="float32"):
    return tget_config("seamless-m4t-medium").smoke().replace(dtype=dtype, quantize="serve")


def _inputs():
    rng = np.random.default_rng(21)
    D = _cfg().d_model
    return {"frames": rng.standard_normal((B, S // 4, D)).astype(np.float32),
            "tokens": rng.integers(0, 256, (B, S), dtype=np.int32),
            **{f"x{n}": rng.standard_normal((B, n, D)).astype(np.float32) for n in LENGTHS},
            "enc": rng.standard_normal((B, 10, D)).astype(np.float32)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy_tree(t) for t in tree)
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree)


def _positions(n):
    return np.broadcast_to(np.arange(n, dtype=np.int32), (B, n))


def _reference():
    out = {}
    inp = _inputs()
    batch = {"embeds": jnp.asarray(inp["frames"]), "tokens": jnp.asarray(inp["tokens"])}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(_cfg(), jax.random.PRNGKey(5)),
                                     predicate=_quant_predicate)
        out["params"] = _numpy_tree(params)
        dec0 = jax.tree.map(lambda t: t[0], params["decoder"])
        for dtype in DTYPES:
            cfg = _cfg(dtype)
            enc = jnp.asarray(inp["enc"]).astype(dtype)
            ck, cv = JA.project_kv_for_cross(dec0["cross_attn"], enc, cfg)
            out["cross_kv", dtype] = _numpy_tree((ck, cv))
            for n in LENGTHS:
                x = jnp.asarray(inp[f"x{n}"]).astype(dtype)
                pos = jnp.asarray(_positions(n))
                for causal in (True, False):
                    out["attention", n, causal, dtype] = _numpy_tree(JA.attention(
                        dec0["self_attn"], x, cfg, positions=pos, causal=causal))
                out["cross", n, dtype] = _numpy_tree(JA.attention(
                    dec0["cross_attn"], x, cfg, positions=pos, kv=(ck, cv)))
            out["forward", dtype] = _numpy_tree(JM.forward(params, cfg, batch)[0])
            if dtype == "float32":
                out["prefill_step"] = np.asarray(JST.make_prefill_step(cfg)(params, batch))
            cache = JSV.init_cache(cfg, B, SEQ)
            steps = []
            for t in range(DECODE_STEPS):
                logits, cache = JSV.decode(params, cfg, cache,
                                           {"tokens": jnp.asarray(inp["tokens"][:, t:t + 1])})
                steps.append(np.asarray(logits.astype(jnp.float32)))
            out["decode", dtype] = (steps, _numpy_tree(cache))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("encdec") / "ref.pkl"
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


def _clear_tokens_equal(out, ref, dtype):
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LOGIT_TOL[dtype]
    np.testing.assert_array_equal(out.argmax(-1)[clear], ref.argmax(-1)[clear])
    return int(clear.sum())


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _params(reference):
    return params_from_numpy(reference["params"], device="cpu")


def _dec0(reference):
    return TM.layer_params(_params(reference)["decoder"], 0)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("dtype", DTYPES)
def test_project_kv_for_cross_matches_jax(reference, dtype):
    ck, cv = TA.project_kv_for_cross(_dec0(reference)["cross_attn"],
                                     _t(_inputs()["enc"], dtype), _tcfg(dtype))
    for got, ref in zip((ck, cv), reference["cross_kv", dtype]):
        assert got.dtype == getattr(torch, dtype)
        _close(_np(got), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_attention_matches_jax(reference, n, causal, dtype):
    cfg, lp = _tcfg(dtype), _dec0(reference)
    got = TA.attention(lp["self_attn"], _t(_inputs()[f"x{n}"], dtype), cfg,
                       positions=_t(_positions(n)), causal=causal)
    _close(_np(got), reference["attention", n, causal, dtype], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_cross_attention_matches_jax(reference, n, dtype):
    cfg, lp = _tcfg(dtype), _dec0(reference)
    kv = TA.project_kv_for_cross(lp["cross_attn"], _t(_inputs()["enc"], dtype), cfg)
    got = TA.attention(lp["cross_attn"], _t(_inputs()[f"x{n}"], dtype), cfg,
                       positions=_t(_positions(n)), kv=kv, causal=True)
    _close(_np(got), reference["cross", n, dtype], dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_and_plain_forms_agree(reference, causal):
    """Within the port, in f32: the online-softmax form at chunks of 16, 7
    (ragged: the padding is masked) and 40 against the plain form."""
    cfg, lp = _tcfg(), _dec0(reference)
    x = _t(_inputs()["x40"])
    q, k, v = TA._project_qkv(lp["self_attn"], x, cfg, _t(_positions(40)))
    plain = TA._plain_attention(q, k, v, causal)
    for chunk in (16, 7, 40):
        np.testing.assert_allclose(_np(TA._chunked_attention(q, k, v, causal, chunk)),
                                   _np(plain), rtol=0, atol=2e-6)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(reference, dtype):
    inp = _inputs()
    logits, none = TM.forward(_params(reference), _tcfg(dtype), _t(inp["tokens"]),
                              embeds=_t(inp["frames"]))
    assert none is None and tuple(logits.shape) == (B, S, _tcfg().vocab_padded)
    ref = reference["forward", dtype]
    _close(_np(logits), ref, dtype, drift=True)
    assert _clear_tokens_equal(_np(logits), ref, dtype) >= 8
    with pytest.raises(ValueError, match="decoder-only"):
        TM.forward(_params(reference), _tcfg(dtype), _t(inp["tokens"]),
                   embeds=_t(inp["frames"]), return_hidden=True)


def test_prefill_step_matches_jax(reference):
    inp = _inputs()
    row = TST.make_prefill_step(_tcfg())(_params(reference), _t(inp["tokens"]),
                                         embeds=_t(inp["frames"]))
    _close(_np(row), reference["prefill_step"], "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_jax(reference, dtype):
    cfg, params = _tcfg(dtype), _params(reference)
    toks = _t(_inputs()["tokens"])
    cache = TSV.init_cache(cfg, B, SEQ, device="cpu")
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, B, SEQ // 4, cfg.n_kv, cfg.hd)
    assert cache["index"].ndim == 0
    steps, rcache = reference["decode", dtype]
    compared = 0
    for t in range(DECODE_STEPS):
        logits, cache = TSV.decode(params, cfg, cache, toks[:, t:t + 1])
        _close(_np(logits), steps[t], dtype, drift=True)
        compared += _clear_tokens_equal(_np(logits), steps[t], dtype)
    assert compared >= 4
    assert sorted(cache) == sorted(rcache)
    for name in ("k", "v"):
        _close(_np(cache[name]), rcache[name], dtype, drift=True)
    for name in ("cross_k", "cross_v"):        # never written, by either
        assert not cache[name].any() and not rcache[name].any()
    assert int(cache["index"]) == int(rcache["index"]) == DECODE_STEPS


def test_per_slot_index_is_refused():
    with pytest.raises(ValueError, match="per-slot cache indices unsupported for encdec"):
        TSV.init_cache(_tcfg(), B, SEQ, per_slot_index=True, device="cpu")


def test_streamed_build_is_the_whole_build_quantized():
    cfg = _tcfg()
    streamed = TM.init_model_quantized(cfg, torch.Generator().manual_seed(3),
                                       quant_predicate, device="cpu")
    whole = tz.quantize_params(tinit(cfg, torch.Generator().manual_seed(3), device="cpu"),
                               quant_predicate)

    def flat(tree, path=()):
        if isinstance(tree, torch.Tensor):
            return {path: tree}
        if isinstance(tree, tz.QTensor):
            return {path + ("q",): tree.q, path + ("scale",): tree.scale}
        return {k: v for n, sub in tree.items() for k, v in flat(sub, path + (n,)).items()}
    a, b = flat(streamed), flat(whole)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert sorted(streamed) == ["decoder", "embed", "enc_final_ln", "encoder",
                                "final_ln", "lm_head"]
    assert TM.count_qtensors(streamed) == 6 + 10 + 1


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
