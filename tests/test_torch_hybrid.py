"""Hybrid-family parity: the port's Mamba2 pieces (repro_torch.models.ssm)
and zamba2 model paths against the JAX package's, on the same weights
(JAX's init, W8A8-quantized by its serve predicate, carried by
``params_from_numpy``) and the same inputs (a numpy seed), at zamba2-7b's
smoke config (4 layers: 2 groups, no tail) and at n_layers=5 (2 groups and
1 tail layer).

  * ``chunked_linear_recurrence`` at chunks 4, 8 and 24 (T = 24) against
    JAX and against the sequential recurrence in float64;
  * ``_causal_conv`` and ``apply_mamba2`` (decode and chunked) against
    JAX at f32 and bf16;
  * the hybrid forward (the embedding forward), step-by-step decode from a
    fresh per-slot cache, and ``prefill_recurrent`` (last rows and every
    cache leaf) against JAX;
  * in the port: the streamed build bitwise the whole-model build then
    quantized; the dequantized shared W_q bitwise the reference's;
    ``params_from_numpy`` carrying a None ``tail``; the fixed-row float
    product (the MoE router's) and the tree readout row-count invariant; softplus against
    ``jax.nn.softplus``; ``prefill_recurrent`` bitwise a replay of each
    prompt alone through the one-row decode step.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (tests/test_torch_model.py
says why), under an Auto-axis mesh. Tolerances, each with its reason:
  * the recurrence within 1e-5 absolute (f32 sums in another order;
    measured below 1e-6);
  * f32: 2e-5 absolute on the conv, the mamba block, logits and states
    (f32 contractions in another order: XLA's dot against torch's, the
    readout's tree against einsum, F.rms_norm's sum; measured below 5e-6);
  * bf16 (W8A8, the served dtype): the conv bitwise (op by op, the same
    roundings); the mamba block within 3% of the reference's absolute max
    and 0.5% RMS (a last-bit difference of an f32 sum moves a bf16
    rounding and, through the next projection's int8 requantization, a
    code: test_torch_configs.py's rule); decode steps and the admission
    scan, logits and every state leaf, within 10% and 2.5% (RoPE's cos and
    sin differ in their last f32 bit between XLA and torch; at some
    position that moves a bf16 K entry by one ulp, and the recurrence
    carries the moved codes into every later step: bitwise for the first
    three decode steps here, then measured at most 7.0% and 1.65%), with
    greedy tokens equal wherever the reference's top-2 margin exceeds 0.1;
  * the forward in f32 only: the reference's forward attends by its
    training attention, whose bf16 rounding the port's embedding forward
    does not carry (tests/test_torch_configs.py).
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
from repro.models import model as JM
from repro.models import serve as JSV
from repro.models import ssm as JSSM
from repro_torch.configs import get_config as tget_config
from repro_torch.core import tensorizer as tz
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import init_model as tinit
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models import ssm as TSSM
from repro_torch.testing.params import params_from_numpy

DTYPES = ["float32", "bfloat16"]
LAYERS = [4, 5]             # the smoke config (no tail), and one tail layer
CHUNKS = [4, 8, 24]
TOKENS = (2, 16)            # prefill / forward batch (a multiple of ssm_chunk 8)
LAST = [9, 15]             # prefill_recurrent's last prompt positions
SEQ = 24                    # the cache rows' length
DECODE_STEPS = 5


def _cfg(n_layers, dtype="float32"):
    return get_config("zamba2-7b").smoke().replace(n_layers=n_layers, dtype=dtype,
                                                   quantize="serve")


def _tcfg(n_layers, dtype="float32"):
    return tget_config("zamba2-7b").smoke().replace(n_layers=n_layers, dtype=dtype,
                                                    quantize="serve")


def _numpy_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_numpy_tree(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree)


def _recurrence_inputs():
    rng = np.random.default_rng(5)
    B, T, H, N, P = 2, 24, 3, 4, 5
    return {"log_a": -rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32),
            "Bm": rng.standard_normal((B, T, H, N)).astype(np.float32),
            "Cm": rng.standard_normal((B, T, H, N)).astype(np.float32),
            "X": rng.standard_normal((B, T, H, P)).astype(np.float32),
            "h0": rng.standard_normal((B, H, P, N)).astype(np.float32)}


def _block_inputs():
    cfg = _cfg(4)
    C = JSSM.d_inner(cfg) + 2 * cfg.ssm_state
    H, P, N = JSSM.n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    rng = np.random.default_rng(9)
    return {"x_chunked": rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32),
            "x_decode": rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32),
            "conv_x": (rng.standard_normal((3, 5, C)) * 2).astype(np.float32),
            "conv_state": rng.standard_normal((3, 3, C)).astype(np.float32),
            "ssm_state": rng.standard_normal((3, H, P, N)).astype(np.float32)}


def _tokens():
    return np.random.default_rng(13).integers(0, 256, TOKENS, dtype=np.int32)


def _reference():
    out = {}
    ri = _recurrence_inputs()
    for chunk in CHUNKS:
        y, h = JSSM.chunked_linear_recurrence(
            *(jnp.asarray(ri[k]) for k in ("log_a", "Bm", "Cm", "X")), chunk,
            h0=jnp.asarray(ri["h0"]))
        out["recurrence", chunk] = (np.asarray(y), np.asarray(h))
    bi = _block_inputs()
    toks = _tokens()
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        for n_layers in LAYERS:
            cfg0 = _cfg(n_layers)
            params = jtz.quantize_params(init_model(cfg0, jax.random.PRNGKey(4)),
                                         predicate=_quant_predicate)
            out["params", n_layers] = _numpy_tree(params)
            for dtype in DTYPES:
                cfg = cfg0.replace(dtype=dtype)
                if n_layers == 4:
                    mp = jax.tree.map(lambda t: t[0, 0], params["hybrid"]["groups"])["mamba"]
                    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
                    y, st = JSSM._causal_conv(cast(bi["conv_x"]), mp["conv_w"], mp["conv_b"],
                                              cast(bi["conv_state"]))
                    out["conv", dtype] = _numpy_tree((y, st))
                    y, st = JSSM.apply_mamba2(mp, cast(bi["x_chunked"]), cfg)
                    out["mamba_chunked", dtype] = _numpy_tree((y, st[0], st[1]))
                    y, st = JSSM.apply_mamba2(mp, cast(bi["x_decode"]), cfg,
                                              conv_state=cast(bi["conv_state"]),
                                              ssm_state=jnp.asarray(bi["ssm_state"]),
                                              decode=True)
                    out["mamba_decode", dtype] = _numpy_tree((y, st[0], st[1]))
                if dtype == "float32":
                    logits, _ = JM.forward(params, cfg, {"tokens": jnp.asarray(toks)})
                    out["forward", n_layers] = np.asarray(logits.astype(jnp.float32))
                row, cache = JSV.prefill_recurrent(params, cfg, jnp.asarray(toks),
                                                   jnp.asarray(LAST, jnp.int32), SEQ)
                out["prefill", n_layers, dtype] = (np.asarray(row), _numpy_tree(cache))
                cache = JSV.init_cache(cfg, TOKENS[0], SEQ, per_slot_index=True)
                steps = []
                for t in range(DECODE_STEPS):
                    logits, cache = JSV.decode(params, cfg, cache,
                                               {"tokens": jnp.asarray(toks[:, t:t + 1])})
                    steps.append(np.asarray(logits.astype(jnp.float32)))
                out["decode", n_layers, dtype] = (steps, _numpy_tree(cache))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("hybrid") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True, timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(out, ref, dtype, atol=2e-5, drift=False):
    """f32: within ``atol``. bf16: max and RMS difference as fractions of
    the reference's absolute max, 3% and 0.5% for one pass, 10% and 2.5%
    across steps (``drift``)."""
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
        return
    most, rms = (0.10, 0.025) if drift else (0.03, 0.005)
    scale = np.abs(ref).max()
    d = np.abs(out - ref)
    assert d.max() <= most * scale, (d.max(), scale)
    assert np.sqrt((d ** 2).mean()) <= rms * scale, (np.sqrt((d ** 2).mean()), scale)


def _clear_tokens_equal(out, ref, margin=0.1):
    """Greedy tokens equal wherever the reference's top-2 logit margin
    exceeds ``margin`` (tests/_torch_parity.py's bf16 LOGIT_TOL)."""
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > margin
    np.testing.assert_array_equal(out.argmax(-1)[clear], ref.argmax(-1)[clear])
    return int(clear.sum())


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


def _sequential(ri):
    """The recurrence step by step in float64."""
    la, Bm, Cm, X = (ri[k].astype(np.float64) for k in ("log_a", "Bm", "Cm", "X"))
    h = ri["h0"].astype(np.float64)
    ys = []
    for t in range(la.shape[1]):
        h = np.exp(la[:, t])[..., None, None] * h + X[:, t][..., None] * Bm[:, t][:, :, None, :]
        ys.append(np.einsum("bhn,bhpn->bhp", Cm[:, t], h))
    return np.stack(ys, 1), h


# ------------------------------------------------------------ recurrence

@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_recurrence_matches_jax_and_sequential(reference, chunk):
    ri = _recurrence_inputs()
    y, h = TSSM.chunked_linear_recurrence(
        *(torch.from_numpy(ri[k]) for k in ("log_a", "Bm", "Cm", "X")), chunk,
        h0=torch.from_numpy(ri["h0"]))
    ry, rh = reference["recurrence", chunk]
    np.testing.assert_allclose(_np(y), ry, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(h), rh, rtol=0, atol=1e-5)
    sy, sh = _sequential(ri)
    np.testing.assert_allclose(_np(y), sy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(h), sh, rtol=0, atol=1e-5)


def test_chunked_recurrence_refuses_a_ragged_chunk():
    ri = _recurrence_inputs()
    with pytest.raises(ValueError, match="multiple of chunk"):
        TSSM.chunked_linear_recurrence(
            *(torch.from_numpy(ri[k]) for k in ("log_a", "Bm", "Cm", "X")), 5)


# ------------------------------------------------------------ the block

def _mamba_params(reference):
    groups = params_from_numpy(reference["params", 4], device="cpu")["hybrid"]["groups"]
    return TM.layer_params(groups, (0, 0))["mamba"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax(reference, dtype):
    bi = _block_inputs()
    mp = _mamba_params(reference)
    tdt = getattr(torch, dtype)
    y, st = TSSM._causal_conv(torch.from_numpy(bi["conv_x"]).to(tdt), mp["conv_w"],
                              mp["conv_b"], torch.from_numpy(bi["conv_state"]).to(tdt))
    assert y.dtype == tdt and st.dtype == tdt
    ry, rst = reference["conv", dtype]
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), ry, rtol=0, atol=2e-5)
    else:
        np.testing.assert_array_equal(_np(y), ry)
    np.testing.assert_array_equal(_np(st), rst)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["chunked", "decode"])
def test_apply_mamba2_matches_jax(reference, dtype, mode):
    bi = _block_inputs()
    mp = _mamba_params(reference)
    cfg = _tcfg(4, dtype)
    tdt = getattr(torch, dtype)
    if mode == "chunked":
        y, (conv, ssm) = TSSM.apply_mamba2(mp, torch.from_numpy(bi["x_chunked"]).to(tdt), cfg)
    else:
        y, (conv, ssm) = TSSM.apply_mamba2(
            mp, torch.from_numpy(bi["x_decode"]).to(tdt), cfg,
            conv_state=torch.from_numpy(bi["conv_state"]).to(tdt),
            ssm_state=torch.from_numpy(bi["ssm_state"]), decode=True)
    ry, rconv, rssm = reference[f"mamba_{mode}", dtype]
    assert y.dtype == tdt and ssm.dtype == torch.float32
    _close(_np(y), ry, dtype)
    _close(_np(conv), rconv, dtype)
    _close(_np(ssm), rssm, dtype)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 2001), [0.0, -0.0, 1e-8, 19.99, 20.01]])
    x = x.astype(np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(_np(TSSM.softplus(torch.from_numpy(x))), ref, rtol=2e-7,
                               atol=0)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("n_layers", LAYERS)
def test_forward_matches_jax(reference, n_layers):
    cfg = _tcfg(n_layers)
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    assert (params["hybrid"]["tail"] is None) == (n_layers == 4)
    logits, hidden = TM.forward(params, cfg, torch.from_numpy(_tokens()),
                                return_hidden=True)
    assert tuple(hidden.shape) == TOKENS + (cfg.d_model,)
    _close(_np(logits), reference["forward", n_layers], "float32")


def _check_cache(got, ref, dtype):
    paths = sorted(p for p, _ in _leaves(ref))
    assert sorted(p for p, _ in _leaves(got)) == paths
    for path in paths:
        if path == ("index",):
            np.testing.assert_array_equal(_at(got, path).numpy(), _at(ref, path))
        else:
            _close(_np(_at(got, path)), _at(ref, path), dtype, drift=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_steps_match_jax(reference, n_layers, dtype):
    cfg = _tcfg(n_layers, dtype)
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    toks = torch.from_numpy(_tokens())
    cache = TSV.init_cache(cfg, TOKENS[0], SEQ, per_slot_index=True, device="cpu")
    steps, rcache = reference["decode", n_layers, dtype]
    compared = 0
    for t in range(DECODE_STEPS):
        logits, cache = TSV.decode(params, cfg, cache, toks[:, t:t + 1])
        _close(_np(logits), steps[t], dtype, drift=True)
        compared += _clear_tokens_equal(_np(logits), steps[t])
    assert compared >= 3, compared
    _check_cache(cache, rcache, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_recurrent_matches_jax(reference, n_layers, dtype):
    cfg = _tcfg(n_layers, dtype)
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    row, cache = TSV.prefill_recurrent(params, cfg, torch.from_numpy(_tokens()),
                                       torch.tensor(LAST, dtype=torch.int32), SEQ)
    rrow, rcache = reference["prefill", n_layers, dtype]
    assert row.dtype == torch.float32
    _close(_np(row), rrow, dtype, drift=True)
    assert _clear_tokens_equal(_np(row), rrow) >= 1
    _check_cache(cache, rcache, dtype)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_recurrent_is_a_replay_of_each_prompt_alone(n_layers):
    """Within the port, bitwise: the masked scan's last rows and state rows
    equal each prompt replayed alone through the one-row decode step."""
    cfg = _tcfg(n_layers, "bfloat16")
    gen = torch.Generator().manual_seed(2)
    params = TM.init_model_quantized(cfg, gen, quant_predicate, device="cpu")
    toks = torch.from_numpy(_tokens())
    row, cache = TSV.prefill_recurrent(params, cfg, toks,
                                       torch.tensor(LAST, dtype=torch.int32), SEQ)
    for b, last in enumerate(LAST):
        alone = TSV.init_cache(cfg, 1, SEQ, per_slot_index=True, device="cpu")
        for t in range(last + 1):
            logits, alone = TSV.decode(params, cfg, alone, toks[b:b + 1, t:t + 1])
        assert torch.equal(row[b], logits[0, -1].to(torch.float32))
        for path, leaf in _leaves(cache):
            got = leaf[b] if path == ("index",) else leaf[:, b]
            want = _at(alone, path)[0] if path == ("index",) else _at(alone, path)[:, 0]
            assert torch.equal(got, want), path


# ------------------------------------------------------- build and params

@pytest.mark.parametrize("n_layers", LAYERS)
def test_streamed_build_is_the_whole_build_quantized(n_layers):
    cfg = _tcfg(n_layers)
    streamed = TM.init_model_quantized(cfg, torch.Generator().manual_seed(3),
                                       quant_predicate, device="cpu")
    whole = tz.quantize_params(tinit(cfg, torch.Generator().manual_seed(3), device="cpu"),
                               quant_predicate)

    def flat(tree, path=()):
        if tree is None or isinstance(tree, torch.Tensor):
            return {path: tree}
        if isinstance(tree, tz.QTensor):
            return {path + ("q",): tree.q, path + ("scale",): tree.scale}
        return {k: v for n, sub in tree.items() for k, v in flat(sub, path + (n,)).items()}
    a, b = flat(streamed), flat(whole)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] is None and b[k] is None) or torch.equal(a[k], b[k]), k
    assert (("hybrid", "tail") in a) == (n_layers == 4)
    # what the predicate quantizes, as the reference's does: projections,
    # never the conv taps or the LoRA adapters
    hp = streamed["hybrid"]
    assert isinstance(hp["groups"]["mamba"]["wxbc"], tz.QTensor)
    assert tuple(hp["groups"]["mamba"]["wxbc"].q.shape[:2]) == (2, cfg.attn_every)
    assert isinstance(hp["shared"]["attn"]["wq"], tz.QTensor)
    assert not isinstance(hp["groups"]["mamba"]["conv_w"], tz.QTensor)
    assert not isinstance(hp["lora"]["qA"], tz.QTensor)
    assert TM.count_qtensors(streamed) == 4 + 7 + 1 + (4 if n_layers == 5 else 0)


def test_dequantized_shared_wq_is_the_references(reference):
    ref = reference["params", 4]["hybrid"]["shared"]["attn"]["wq"]
    got = params_from_numpy(reference["params", 4], device="cpu")["hybrid"]["shared"]
    want = np.asarray(jtz.QTensor(jnp.asarray(ref.q), jnp.asarray(ref.scale)).dequantize())
    np.testing.assert_array_equal(got["attn"]["wq"].dequantize().numpy(), want)


def test_params_from_numpy_carries_a_none_leaf():
    tree = {"a": np.ones((2, 3), np.float32), "tail": None,
            "w": types.SimpleNamespace(q=np.ones((2, 2), np.int8),
                                       scale=np.ones((1, 2), np.float32))}
    out = params_from_numpy(tree, device="cpu")
    assert out["tail"] is None and isinstance(out["w"], tz.QTensor)
    assert torch.equal(out["a"], torch.ones(2, 3))


# ------------------------------------------------------- row invariance

def test_fixed_rows_product_and_readout_keep_a_rows_bits():
    """A row's result does not depend on how many rows share the call: the
    fixed-row float product (layers.matmul_fixed_rows, which the MoE
    router's scores run through) and the ssm readout."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((70, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    full = TL.matmul_fixed_rows(x, w, 64)
    np.testing.assert_allclose(_np(full), _np(x) @ _np(w), rtol=1e-5, atol=1e-4)
    for n in (1, 3, 8, 64, 70):
        assert torch.equal(TL.matmul_fixed_rows(x[:n], w, 64), full[:n]), n
    c = torch.from_numpy(rng.standard_normal((9, 3, 16)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((9, 3, 5, 16)).astype(np.float32))
    full = TSSM.readout(c, h)
    np.testing.assert_allclose(_np(full), np.einsum("bhn,bhpn->bhp", _np(c), _np(h)),
                               rtol=0, atol=1e-5)
    for n in (1, 3, 8):
        assert torch.equal(TSSM.readout(c[:n], h[:n]), full[:n]), n


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
