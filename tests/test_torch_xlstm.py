"""ssm-family parity: the port's xLSTM blocks (repro_torch.models.xlstm) and
xlstm model paths against the JAX package's, on the same weights (JAX's
init, W8A8-quantized by its serve predicate, carried by
``params_from_numpy``) and the same inputs (a numpy seed), at xlstm-125m's
smoke config (2 layers: one mLSTM/sLSTM pair) and at n_layers=4 (two
pairs).

  * ``_stabilizer`` against JAX and against the sequential max-plus
    recurrence in float64;
  * ``apply_mlstm`` (the chunked full-sequence form at T = 16 and 12, the
    latter a chunk that does not divide T; and a decode step from a given
    state) and ``apply_slstm`` (a sequence, and one step from a given
    state) against JAX at f32 and bf16;
  * the xlstm forward (the embedding forward), step-by-step decode from a
    fresh per-slot cache, and ``prefill_recurrent`` (last rows and every
    cache leaf) against JAX;
  * in the port: the streamed build bitwise the whole-model build then
    quantized (what the serve predicate quantizes: 7 mLSTM and 4 sLSTM
    projections a pair, never wup, wdown or the recurrent R); log_sigmoid
    and sigmoid against JAX's; ``prefill_recurrent`` bitwise a replay of
    each prompt alone through the one-row decode step; the decode body's
    contractions (the readout and normalizer trees, the fixed-row
    recurrent and up/down products) keep a row's bits at 1, 3, 8 and 64
    rows.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (tests/test_torch_model.py
says why), under an Auto-axis mesh. Tolerances, each with its reason:
  * the stabilizer within 1e-6 absolute (a cumsum and a cummax in f32;
    measured 0);
  * f32: 2e-5 absolute plus 1e-5 relative on a block's output and states
    (f32 sums in another order: the readout tree and the fixed-row
    products against XLA's dots; measured below 2.2e-5 at values near 6);
    the forward, decode steps and the admission scan within 1% and 0.1%
    of the reference's absolute max (max and RMS difference), with greedy
    tokens equal wherever the top-2 margin exceeds 1e-4: an f32 last-bit
    difference can move an int8 activation code of the next W8A8
    projection (measured once in the forward at two pairs: 0.2%, 0.02%);
  * bf16 (W8A8, the served dtype): a block's output within 3% of the
    reference's absolute max and 0.5% RMS (a last-bit difference of an f32
    sum moves a bf16 rounding and, through the next projection's int8
    requantization, a code: tests/test_torch_configs.py's rule); the
    forward, decode steps and the admission scan, logits and every state
    leaf, within 10% and 2.5% (the recurrence carries a moved code into
    every later position; measured at most 1.3% and 0.2%), with greedy
    tokens equal wherever the reference's top-2 margin exceeds 0.1.
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
from repro.models import xlstm as JXL
from repro_torch.configs import get_config as tget_config
from repro_torch.core import tensorizer as tz
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import init_model as tinit
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models import ssm as TSSM
from repro_torch.models import xlstm as TXL
from repro_torch.testing.params import params_from_numpy

DTYPES = ["float32", "bfloat16"]
LAYERS = [2, 4]             # the smoke config (one pair), and two pairs
BLOCK_T = [16, 12]          # full-sequence lengths: chunk 8 divides 16, not 12
TOKENS = (2, 16)            # prefill / forward batch
LAST = [9, 15]              # prefill_recurrent's last prompt positions
SEQ = 24                    # the cache rows' length
DECODE_STEPS = 5
ROWS = (1, 3, 8, 64)


def _cfg(n_layers, dtype="float32"):
    return get_config("xlstm-125m").smoke().replace(n_layers=n_layers, dtype=dtype,
                                                    quantize="serve")


def _tcfg(n_layers, dtype="float32"):
    return tget_config("xlstm-125m").smoke().replace(n_layers=n_layers, dtype=dtype,
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


def _stabilizer_inputs():
    rng = np.random.default_rng(5)
    return {"log_f": -rng.uniform(0.01, 2.0, (2, 12, 3)).astype(np.float32),
            "log_i": (rng.standard_normal((2, 12, 3)) * 3).astype(np.float32)}


def _block_inputs():
    cfg = _cfg(2)
    H, hd, D = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
    rng = np.random.default_rng(9)
    return {**{f"x{T}": rng.standard_normal((3, T, D)).astype(np.float32) for T in BLOCK_T},
            "x_decode": rng.standard_normal((3, 1, D)).astype(np.float32),
            "C": (rng.standard_normal((3, H, hd, hd)) * 0.3).astype(np.float32),
            "n": (rng.standard_normal((3, H, hd)) * 0.3).astype(np.float32),
            "m": rng.uniform(-2, 2, (3, H)).astype(np.float32),
            "s_c": rng.standard_normal((3, D)).astype(np.float32),
            "s_n": rng.uniform(0.5, 2, (3, D)).astype(np.float32),
            "s_h": rng.standard_normal((3, D)).astype(np.float32),
            "s_m": rng.uniform(-2, 2, (3, D)).astype(np.float32)}


def _tokens():
    return np.random.default_rng(13).integers(0, 256, TOKENS, dtype=np.int32)


def _reference():
    out = {}
    si = _stabilizer_inputs()
    out["stabilizer"] = np.asarray(JXL._stabilizer(jnp.asarray(si["log_f"]),
                                                   jnp.asarray(si["log_i"])))
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4001) * 20).astype(np.float32)
    out["gates_x"] = x
    out["log_sigmoid"] = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    out["sigmoid"] = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
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
                if n_layers == 2:
                    pair = jax.tree.map(lambda t: t[0], params["xlstm"]["pairs"])
                    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
                    for T in BLOCK_T:
                        out["mlstm", T, dtype] = _numpy_tree(
                            JXL.apply_mlstm(pair["mlstm"], cast(bi[f"x{T}"]), cfg))
                        out["slstm", T, dtype] = _numpy_tree(
                            JXL.apply_slstm(pair["slstm"], cast(bi[f"x{T}"]), cfg))
                    mstate = tuple(jnp.asarray(bi[k]) for k in ("C", "n", "m"))
                    out["mlstm_decode", dtype] = _numpy_tree(JXL.apply_mlstm(
                        pair["mlstm"], cast(bi["x_decode"]), cfg, state=mstate, decode=True))
                    sstate = tuple(jnp.asarray(bi[k]) for k in ("s_c", "s_n", "s_h", "s_m"))
                    out["slstm_decode", dtype] = _numpy_tree(JXL.apply_slstm(
                        pair["slstm"], cast(bi["x_decode"]), cfg, state=sstate, decode=True))
                logits, _ = JM.forward(params, cfg, {"tokens": jnp.asarray(toks)})
                out["forward", n_layers, dtype] = np.asarray(logits.astype(jnp.float32))
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
    out = tmp_path_factory.mktemp("xlstm") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True, timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(out, ref, dtype, drift=False):
    """f32: within 2e-5 absolute plus 1e-5 relative; with ``drift`` (a
    whole forward or several steps) the max and RMS difference within 1%
    and 0.1% of the reference's absolute max instead, an int8 activation
    code moved by an f32 last bit. bf16: the max and RMS difference as
    fractions of the reference's absolute max, 3% and 0.5% for one pass,
    10% and 2.5% with ``drift``."""
    if dtype == "float32" and not drift:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5)
        return
    most, rms = {("float32", True): (0.01, 0.001), ("bfloat16", False): (0.03, 0.005),
                 ("bfloat16", True): (0.10, 0.025)}[dtype, drift]
    scale = np.abs(ref).max()
    d = np.abs(out - ref)
    assert d.max() <= most * scale, (d.max(), scale)
    assert np.sqrt((d ** 2).mean()) <= rms * scale, (np.sqrt((d ** 2).mean()), scale)


def _clear_tokens_equal(out, ref, margin=0.1):
    """Greedy tokens equal wherever the reference's top-2 logit margin
    exceeds ``margin`` (tests/_torch_parity.py's LOGIT_TOL: 0.1 in bf16,
    1e-4 in f32)."""
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > margin
    np.testing.assert_array_equal(out.argmax(-1)[clear], ref.argmax(-1)[clear])
    return int(clear.sum())


def _pair(reference):
    pairs = params_from_numpy(reference["params", 2], device="cpu")["xlstm"]["pairs"]
    return TM.layer_params(pairs, 0)


# ------------------------------------------------------------ stabilizer

def test_stabilizer_matches_jax_and_the_sequential_recurrence(reference):
    si = _stabilizer_inputs()
    got = _np(TXL._stabilizer(torch.from_numpy(si["log_f"]), torch.from_numpy(si["log_i"])))
    np.testing.assert_allclose(got, reference["stabilizer"], rtol=0, atol=1e-6)
    lf, li = (si[k].astype(np.float64) for k in ("log_f", "log_i"))
    m = np.full(lf.shape[::2], TXL.M_INIT)
    for t in range(lf.shape[1]):
        m = np.maximum(lf[:, t] + m, li[:, t])
        np.testing.assert_allclose(got[:, t], m, rtol=0, atol=1e-5)


def test_gates_match_jax(reference):
    x = torch.from_numpy(reference["gates_x"])
    np.testing.assert_allclose(_np(TXL.log_sigmoid(x)), reference["log_sigmoid"],
                               rtol=2e-7, atol=1e-30)
    np.testing.assert_allclose(_np(TXL.sigmoid(x)), reference["sigmoid"], rtol=2e-7,
                               atol=1e-30)


# ------------------------------------------------------------ the blocks

def _check_block(got, ref, dtype):
    y, state = got
    ry, rstate = ref
    assert len(state) == len(rstate)
    _close(_np(y), ry, dtype)
    for s, r in zip(state, rstate):
        assert s.dtype == torch.float32
        _close(_np(s), r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", BLOCK_T)
def test_blocks_full_sequence_match_jax(reference, dtype, T):
    pair, cfg = _pair(reference), _tcfg(2, dtype)
    x = torch.from_numpy(_block_inputs()[f"x{T}"]).to(getattr(torch, dtype))
    _check_block(TXL.apply_mlstm(pair["mlstm"], x, cfg), reference["mlstm", T, dtype], dtype)
    _check_block(TXL.apply_slstm(pair["slstm"], x, cfg), reference["slstm", T, dtype], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_blocks_decode_step_matches_jax(reference, dtype):
    pair, cfg, bi = _pair(reference), _tcfg(2, dtype), _block_inputs()
    x = torch.from_numpy(bi["x_decode"]).to(getattr(torch, dtype))
    mstate = tuple(torch.from_numpy(bi[k]) for k in ("C", "n", "m"))
    _check_block(TXL.apply_mlstm(pair["mlstm"], x, cfg, state=mstate, decode=True),
                 reference["mlstm_decode", dtype], dtype)
    sstate = tuple(torch.from_numpy(bi[k]) for k in ("s_c", "s_n", "s_h", "s_m"))
    _check_block(TXL.apply_slstm(pair["slstm"], x, cfg, state=sstate, decode=True),
                 reference["slstm_decode", dtype], dtype)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_layers", LAYERS)
def test_forward_matches_jax(reference, n_layers, dtype):
    cfg = _tcfg(n_layers, dtype)
    params = params_from_numpy(reference["params", n_layers], device="cpu")
    logits, hidden = TM.forward(params, cfg, torch.from_numpy(_tokens()), return_hidden=True)
    assert tuple(hidden.shape) == TOKENS + (cfg.d_model,)
    ref = reference["forward", n_layers, dtype]
    _close(_np(logits), ref, dtype, drift=True)
    margin = 0.1 if dtype == "bfloat16" else 1e-4
    assert _clear_tokens_equal(_np(logits), ref, margin) >= 8


def _check_cache(got, ref, dtype):
    assert sorted(got) == sorted(ref)
    for name in ref:
        if name == "index":
            np.testing.assert_array_equal(got[name].numpy(), ref[name])
        else:
            assert got[name].dtype == torch.float32, name
            _close(_np(got[name]), ref[name], dtype, drift=True)


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
    params = TM.init_model_quantized(cfg, torch.Generator().manual_seed(2), quant_predicate,
                                     device="cpu")
    toks = torch.from_numpy(_tokens())
    row, cache = TSV.prefill_recurrent(params, cfg, toks,
                                       torch.tensor(LAST, dtype=torch.int32), SEQ)
    for b, last in enumerate(LAST):
        alone = TSV.init_cache(cfg, 1, SEQ, per_slot_index=True, device="cpu")
        for t in range(last + 1):
            logits, alone = TSV.decode(params, cfg, alone, toks[b:b + 1, t:t + 1])
        assert torch.equal(row[b], logits[0, -1].to(torch.float32))
        for name, leaf in cache.items():
            got = leaf[b] if name == "index" else leaf[:, b]
            want = alone[name][0] if name == "index" else alone[name][:, 0]
            assert torch.equal(got, want), name


# ------------------------------------------------------- build and params

@pytest.mark.parametrize("n_layers", LAYERS)
def test_streamed_build_is_the_whole_build_quantized(n_layers):
    cfg = _tcfg(n_layers)
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
    pairs = streamed["xlstm"]["pairs"]
    for name in ("wq", "wk", "wv", "wi", "wf", "wo_gate", "wo"):
        assert isinstance(pairs["mlstm"][name], tz.QTensor), name
    for name in ("wz", "wi", "wf", "wo"):
        assert isinstance(pairs["slstm"][name], tz.QTensor), name
    for name in ("wup", "wdown", "rz", "ri", "rf", "ro"):
        assert not isinstance(pairs["slstm"][name], tz.QTensor), name
    assert tuple(pairs["mlstm"]["wi"].q.shape) == (n_layers // 2, cfg.d_model, cfg.n_heads)
    assert TM.count_qtensors(streamed) == 7 + 4 + 1


def test_params_tree_is_the_references(reference):
    got = tinit(_tcfg(4), torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, types.SimpleNamespace):
            return tuple(tree.q.shape)
        return tuple(tree.shape)
    assert shapes(got) == shapes(reference["params", 4])
    b = got["xlstm"]["pairs"]
    assert bool((b["mlstm"]["b_f"] == 3).all()) and bool((b["slstm"]["bf"] == 1).all())


# ------------------------------------------------------- row invariance

def test_decode_contractions_keep_a_rows_bits():
    """Each contraction of the decode body gives a row the same bits at 1,
    3, 8 and 64 rows: the readout and normalizer trees over hd, the
    sLSTM's recurrent product and the block's float up/down products
    (both through matmul_fixed_rows)."""
    rng = np.random.default_rng(17)
    R, H, hd, D = max(ROWS), 4, 24, 96

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q, C, n = t(R, H, hd), t(R, H, hd, hd), t(R, H, hd)
    state = (t(R, D), t(R, D).abs() + 0.5, t(R, D), t(R, D))
    xg = tuple(t(R, D) for _ in range(4))
    Rw = t(H, D // H, 4 * D // H) * 0.2
    x, w = t(R, D).to(torch.bfloat16), (t(D, 2 * D) * D ** -0.5).to(torch.bfloat16)
    cfg = _tcfg(2, "bfloat16")
    probes = {
        "readout": lambda k: TSSM.readout(q[:k], C[:k]),
        "normalizer": lambda k: TSSM.readout(q[:k], n[:k, :, None, :])[..., 0],
        "recurrent": lambda k: TXL.slstm_step(tuple(s[:k] for s in state),
                                              tuple(g[:k] for g in xg), Rw)[0],
        "up_projection": lambda k: TXL.fdot(x[:k], w, cfg)}
    for name, fn in probes.items():
        one = fn(1)[0]
        for k in ROWS:
            assert torch.equal(fn(k)[0], one), (name, k)
    np.testing.assert_allclose(_np(probes["readout"](R)),
                               np.einsum("bhpn,bhn->bhp", _np(C), _np(q)), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(_np(TL.matmul_fixed_rows(x.float(), w.float(), 64)),
                               _np(x.float() @ w.float()), rtol=0, atol=1e-4)


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
