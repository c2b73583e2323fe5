"""Function-level parity of the port's serving attention pieces
(repro_torch.models.attention / serve) against the JAX package's, on the
same numpy inputs and the same converted W8A8 weights, at smoke widths in
the f32 compute dtype. The JAX side runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (tests/test_torch_model.py).

Tolerances:
  * int8 KV codes and scales (``_quantize_kv``) and gathered blocks
    (``gather_block_kv``): BITWISE — the same f32 ops in the same order;
  * the cache entries a decode or chunk step writes from its projections:
    BITWISE in bf16, the served dtype; in f32 within 1e-6 x their absolute
    max, since XLA may contract RoPE's multiply-adds into FMAs (one f32 ulp
    measured), which bf16's rounding absorbs;
  * attention outputs, logits and entries downstream of an attention
    output: within 1e-5 x the reference's absolute max in f32 (the score
    and value contractions sum in another order; measured below 1e-6), 1e-2
    in bf16 (one bf16 rounding step).
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as TA
from repro_torch.models import serve as TSV
from repro_torch.testing.params import params_from_numpy

RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
ENTRY_TOL = {"float32": 1e-6, "bfloat16": 0}


def _inputs():
    rng = np.random.default_rng(21)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    B, W, S, KV, hd, D = 2, 8, 24, 2, 16, 64
    return {
        "k_new": f(3, 5, KV, hd) * 3, "v_new": f(3, 5, KV, hd),
        "pool": {"k": f(2, 6, 4, KV, hd), "v": f(2, 6, 4, KV, hd),
                 "k_scale": np.abs(f(2, 6, 4, KV))},
        "tables": rng.integers(0, 6, (3, 3)).astype(np.int32),
        "x": f(B, W, D), "k_acc": f(B, S, KV, hd), "v_acc": f(B, S, KV, hd),
        "kq_acc": rng.integers(-127, 128, (B, S, KV, hd)).astype(np.int8),
        "vq_acc": rng.integers(-127, 128, (B, S, KV, hd)).astype(np.int8),
        "ks_acc": np.abs(f(B, S, KV)) / 100, "vs_acc": np.abs(f(B, S, KV)) / 100,
        "xd": f(3, 1, D), "ck": f(3, 16, KV, hd), "cv": f(3, 16, KV, hd),
        "index": np.array([3, 15, 16], np.int32),
        "tokens": rng.integers(0, 256, (2, 24)).astype(np.int32),
        "last": np.array([20, 23], np.int32),
    }


def _reference():
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.core import tensorizer as jtz
    from repro.distributed import sharding as shd
    from repro.launch.serve import _quant_predicate
    from repro.models import attention as A, init_model, serve as SV

    def npy(tree):
        if isinstance(tree, dict):
            return {k: npy(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return [npy(v) for v in tree]
        if isinstance(tree, jtz.QTensor):
            return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
        return np.asarray(tree)

    i = _inputs()
    cfg = get_config("tinyllama-1.1b").smoke().replace(quantize="serve", dtype="float32")
    out = {}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jtz.quantize_params(init_model(cfg, jax.random.PRNGKey(0)),
                                     predicate=_quant_predicate)
        out["params"] = npy(params)
        p = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
        out["quantize"] = npy(A._quantize_kv(jnp.asarray(i["k_new"]), jnp.asarray(i["v_new"])))
        out["quantize_bf16"] = npy(A._quantize_kv(jnp.asarray(i["k_new"], jnp.bfloat16),
                                                  jnp.asarray(i["v_new"], jnp.bfloat16)))
        out["gather"] = npy(A.gather_block_kv({k: jnp.asarray(v) for k, v in i["pool"].items()},
                                              jnp.asarray(i["tables"])))
        positions = 8 + jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (2, 8))
        index = jnp.asarray(i["index"])
        for dt in ("float32", "bfloat16"):
            c, x, xd = (cfg.replace(dtype=dt), jnp.asarray(i["x"], dt),
                        jnp.asarray(i["xd"], dt))
            out["chunk_float", dt] = npy(A.chunked_prefill_attention_with_kv(
                p, x, c, positions=positions, chunk_start=8,
                k_acc=jnp.asarray(i["k_acc"], dt), v_acc=jnp.asarray(i["v_acc"], dt)))
            out["chunk_int8", dt] = npy(A.chunked_prefill_attention_with_kv(
                p, x, c, positions=positions, chunk_start=8,
                k_acc=jnp.asarray(i["kq_acc"]), v_acc=jnp.asarray(i["vq_acc"]),
                k_sc_acc=jnp.asarray(i["ks_acc"]), v_sc_acc=jnp.asarray(i["vs_acc"]),
                int8_kv=True))
            out["decode_float", dt] = npy(A.decode_attention(
                p, xd, jnp.asarray(i["ck"], dt), jnp.asarray(i["cv"], dt), index, c,
                positions=index[:, None]))
            out["decode_int8", dt] = npy(A.decode_attention(
                p, xd, jnp.asarray(i["kq_acc"][:, :16].repeat(2, 0)[:3]),
                jnp.asarray(i["vq_acc"][:, :16].repeat(2, 0)[:3]), index, c,
                positions=index[:, None],
                cache_scales=(jnp.asarray(i["ks_acc"][:, :16].repeat(2, 0)[:3]),
                              jnp.asarray(i["vs_acc"][:, :16].repeat(2, 0)[:3]))))
        toks, last = jnp.asarray(i["tokens"]), jnp.asarray(i["last"])
        for kv in ("bfloat16", "int8"):
            c = cfg.replace(kv_cache_dtype=kv)
            row, kv_cold = SV.prefill_with_cache_chunked(params, c, toks, last, 8)
            srow, skv = SV.prefill_with_cache_suffix(params, c, toks, last, 8, kv_cold,
                                                     jnp.int32(1))
            out["chunked", kv] = npy((row, kv_cold))
            out["suffix", kv] = npy((srow, skv))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "attention.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(path)], env=env, check=True, timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def cfg():
    return tget_config("tinyllama-1.1b").smoke().replace(quantize="serve", dtype="float32")


@pytest.fixture(scope="module")
def params(ref):
    return params_from_numpy(ref["params"], device="cpu")


@pytest.fixture(scope="module")
def attn(params):
    return {k: (type(v)(v.q[0], v.scale[0]) if hasattr(v, "q") else v[0])
            for k, v in params["layers"]["attn"].items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, tol=RTOL["float32"]):
    want = np.asarray(want, np.float32) if want.dtype != np.int8 else want
    if tol == 0:
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise(ref, dtype):
    i = _inputs()
    key = "quantize" if dtype == "float32" else "quantize_bf16"
    tdt = getattr(torch, dtype)
    got = TA._quantize_kv(_t(i["k_new"]).to(tdt), _t(i["v_new"]).to(tdt))
    for g, w in zip(got, ref[key]):
        assert g.dtype == (torch.int8 if w.dtype == np.int8 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), w)


def test_gather_block_kv_bitwise(ref):
    i = _inputs()
    got = TA.gather_block_kv({k: _t(v) for k, v in i["pool"].items()}, _t(i["tables"]))
    for name, w in ref["gather"].items():
        np.testing.assert_array_equal(got[name].numpy(), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_chunked_prefill_attention_matches_jax(ref, cfg, attn, int8, dtype):
    i = _inputs()
    tdt = getattr(torch, dtype)
    names = ("kq_acc", "vq_acc", "ks_acc", "vs_acc") if int8 else ("k_acc", "v_acc")
    accs = [_t(i[n]) if int8 else _t(i[n]).to(tdt) for n in names]
    positions = (8 + torch.arange(8, dtype=torch.int32)).expand(2, 8)
    out = TA.chunked_prefill_attention_with_kv(
        attn, _t(i["x"]).to(tdt), cfg.replace(dtype=dtype), positions=positions,
        chunk_start=8, k_acc=accs[0], v_acc=accs[1], k_sc_acc=accs[2] if int8 else None,
        v_sc_acc=accs[3] if int8 else None, int8_kv=int8)
    want = ref["chunk_int8" if int8 else "chunk_float", dtype]
    _close(out, want[0], RTOL[dtype])
    for got, w in zip(accs, want[1:]):              # written in place
        _close(got, w, 0 if w.dtype == np.int8 else ENTRY_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_attention_per_row_index_matches_jax(ref, cfg, attn, int8, dtype):
    """Per-row write positions and horizons; row 2's index (16) ran past the
    rows and writes nothing."""
    i = _inputs()
    tdt = getattr(torch, dtype)
    if int8:
        caches = [_t(i[n][:, :16].repeat(2, 0)[:3]) for n in ("kq_acc", "vq_acc", "ks_acc",
                                                               "vs_acc")]
    else:
        caches = [_t(i["ck"]).to(tdt), _t(i["cv"]).to(tdt)]
    before = [c.clone() for c in caches]
    out = TA.decode_attention(attn, _t(i["xd"]).to(tdt), caches[0], caches[1],
                              _t(i["index"]), cfg.replace(dtype=dtype),
                              cache_scales=(caches[2], caches[3]) if int8 else None)
    want = ref["decode_int8" if int8 else "decode_float", dtype]
    _close(out, want[0], RTOL[dtype])
    for got, w, b in zip(caches, want[1:], before):
        _close(got, w, 0 if w.dtype == np.int8 else ENTRY_TOL[dtype])
        assert torch.equal(got[2], b[2])


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_prefill_with_cache_suffix_matches_jax(ref, cfg, params, kv):
    """The suffix scan from chunk 1 over the JAX cold scan's rows against
    the JAX suffix scan; and, inside the port, suffix == cold bitwise."""
    i = _inputs()
    c = cfg.replace(kv_cache_dtype=kv)
    toks, last = _t(i["tokens"]), _t(i["last"])
    jrow, jkv = ref["chunked", kv]
    srow, skv = ref["suffix", kv]
    kv0 = {n: _t(a) for n, a in jkv.items()}
    row, got = TSV.prefill_with_cache_suffix(params, c, toks, last, 8, kv0, 1)
    _close(row, srow)
    for name, w in skv.items():
        if w.dtype == np.int8:                        # codes of f32-close inputs
            assert np.abs(got[name].numpy().astype(int) - w.astype(int)).max() <= 1
            assert (got[name].numpy() != w).mean() < 0.01
        else:
            _close(got[name], w)
    assert torch.equal(kv0["k"], _t(jkv["k"]))          # kv0 is never written
    crow, ckv = TSV.prefill_with_cache_chunked(params, c, toks, last, 8)
    _close(crow, jrow)
    srow2, skv2 = TSV.prefill_with_cache_suffix(params, c, toks, last, 8, ckv, 1)
    assert torch.equal(srow2, crow)
    for name in ckv:
        assert torch.equal(skv2[name], ckv[name]), name


def test_chunked_prefill_equals_fused_prefill(params, cfg):
    """Inside the port: the chunked scan's first-token row and K/V equal the
    single-shot fused prefill's, bitwise (f32 and bf16, float and int8 KV)."""
    toks = _t(_inputs()["tokens"])
    last = torch.tensor([20, 23])
    for dt in ("float32", "bfloat16"):
        for kv in ("bfloat16", "int8"):
            c = cfg.replace(dtype=dt, kv_cache_dtype=kv)
            logits, fkv = TSV.prefill_with_cache(params, c, toks)
            row, ckv = TSV.prefill_with_cache_chunked(params, c, toks, last, 8)
            assert torch.equal(row, logits[torch.arange(2), last].float())
            for name in fkv:
                assert torch.equal(ckv[name], fkv[name]), (dt, kv, name)


# the engine's prefill rows: a 32-position decode row, plain (contiguous,
# bridge, native plain, every int8 route) or laid out as the kernel route's
# 8-position blocks (the paged-attention kernel's plain version on the CPU)
ENGINE_ROWS = {"plain": TA.DecodeRows(32), "kernel": TA.DecodeRows(32, 8)}


@pytest.mark.parametrize("rows,kv", [("plain", "bfloat16"), ("plain", "int8"),
                                     ("kernel", "bfloat16")])
def test_engine_rows_match_jax(ref, cfg, params, rows, kv):
    """The engine's prefill formulation, each query a one-query decode row
    of a 32-position row, against the JAX chunked scan (the causal prefill
    with the reference's math); inside the port, the chunked scan with
    those rows equals the fused prefill's bitwise and both equal the default
    rows' first-token row and entries within the f32 tolerance."""
    i = _inputs()
    c = cfg.replace(kv_cache_dtype=kv)
    toks, last = _t(i["tokens"]), _t(i["last"])
    dr = ENGINE_ROWS[rows]
    jrow, jkv = ref["chunked", kv]
    row, got = TSV.prefill_with_cache_chunked(params, c, toks, last, 8, dr)
    _close(row, jrow)
    for name, w in jkv.items():
        if w.dtype == np.int8:                        # codes of f32-close inputs
            assert np.abs(got[name].numpy().astype(int) - w.astype(int)).max() <= 1
            assert (got[name].numpy() != w).mean() < 0.01
        else:
            _close(got[name], w)
    logits, fkv = TSV.prefill_with_cache(params, c, toks, dr)
    assert torch.equal(row, logits[torch.arange(2), last].float())
    for name in fkv:
        assert torch.equal(got[name], fkv[name]), name
    drow, _ = TSV.prefill_with_cache_chunked(params, c, toks, last, 8)
    _close(row, drow.numpy())


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_plain_prefill_rows_are_decode_calls(cfg, batch):
    """The plain prefill formulation runs its rows ATTEND_ROWS at a time
    (80 rows here: a full call and a padded one), as a decode step's call
    runs its ``batch`` rows: each query's output equals bitwise the
    one-query contraction of a decode call of ``batch`` rows whose first
    row is that query against its row's K/V (zero-padded to the decode
    row) with its position as the horizon, whatever the other rows hold."""
    rng = np.random.default_rng(4)
    B, Sq, L = 2, 40, 48
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q, k, v = (_t(rng.normal(size=(B, Sq, n, hd)).astype(np.float32))
               for n in (H, KV, KV))
    pos = torch.stack([torch.arange(Sq), 5 + torch.arange(Sq)]).to(torch.int32)
    got = TA._decode_rows(q, k, v, pos, TA.DecodeRows(L), cfg, torch.float32)
    kpad, vpad = (torch.cat([t, t.new_zeros((B, L - Sq, KV, hd))], dim=1) for t in (k, v))
    others = [_t(rng.normal(size=(batch - 1,) + shape).astype(np.float32))
              for shape in ((1, H, hd), (L, KV, hd), (L, KV, hd))]
    kpos = torch.arange(L)
    for b in range(B):
        for j in range(Sq):
            dq = torch.cat([q[b, j][None, None], others[0]])
            dk = torch.cat([kpad[b][None], others[1]])
            dv = torch.cat([vpad[b][None], others[2]])
            horizon = torch.tensor([int(pos[b, j])] + [L - 1] * (batch - 1))
            want = TA._attend(dq, *TA._layout(dk, dv),
                              (kpos[None, :] <= horizon[:, None])[:, None, None],
                              cfg, torch.float32)
            assert torch.equal(got[b, j], want[0, 0]), (b, j)

if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
