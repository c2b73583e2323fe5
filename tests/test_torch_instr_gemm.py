"""Port parity: the GPTPU library path (repro_torch.core: tensorizer, instr,
gemm, instr_select) against the JAX package's (repro.core), on the CPU.

Tolerances
  * int8 codes, scales, paper S factors, tiling, ``qdot``, ``qdot_paper``,
    ``qdot_naive_int8``, quantized ``gemm_conv2d``, ``conv2d_quant``, the
    pairwise quant ops, max/relu/crop/ext: BITWISE — the same f32 operations
    in the same order, and integer sums computed exactly.
  * ``gemm_fully_connected`` vs JAX's kernel path (Pallas interpret):
    1e-6 x max |out|, because XLA's interpret fuses each step's
    multiply-add (tests/test_torch_gptpu_kernels.py); vs JAX's einsum path,
    whose ``sum`` over k runs in another order: 1e-5 x max |out|, on one
    k tile and one n tile only, where that path is right (see
    ``test_jax_einsum_branch_misapplies_tile_scales``). The tile codes and
    scales the port hands the kernel are bitwise JAX's.
  * f32 reductions and library transcendentals in another order or
    implementation (mean, tanh, fp matmul, fp conv): rtol 1e-5 (tanh 1e-6).
  * conv2D-lowered fp GEMM vs ``a @ b``: 1e-4, JAX's own contract.

``test_every_instruction_matches_jax`` takes the JAX side from a fresh
subprocess (``XLA_FLAGS=--xla_allow_excess_precision=false``, as the other
parity tests run their references), not from the test worker: a worker's
JAX state is whatever the test modules it imported and ran before left
behind (``XLA_FLAGS`` set at import, a warm persistent compile cache). Once
in three full runs with six workers the tanh case was off by 8.8e-5 in the
worker where it ran first, and passed alone. ``test_tanh_fp_within_ulps_
of_float64`` holds each side to float64 on its own, so that a recurrence
names the side that moved.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm as jgemm
from repro.core import instr as JI
from repro.core import tensorizer as jtz
from repro_torch.core import gemm as tgemm
from repro_torch.core import instr as TI
from repro_torch.core import instr_select as tsel
from repro_torch.core import tensorizer as ttz


@pytest.fixture(autouse=True)
def _private_table(monkeypatch, tmp_path):
    """Any table the port measures goes to a temporary file, never src/."""
    monkeypatch.setenv(tsel.TABLE_ENV, str(tmp_path / "instr_table.json"))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(out, ref):
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


# ------------------------------------------------------------- tensorizer

@pytest.mark.parametrize("kind", list(ttz.OpKind), ids=lambda k: k.value)
def test_paper_scale_for_bitwise(kind):
    lo, hi = np.float32(-3.7), np.float32(5.1)
    n = 57 if kind == ttz.OpKind.MATMUL else None
    out = ttz.paper_scale_for(kind, torch.tensor(lo), torch.tensor(hi), n=n)
    ref = jtz.paper_scale_for(jtz.OpKind(kind.value), jnp.float32(lo), jnp.float32(hi), n=n)
    _eq(out.numpy(), ref)
    _eq(ttz.scale_from_paper_S(out).numpy(), jtz.scale_from_paper_S(ref))


def test_paper_scale_for_needs_n_for_matmul():
    with pytest.raises(ValueError):
        ttz.paper_scale_for(ttz.OpKind.MATMUL, 0.0, 1.0)


@pytest.mark.parametrize("kind", ["int_in_range", "int_out_of_range", "real"])
@pytest.mark.parametrize("axis", [None, (0,)])
def test_quantize_snap_integer_bitwise(kind, axis):
    rng = np.random.default_rng(3)
    if kind == "int_in_range":
        x = rng.integers(-127, 128, (9, 14)).astype(np.float32)
    elif kind == "int_out_of_range":
        x = rng.integers(-200, 201, (9, 14)).astype(np.float32)
    else:
        x = rng.normal(size=(9, 14)).astype(np.float32) * 3
    out = ttz.quantize(_t(x), axis=axis, snap_integer=True)
    ref = jtz.quantize(jnp.asarray(x), axis=axis, snap_integer=True)
    _eq(out.q.numpy(), ref.q)
    _eq(out.scale.numpy(), ref.scale)
    assert out.meta_shape == tuple(ref.meta_shape) == (9, 14)
    _eq(out.dequantize().numpy(), ref.dequantize())
    _eq(ttz.fake_quantize(_t(x), axis=axis, snap_integer=True).numpy(),
        jtz.fake_quantize(jnp.asarray(x), axis=axis, snap_integer=True))
    if kind == "int_in_range":
        _eq(out.dequantize().numpy(), x)


@pytest.mark.parametrize("shape,tile", [((10, 13), 8), ((128, 128), 128), ((130, 257), 128)])
def test_tiling_bitwise_and_round_trip(shape, tile):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    tiles = ttz.partition(_t(x), tile)
    _eq(tiles.numpy(), jtz.partition(jnp.asarray(x), tile))
    _eq(ttz.reassemble(tiles, *shape).numpy(), x)
    padded = ttz.ext(_t(x), 16, 32)
    _eq(padded.numpy(), jtz.ext(jnp.asarray(x), 16, 32))
    _eq(ttz.crop(padded, *shape).numpy(), x)
    assert ttz.round_up(shape[1], tile) == jtz.round_up(shape[1], tile)


@pytest.mark.parametrize("a_shape", [(40,), (6, 40), (2, 5, 40)], ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("per_channel", [True, False])
def test_qdot_bitwise(a_shape, per_channel):
    rng = np.random.default_rng(len(a_shape))
    a = rng.normal(size=a_shape).astype(np.float32)
    b = rng.uniform(-2, 2, (40, 24)).astype(np.float32)
    out = ttz.qdot(_t(a), _t(b), per_channel=per_channel)
    ref = jtz.qdot(jnp.asarray(a), jnp.asarray(b), per_channel=per_channel)
    assert tuple(out.shape) == ref.shape == a_shape[:-1] + (24,)
    _eq(out.numpy(), ref)


def test_qdot_rejects_overflowing_k():
    with pytest.raises(ValueError):
        ttz.qdot(torch.zeros(1, 140_000), torch.zeros(140_000, 1))


@pytest.mark.parametrize("requantize", [False, True])
def test_qdot_paper_and_naive_bitwise(requantize):
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 300, (16, 48)).astype(np.float32)
    b = rng.uniform(0, 300, (48, 8)).astype(np.float32)
    _eq(ttz.qdot_paper(_t(a), _t(b), requantize_output=requantize).numpy(),
        jtz.qdot_paper(jnp.asarray(a), jnp.asarray(b), requantize_output=requantize))
    _eq(ttz.qdot_naive_int8(_t(a), _t(b)).numpy(),
        jtz.qdot_naive_int8(jnp.asarray(a), jnp.asarray(b)))


# ------------------------------------------------------------- instructions

_RNG = np.random.default_rng(7)
_A = _RNG.uniform(-4, 8, (70, 90)).astype(np.float32)
_B = _RNG.uniform(-2, 6, (70, 90)).astype(np.float32)
_V = _RNG.normal(size=(8, 40)).astype(np.float32)
_W = _RNG.normal(size=(40, 24)).astype(np.float32)
_K3 = _RNG.normal(size=(3, 3)).astype(np.float32)
_AI = _RNG.integers(-9, 10, (20, 30)).astype(np.float32)
_BI = _RNG.integers(-9, 10, (20, 30)).astype(np.float32)

# instruction -> (args, fp tolerance, quant tolerance); 0 means bitwise
CASES = {
    JI.Instr.CONV2D: ((_A, _K3), 1e-5, 0),
    JI.Instr.FULLY_CONNECTED: ((_V, _W), 1e-5, 0),
    JI.Instr.ADD: ((_A, _B), 0, 0),
    JI.Instr.SUB: ((_A, _B), 0, 0),
    JI.Instr.MUL: ((_AI, _BI), 0, 0),
    JI.Instr.CROP: ((_A, 33, 41), 0, 0),
    JI.Instr.EXT: ((_A,), 0, 0),
    JI.Instr.MEAN: ((_A,), 1e-5, 1e-5),
    JI.Instr.MAX: ((_A,), 0, 0),
    JI.Instr.TANH: ((_A,), 1e-6, 1e-6),
    JI.Instr.RELU: ((_A - 2,), 0, 0),
}


def _jax_instructions():
    """Every CASES instruction, fp and quantized, through the JAX package."""
    out = {}
    for instr, (args, _, _) in CASES.items():
        j_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        for quantized in (False, True):
            out[instr.value, quantized] = np.asarray(
                JI.invoke(instr, *j_args, quantized=quantized))
    return out


@pytest.fixture(scope="module")
def jax_instructions(tmp_path_factory):
    """The JAX side of the instruction cases, run in a subprocess (module
    doc)."""
    out = tmp_path_factory.mktemp("instr") / "instr_ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True,
                   timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "quant"])
@pytest.mark.parametrize("instr", list(JI.Instr), ids=lambda i: i.value)
def test_every_instruction_matches_jax(instr, quantized, jax_instructions):
    args, tol_fp, tol_q = CASES[instr]
    tol = tol_q if quantized else tol_fp
    t_args = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    out = TI.invoke(TI.Instr(instr.value), *t_args, quantized=quantized).numpy()
    ref = jax_instructions[instr.value, quantized]
    assert out.shape == ref.shape
    if tol == 0:
        _eq(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("side", ["port", "jax"])
def test_tanh_fp_within_ulps_of_float64(side, jax_instructions):
    """Each side's f32 tanh of the TANH case against float64 numpy: the port
    (torch) within 1 ulp of 1.0, the JAX subprocess within 4."""
    x = CASES[JI.Instr.TANH][0][0]
    got = (TI.tanh_fp(_t(x)).numpy() if side == "port"
           else jax_instructions[JI.Instr.TANH.value, False])
    ulps = {"port": 1, "jax": 4}[side]
    err = np.abs(got.astype(np.float64) - np.tanh(x.astype(np.float64))).max()
    assert err <= ulps * np.finfo(np.float32).eps, err


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_pairwise_quant_real_valued_path_bitwise(op):
    """Non-integer inputs take the requantized path: S = 1/bound, then
    ``out * S * QMAX`` left to right, then ``q / (S * QMAX)``."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 8, (32, 32)).astype(np.float32)
    b = rng.uniform(0, 8, (32, 32)).astype(np.float32)
    out = getattr(TI, f"{op}_quant")(_t(a), _t(b)).numpy()
    _eq(out, getattr(JI, f"{op}_quant")(jnp.asarray(a), jnp.asarray(b)))
    assert not np.array_equal(out, getattr(np, {"add": "add", "sub": "subtract",
                                                 "mul": "multiply"}[op])(a, b))


@pytest.mark.parametrize("ksize,stride,padding", [
    ((5, 5), (1, 1), "SAME"), ((4, 4), (2, 1), "SAME"), ((2, 2), (2, 2), "VALID"),
    ((3, 3), (2, 2), "SAME"), ((3, 3), (1, 1), "VALID"),
])
def test_conv2d_other_shapes_match_jax(ksize, stride, padding):
    """Shapes off the stencil go through F.conv2d (TF32 off on a card)."""
    rng = np.random.default_rng(sum(ksize) + stride[0])
    x = rng.uniform(-2, 2, (37, 29)).astype(np.float32)
    k = rng.normal(size=ksize).astype(np.float32)
    fp = TI.conv2d_fp(_t(x), _t(k), stride, padding).numpy()
    fp_ref = np.asarray(JI.conv2d_fp(jnp.asarray(x), jnp.asarray(k), stride, padding))
    assert fp.shape == fp_ref.shape
    np.testing.assert_allclose(fp, fp_ref, rtol=1e-5, atol=1e-5)
    _eq(TI.conv2d_quant(_t(x), _t(k), stride, padding).numpy(),
        JI.conv2d_quant(jnp.asarray(x), jnp.asarray(k), stride, padding))


def test_conv2d_quant_refuses_sums_past_f32():
    with pytest.raises(ValueError):
        TI.conv2d_quant(torch.ones(40, 40), torch.ones(33, 33))


# ------------------------------------------------------------------ tpuGemm

GEMM_SHAPES = [(64, 64, 64), (100, 70, 90), (129, 257, 65)]


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_conv2d_lowering_fp_is_gemm(M, K, N):
    rng = np.random.default_rng(M)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    out = tgemm.gemm_conv2d(_t(a), _t(b), quantized=False).numpy()
    np.testing.assert_allclose(out, a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        out, np.asarray(jgemm.gemm_conv2d(jnp.asarray(a), jnp.asarray(b), quantized=False)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_conv2d_lowering_quant_bitwise(M, K, N):
    rng = np.random.default_rng(K)
    a = rng.uniform(0, 4, (M, K)).astype(np.float32)
    b = rng.uniform(-4, 4, (K, N)).astype(np.float32)
    out = tgemm.tpu_gemm(_t(a), _t(b), lowering="conv2d").numpy()
    _eq(out, jgemm.gemm_conv2d(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_fully_connected_lowering_matches_jax(M, K, N, monkeypatch):
    rng = np.random.default_rng(N)
    a = rng.uniform(-2, 2, (M, K)).astype(np.float32)
    b = rng.uniform(-2, 2, (K, N)).astype(np.float32)
    seen = []
    real = tgemm.qgemm_tiles
    monkeypatch.setattr(tgemm, "qgemm_tiles", lambda *xs: seen.append(xs) or real(*xs))
    out = tgemm.tpu_gemm(_t(a), _t(b), lowering="fully_connected").numpy()
    # the tile codes and scales handed to the kernel are JAX's, bit for bit
    qa, sa, qb, sb = (x.numpy() for x in seen[0])
    for x, q, s in ((a, qa, sa), (b, qb, sb)):
        tiles = jtz.partition(jnp.asarray(x), 128)
        s_ref = jtz.amax_calibrate(tiles, axis=(-1, -2))
        _eq(s, s_ref)
        _eq(q, jnp.clip(jnp.round(tiles / s_ref), -127, 127).astype(jnp.int8))
    kernel = np.asarray(jgemm.gemm_fully_connected(jnp.asarray(a), jnp.asarray(b),
                                                   use_kernel=True))
    scale = np.abs(kernel).max()
    assert np.abs(out - kernel).max() <= 1e-6 * scale
    if K <= 128 and N <= 128:   # one k tile and one n tile: see the test below
        einsum = np.asarray(jgemm.gemm_fully_connected(jnp.asarray(a), jnp.asarray(b)))
        assert np.abs(out - einsum).max() <= 1e-5 * scale
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(out - exact).max() / np.abs(exact).max() < 0.02


def test_jax_einsum_branch_misapplies_tile_scales():
    """The JAX package's default ``gemm_fully_connected`` (the einsum branch,
    gemm.py:60-66) broadcasts ``swapaxes(sb, 0, 1)`` against the (i, k, j)
    partials, so it scales tile (k, j) by ``sb[j, k]``, and with Kb != Nb it
    broadcasts over the wrong axis. Its kernel branch, which the port
    follows, is right. With one B tile column 8x larger than the other the
    einsum branch is off by the whole product."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 4, (128, 128)).astype(np.float32)
    b = rng.uniform(0, 4, (128, 256)).astype(np.float32)
    b[:, 128:] *= 8
    exact = a.astype(np.float64) @ b.astype(np.float64)
    rel = lambda o: np.abs(np.asarray(o) - exact).max() / np.abs(exact).max()
    out = tgemm.gemm_fully_connected(_t(a), _t(b)).numpy()
    assert rel(out) < 0.01
    assert rel(jgemm.gemm_fully_connected(jnp.asarray(a), jnp.asarray(b),
                                          use_kernel=True)) < 0.01
    assert rel(jgemm.gemm_fully_connected(jnp.asarray(a), jnp.asarray(b))) > 0.5


@pytest.mark.parametrize("lowering", ["fully_connected", "conv2d"])
def test_tpu_gemm_auto_lowering_takes_the_table_choice(lowering, monkeypatch):
    seen = []
    monkeypatch.setattr(tsel, "best_gemm_lowering",
                        lambda device=None: seen.append(device) or lowering)
    a = np.random.default_rng(1).uniform(0, 4, (64, 64)).astype(np.float32)
    out = tgemm.tpu_gemm(_t(a), _t(a)).numpy()
    assert seen == [torch.device("cpu")]
    _eq(out, tgemm.tpu_gemm(_t(a), _t(a), lowering=lowering).numpy())
    _eq(tgemm.tpu_gemm(_t(a), _t(a), lowering="fp32").numpy(), _t(a).numpy() @ a)


# ---------------------------------------------------- instruction selection

def test_instr_table_is_the_ports_own():
    from repro.core import instr_select as jsel
    assert tsel.TABLE_ENV != jsel._CACHE_ENV
    assert tsel.DEFAULT_TABLE.parent.name == "core"
    assert tsel.DEFAULT_TABLE.parent.parent.name == "repro_torch"


def test_get_table_is_keyed_by_device_and_cached_in_its_file(monkeypatch):
    builds = []

    def fake_build(device):
        builds.append(device)
        return {"gemm_fully_connected": {"results_per_s": 1.0},
                "gemm_conv2d": {"results_per_s": 2.0 + len(builds)}}

    path = tsel.table_path()
    path.write_text('{"NVIDIA H100 80GB HBM3": {"gemm_fully_connected": '
                    '{"results_per_s": 9.0}, "gemm_conv2d": {"results_per_s": 1.0}}}')
    monkeypatch.setattr(tsel, "build_table", fake_build)
    assert tsel.best_gemm_lowering("cpu") == "conv2d"       # measured now
    assert tsel.get_table("cpu")["gemm_conv2d"]["results_per_s"] == 3.0
    assert len(builds) == 1                                 # read back, not rebuilt
    assert tsel.get_table("cpu", refresh=True)["gemm_conv2d"]["results_per_s"] == 4.0
    import json
    tables = json.loads(path.read_text())
    assert set(tables) == {"cpu", "NVIDIA H100 80GB HBM3"}  # the card's table kept


def test_build_table_measures_every_instruction():
    table = tsel.build_table("cpu", size=32, iters=2)
    assert set(table) == {i.value for i in TI.Instr} | {"gemm_fully_connected",
                                                        "gemm_conv2d"}
    assert all(v["ops_per_s"] > 0 and v["results_per_s"] > 0 for v in table.values())


# ------------------------------------------------- on the card (CUDA only)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_quantize_on_card_matches_cpu_bitwise(cuda_device):
    """Scales divide by a device tensor, so the card's codes and scales are
    the CPU's (and the JAX package's), not a reciprocal-multiply's."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 300)).astype(np.float32)) * 37
    for axis in (None, (1,), (0,)):
        c, g = ttz.quantize(x, axis=axis), ttz.quantize(x.to(cuda_device), axis=axis)
        assert torch.equal(g.scale.cpu(), c.scale) and torch.equal(g.q.cpu(), c.q)
    a = _t(np.random.default_rng(1).uniform(-2, 2, (300, 260)).astype(np.float32))
    on_card = tgemm.gemm_fully_connected(a.to(cuda_device), a.T.to(cuda_device))
    assert torch.equal(on_card.cpu(), tgemm.gemm_fully_connected(a, a.T))


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_jax_instructions(), f)
