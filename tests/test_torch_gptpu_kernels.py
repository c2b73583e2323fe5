"""Port parity: the GPTPU path's kernel wrappers (repro_torch.kernels:
``qgemm_tile_scales`` with its tile-grid entry ``qgemm_tiles``, and
``stencil3x3``) against the JAX package's Pallas kernels (interpret mode) and
its ``ref.py`` oracles.

On the CPU a wrapper runs its plain PyTorch version; the CUDA kernels run
only on a card (tests marked ``cuda``, skipped here with a reason).

Tolerances
  * tile scales, plain version vs a numpy loop over k with two roundings per
    step (scale product, multiply, add): BITWISE — the contract's order.
  * tile scales vs ``ops.qgemm_tiles(interpret=True)``: max |diff| <= 1e-6 x
    max |out|. XLA's CPU interpret fuses ``acc + float(P) * s`` into one
    fused multiply-add, one rounding per step instead of two (the test
    shows the interpret output equals that FMA loop bit for bit), so the
    two differ in the last bits of each step.
  * tile scales vs ``ref.qgemm_tile_scales_ref`` (the products in another
    order, a ``sum`` over k): 1e-6 x max |out|.
  * stencil vs ``ref.stencil3x3_ref``: BITWISE (the same nine multiply-adds
    from zero in the same order, eager ops); vs the Pallas kernel in
    interpret mode (XLA fuses the nine terms): 1e-4, the JAX contract.
  * stencil on int8 codes as f32: BITWISE against the int64 sum.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import qgemm as tq
from repro_torch.kernels import stencil3x3 as ts

T = 128


def _tile_case(Mb, Kb, Nb, seed):
    rng = np.random.default_rng(seed)
    aq = rng.integers(-127, 128, (Mb * T, Kb * T)).astype(np.int8)
    bq = rng.integers(-127, 128, (Kb * T, Nb * T)).astype(np.int8)
    sa = rng.uniform(1e-3, 1e-2, (Mb, Kb)).astype(np.float32)
    sb = rng.uniform(1e-3, 1e-2, (Kb, Nb)).astype(np.float32)
    return aq, bq, sa, sb


def _k_loop(aq, bq, sa, sb, fma):
    """numpy loop over k tiles: acc + float(P_k) * (sa_k * sb_k), with two
    roundings per step, or one (a fused multiply-add, exact in float64:
    float(P) has at most 21 bits and s 24, so their product is exact)."""
    Kb = sa.shape[1]
    acc = np.zeros((aq.shape[0], bq.shape[1]), np.float32)
    for k in range(Kb):
        ks = slice(k * T, (k + 1) * T)
        p = (aq[:, ks].astype(np.int64) @ bq[ks].astype(np.int64)).astype(np.float32)
        s = np.kron(sa[:, k:k + 1] * sb[k:k + 1, :], np.ones((T, T), np.float32))
        if fma:
            acc = (p.astype(np.float64) * s + acc).astype(np.float32)
        else:
            acc = acc + p * s
    return acc


def _grid(x, rb, cb):
    return np.ascontiguousarray(x.reshape(rb, T, cb, T).swapaxes(1, 2))


@pytest.mark.parametrize("Mb,Kb,Nb", [(1, 2, 1), (2, 4, 2)])
def test_tile_scales_plain_matches_jax(Mb, Kb, Nb):
    aq, bq, sa, sb = _tile_case(Mb, Kb, Nb, seed=Mb * 10 + Kb)
    out = tq.qgemm_tile_scales(*map(torch.from_numpy, (aq, bq, sa, sb))).numpy()
    np.testing.assert_array_equal(out, _k_loop(aq, bq, sa, sb, fma=False))

    pallas = np.asarray(ops.qgemm_tiles(_grid(aq, Mb, Kb), sa, _grid(bq, Kb, Nb), sb,
                                        interpret=True))
    pallas = pallas.swapaxes(1, 2).reshape(out.shape)
    np.testing.assert_array_equal(pallas, _k_loop(aq, bq, sa, sb, fma=True))
    scale = np.abs(pallas).max()
    assert np.abs(out - pallas).max() <= 1e-6 * scale

    oracle = np.asarray(ref.qgemm_tile_scales_ref(aq, bq, sa, sb))
    assert np.abs(out - oracle).max() <= 1e-6 * np.abs(oracle).max()


def test_tile_grid_entry_matches_jax_layout():
    """``qgemm_tiles`` takes and returns tile grids, as ``ops.qgemm_tiles``,
    with scales shaped (Mb, Kb, 1, 1) as core.gemm passes them."""
    Mb, Kb, Nb = 2, 3, 1
    aq, bq, sa, sb = _tile_case(Mb, Kb, Nb, seed=5)
    ag, bg = _grid(aq, Mb, Kb), _grid(bq, Kb, Nb)
    out = tq.qgemm_tiles(torch.from_numpy(ag), torch.from_numpy(sa[:, :, None, None]),
                         torch.from_numpy(bg), torch.from_numpy(sb[:, :, None, None]))
    assert tuple(out.shape) == (Mb, Nb, T, T)
    flat = tq.qgemm_tile_scales(*map(torch.from_numpy, (aq, bq, sa, sb)))
    np.testing.assert_array_equal(out.numpy(),
                                  flat.numpy().reshape(Mb, T, Nb, T).swapaxes(1, 2))


@pytest.mark.parametrize("bad", ["a_dtype", "sa_dtype", "ragged", "k_mismatch",
                                 "sa_shape", "sb_shape", "noncontig", "rank"])
def test_tile_scales_rejects_bad_inputs(bad):
    a = torch.zeros(T, 2 * T, dtype=torch.int8)
    b = torch.zeros(2 * T, T, dtype=torch.int8)
    sa, sb = torch.ones(1, 2), torch.ones(2, 1)
    if bad == "a_dtype":
        a = a.float()
    elif bad == "sa_dtype":
        sa = sa.double()
    elif bad == "ragged":
        a = a[:100].contiguous()
    elif bad == "k_mismatch":
        b = torch.zeros(3 * T, T, dtype=torch.int8)
    elif bad == "sa_shape":
        sa = torch.ones(2, 1)
    elif bad == "sb_shape":
        sb = torch.ones(1, 2)
    elif bad == "noncontig":
        a = torch.zeros(2 * T, T, dtype=torch.int8).T
    elif bad == "rank":
        a = a[None]
    with pytest.raises((TypeError, ValueError)):
        tq.qgemm_tile_scales(a, b, sa, sb)


# --------------------------------------------------------------- stencil

@pytest.mark.parametrize("H,W,bm", [(64, 128, 64), (100, 300, 64), (257, 129, 128)])
def test_stencil_plain_matches_jax(H, W, bm):
    rng = np.random.default_rng(H + W)
    x = rng.normal(size=(H, W)).astype(np.float32)
    w = rng.normal(size=(3, 3)).astype(np.float32)
    out = ts.stencil3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(out, np.asarray(ref.stencil3x3_ref(x, w)))
    np.testing.assert_allclose(out, np.asarray(ops.stencil(x, w, bm=bm, interpret=True)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,W", [(1, 1), (2, 5), (33, 31)])
def test_stencil_on_codes_is_exact(H, W):
    """int8 codes as f32: products <= 127^2 and 9-term sums < 2^24 are exact."""
    rng = np.random.default_rng(H * W)
    xq = rng.integers(-127, 128, (H, W))
    wq = rng.integers(-127, 128, (3, 3))
    xq[0, 0] = wq[1, 1] = 127
    out = ts.stencil3x3(torch.from_numpy(xq.astype(np.float32)),
                        torch.from_numpy(wq.astype(np.float32))).numpy()
    xp = np.pad(xq, 1)
    expect = sum(wq[p, q] * xp[p:p + H, q:q + W] for p in range(3) for q in range(3))
    np.testing.assert_array_equal(out, expect.astype(np.float32))


@pytest.mark.parametrize("bad", ["x_dtype", "w_shape", "rank", "empty", "noncontig"])
def test_stencil_rejects_bad_inputs(bad):
    x, w = torch.zeros(8, 9), torch.zeros(3, 3)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "w_shape":
        w = torch.zeros(3, 4)
    elif bad == "rank":
        x = x[None]
    elif bad == "empty":
        x = torch.zeros(0, 9)
    elif bad == "noncontig":
        x = torch.zeros(9, 8).T
    with pytest.raises((TypeError, ValueError)):
        ts.stencil3x3(x, w)


# ------------------------------------------------- on the card (CUDA only)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tile_scales_kernel_matches_plain_on_card(cuda_device):
    """Both sub-tile sizes (64x64 where the 64x128 ones are too few to fill
    the card: 1024^3), operands holding int8's -128: bitwise."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for M, K, N in ((128, 256, 128), (384, 1024, 256), (1024, 1024, 1024), (2048, 512, 4096)):
        a = torch.randint(-128, 128, (M, K), generator=gen, device=cuda_device,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device=cuda_device,
                          dtype=torch.int8)
        a[0, :], b[:, 0] = -128, -128
        sa = torch.rand((M // T, K // T), generator=gen, device=cuda_device) * 1e-2
        sb = torch.rand((K // T, N // T), generator=gen, device=cuda_device) * 1e-2
        assert torch.equal(tq.qgemm_tile_scales(a, b, sa, sb),
                           tq.qgemm_tile_scales_plain(a, b, sa, sb))


@pytest.mark.cuda
def test_stencil_kernel_matches_plain_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for H, W in ((64, 128), (100, 300), (257, 129), (1, 1)):
        x = torch.randn((H, W), generator=gen, device=cuda_device)
        w = torch.randn((3, 3), generator=gen, device=cuda_device)
        assert torch.equal(ts.stencil3x3(x, w), ts.stencil3x3_plain(x, w))
