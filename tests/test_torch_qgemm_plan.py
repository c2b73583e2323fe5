"""The int8 GEMMs' launch plans and the kernel build's cache key, on the CPU.

``repro_torch.kernels.qgemm.plan`` picks the CUDA kernel's regime, tile and
split of K from the shape alone, so it is tested here without a card. The
kernel's result does not depend on it (int32 sums are exact in any order);
the cuda-marked tests in ``test_torch_kernels.py`` and
``test_torch_gptpu_kernels.py`` hold every regime and split path bitwise
against the plain version on the card.

Tolerance: qgemm's plain version against the JAX oracle with int8's -128 in
both operands: rtol = atol = 1e-6, the JAX kernel contract
(tests/test_kernels.py); its int32 accumulation exactly.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import _build
from repro_torch.kernels import qgemm as tq

SMS = 132                      # the H100's SMs
TARGET = tq.BLOCKS_PER_SM * SMS
PAIRS = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
SHAPES = ([(M, K, N) for M in (1, 8, 16, 17, 128, 4096) for K, N in PAIRS]
          + [(37, 130, 257), (7, 5632, 33), (13, 130, 257), (1, 1024, 1024),
             (4096, 4096, 4096), (1, 32, 8), (300, 16, 48), (20, 33, 64)])


@pytest.mark.parametrize("M", [1, 8, 16, 17, 128, 4096])
def test_plan_regime_follows_m(M):
    p = tq.plan(M, 2048, 2048, SMS)
    if M <= tq.DECODE_M:
        assert (p.config, p.bm, p.bn) in tq.DECODE_TILES and p.bm == 16
    else:
        assert (p.config, p.bm, p.bn) in tq.LARGE_TILES and p.bm > 16


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_splits_cover_k_in_whole_steps(M, K, N):
    p = tq.plan(M, K, N, SMS)
    assert p.kchunk % tq.KSTEP == 0 and p.kchunk > 0
    assert (p.splits - 1) * p.kchunk < K <= p.splits * p.kchunk
    assert p.blocks(M, N) == -(-M // p.bm) * -(-N // p.bn) * p.splits


@pytest.mark.parametrize("M", [1, 8, 128])
@pytest.mark.parametrize("K,N", PAIRS)
def test_plan_fills_the_card_at_projection_shapes(M, K, N):
    """The serving projections at decode (M = 8 slots, and 1) and at one
    128-token admission: at least two blocks per SM."""
    assert tq.plan(M, K, N, SMS).blocks(M, N) >= TARGET


@pytest.mark.parametrize("M,N", [(1, 256), (8, 2048), (128, 32000), (4096, 4096)])
def test_plan_one_split_for_a_single_k_step(M, N):
    for K in (1, 16, tq.KSTEP):
        p = tq.plan(M, K, N, SMS)
        assert p.splits == 1 and p.kchunk == tq.KSTEP


def test_plan_leaves_k_whole_where_tiles_fill_the_card():
    assert tq.plan(4096, 4096, 4096, SMS) == tq.Plan(3, 128, 128, 4096, 1)
    assert tq.plan(128, 2048, 32000, SMS).splits == 1


@pytest.mark.parametrize("n,narrow", [(4096, False), (2048, False), (1024, True), (128, True)])
def test_tile_scales_sub_tile_follows_size(n, narrow):
    """64x128 sub-tiles where they make two blocks per SM (4096^2: 2048,
    2048^2: 512); 64x64 below that (1024^2: 256 blocks, not 128)."""
    assert tq.tile_scales_narrow(n, n, SMS) == narrow


@pytest.mark.parametrize("M,K,N", [(8, 2048, 256), (128, 512, 128), (37, 130, 257)])
def test_qgemm_plain_with_int8_min_matches_jax(M, K, N):
    rng = np.random.default_rng(M + K + N)
    aq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    bq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    aq[0, :], bq[:, 0] = -128, -128                         # |acc| = K * 2^14
    sb = rng.uniform(1e-3, 1e-2, (N,)).astype(np.float32)
    a, b = torch.from_numpy(aq), torch.from_numpy(bq)
    acc = tq.qgemm(a, b, torch.ones(N)).numpy()
    exact = aq.astype(np.int64) @ bq.astype(np.int64)
    np.testing.assert_array_equal(acc, exact.astype(np.float32))
    assert acc[0, 0] == K * 128 * 128
    np.testing.assert_allclose(tq.qgemm(a, b, torch.from_numpy(sb)).numpy(),
                               np.asarray(ref.qgemm_ref(aq, bq, sb)), rtol=1e-6, atol=1e-6)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_bytes(b'#include "shared.cuh"\n')
    (tmp_path / "other.cu").write_bytes(b"// another kernel\n")
    (tmp_path / "shared.cuh").write_bytes(b"// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_build_key_covers_shared_headers(csrc, edit):
    """A library is named by its source, every csrc/*.cuh and the flags, so
    editing a header it may include builds it anew; another kernel's source
    does not."""
    before = _build._lib_path("k")
    (csrc / "other.cu").write_bytes(b"// edited\n")
    assert _build._lib_path("k") == before
    if edit == "header":
        (csrc / "shared.cuh").write_bytes(b"// v2\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_bytes(b"// new\n")
    else:
        (csrc / "k.cu").write_bytes(b'#include "shared.cuh"\n// edited\n')
    after = _build._lib_path("k")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libk-") and after.suffix == ".so"
