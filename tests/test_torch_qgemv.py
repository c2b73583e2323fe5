"""Port parity: the int8-weight GEMV ``repro_torch.kernels.qdot_serve.qgemv``
against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and its ``ref.qgemv_ref`` oracle.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel runs
only on a card (the test marked ``cuda``, skipped here with a reason).

Tolerance: rtol 2e-4, atol 1e-4, the JAX kernel contract
(tests/test_kernels.py). The plain version and the JAX kernel compute the
same f32 sums in the order of their own matmuls.
"""

import importlib.util
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import qdot_serve as tqs
from repro_torch.kernels import ref as tref

SHAPES = [(1, 256, 256), (8, 384, 512), (3, 640, 768), (8, 2048, 256)]


def _case(B, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, K)).astype(np.float32)
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    wq[0, :2] = (-128, 127)                      # both ends of the int8 range
    s = rng.uniform(1e-3, 1e-2, (N,)).astype(np.float32)
    return x, wq, s


@pytest.mark.parametrize("B,K,N", SHAPES)
def test_qgemv_plain_matches_jax(B, K, N):
    x, wq, s = _case(B, K, N, seed=B * K + N)
    out = tqs.qgemv(*map(torch.from_numpy, (x, wq, s)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, N)
    out = out.numpy()
    np.testing.assert_allclose(out, np.asarray(ops.qgemv(x, wq, s, interpret=True)),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(ref.qgemv_ref(x, wq, s)),
                               rtol=2e-4, atol=1e-4)
    port_ref = tref.qgemv_ref(*map(torch.from_numpy, (x, wq, s))).numpy()
    np.testing.assert_array_equal(out, port_ref)


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "s_dtype", "rank", "k_mismatch",
                                 "n_not_256", "scale_shape", "empty", "device",
                                 "noncontig"])
def test_qgemv_rejects_bad_inputs(bad):
    x = torch.zeros(2, 64)
    w = torch.zeros(64, 256, dtype=torch.int8)
    s = torch.ones(256)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "w_dtype":
        w = w.to(torch.int16)
    elif bad == "s_dtype":
        s = s.half()
    elif bad == "rank":
        x = x[None]
    elif bad == "k_mismatch":
        w = torch.zeros(65, 256, dtype=torch.int8)
    elif bad == "n_not_256":
        w, s = torch.zeros(64, 384, dtype=torch.int8), torch.ones(384)
    elif bad == "scale_shape":
        s = torch.ones(128)
    elif bad == "empty":
        x = torch.zeros(0, 64)
    elif bad == "device":
        w = torch.zeros(64, 256, dtype=torch.int8, device="meta")
    elif bad == "noncontig":
        w = torch.zeros(256, 64, dtype=torch.int8).T
    before = tqs.qgemv.launches
    with pytest.raises((TypeError, ValueError)):
        tqs.qgemv(x, w, s)
    assert tqs.qgemv.launches == before


def test_cpu_tensors_do_not_launch():
    x, wq, s = _case(2, 128, 256, seed=3)
    before = tqs.qgemv.launches
    tqs.qgemv(*map(torch.from_numpy, (x, wq, s)))
    assert tqs.qgemv.launches == before


SERVING = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]


@pytest.mark.parametrize("B,K,N", SHAPES + [(8, 2048, 5632), (8, 5632, 2048),
                                            (1, 2048, 32000), (37, 4096, 4096),
                                            (8, 1000, 512), (2, 130, 256), (16, 100, 256),
                                            (9, 64, 256)])
@pytest.mark.parametrize("sms", [132, 8])
def test_plan_covers_k_and_fills_the_card(B, K, N, sms):
    """The kernel's launch plan: rows in chunks of the least power of two
    that holds B, up to 8, on the CUDA cores up to 2 and on the tensor cores
    above; a stripe width and a cluster size the kernel takes; the ranks' k
    ranges, whole stages in rank order, tile K exactly, an empty rank only
    where K has fewer stages than the cluster ranks; and the grid fills
    every SM unless the narrowest stripe at the largest cluster (or one
    rank per stage) cannot."""
    p = tqs.plan(B, K, N, sms)
    assert p.rb == min(8, 1 << (B - 1).bit_length()) and p.mma == (B > 2)
    assert p.tn in (tqs.STRIPES if p.mma else tqs.STRIPES[:2]) and N % p.tn == 0
    assert p.cluster in tqs.CLUSTERS
    assert p.depth == (tqs.RING if p.mma else
                       tqs.CORES_DEPTH[p.ctas(B, N) <= tqs.BLOCKS_PER_SM * sms])
    ranges = [p.k_range(r, K) for r in range(p.cluster)]
    assert [k for rng in ranges for k in rng] == list(range(K))
    assert all(rng.start % tqs.KS == 0 and len(rng) <= p.kchunk for rng in ranges)
    steps = -(-K // tqs.KS)
    assert all(len(rng) > 0 for rng in ranges) or steps < p.cluster
    narrowest = min(tqs.STRIPES) if p.mma else tqs.STRIPES[1]
    assert p.ctas(B, N) >= sms or (p.tn == narrowest and
                                   p.cluster >= min(max(tqs.CLUSTERS), steps))


@pytest.mark.parametrize("K,N", SERVING)
@pytest.mark.parametrize("B", [8, 1])
def test_plan_at_the_serving_projections(B, K, N):
    """Every SM busy at every serving projection where the stripes allow it:
    N = 256 has 8 stripes of 32 columns on the tensor cores and 4 of 64 on
    the CUDA cores (B = 1), so a cluster of 8 (the portable maximum) gives
    64 and 32 CTAs. The plan reads the shape and the SM count only."""
    p = tqs.plan(B, K, N, 132)
    if p.ctas(B, N) < 132:
        assert p.cluster == 8 and p.tn == (32 if p.mma else 64) and N == 256
    assert list(inspect.signature(tqs.plan.__wrapped__).parameters) == ["B", "K", "N", "sms"]


def test_plan_ring_is_the_kernels():
    source = (Path(tqs.__file__).parent / "csrc" / "qgemv.cu").read_text()
    assert tqs.RING == int(re.search(r"#define QGEMV_RING (\d+)", source).group(1))


def test_chip_smoke_cases_take_every_kernel_variant():
    """``chip_smoke.check_qgemv`` holds every template variant of the kernel
    that the plan can pick on the H100 (132 SMs) against the plain version:
    its cases' plans, with the weights of the offset cases 4 bytes past an
    aligned base, cover ``QGEMV_VARIANTS``, and no plan here leaves them."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    taken = set()
    for B, K, N, offset in cs.QGEMV_CASES:
        taken |= cs.qgemv_variant(tqs.plan(B, K, N, 132), K, 4 if offset else 0, 0)
    assert taken == cs.QGEMV_VARIANTS
    for B in (1, 2, 4, 8, 16):
        for (K, N), w_ptr in zip(SERVING, (0, 4, 0, 4, 0)):
            assert cs.qgemv_variant(tqs.plan(B, K, N, 132), K, w_ptr, 0) <= cs.QGEMV_VARIANTS


# -------------------------------------- the kernel's arithmetic, emulated

def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the f32 bits: add half of the dropped 13 bits'
    unit to the magnitude (ties away from zero) and clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma_round(t64: torch.Tensor) -> torch.Tensor:
    """An MMA's f32 sum, modelled as the exact sum rounded toward zero (the
    tensor cores' adds truncate)."""
    f = t64.to(torch.float32)
    over = f.double().abs() > t64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


CORES_WARPS = 8                # warps per CTA of the CUDA-core kernel


def _fold(parts):
    """Left to right in f32, as the kernel adds warps and ranks."""
    total = parts[0]
    for v in parts[1:]:
        total = total + v
    return total


def emulate_qgemv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, p) -> torch.Tensor:
    """The CUDA kernel's order, for all stripes at once. On the tensor cores
    (``p.mma``): each warp's k slice of each 64-k stage summed by MMAs (hi
    parts into fresh sums, added to a running f32 sum; lo parts in one MMA
    chain), the warps of a column group added in warp order. On the CUDA
    cores: warp ``v``'s lane row group ``r`` takes rows ``4 (v + 8 i) + r``
    of the rank's range (8 warps), one fused multiply-add per row, the 4 groups
    added as (r0 + r1) + (r2 + r3), the warps in warp order. Then the
    cluster's ranks in rank order, then the scale. Rows of x in chunks of
    ``p.rb``, zeros past B and past K."""
    B, K = x.shape
    N = w.shape[1]
    out = torch.empty(B, N)
    wf = w.double()
    for b0 in range(0, B, p.rb):
        rows = min(p.rb, B - b0)
        xb = torch.zeros(8 if p.mma else p.rb, K)
        xb[:rows] = x[b0:b0 + rows]
        ranks = []
        for r in range(p.cluster):
            kb, ke = p.k_range(r, K).start, p.k_range(r, K).stop
            warps = []
            if not p.mma:
                for wi in range(CORES_WARPS):
                    groups = []
                    for r4 in range(4):                      # lane rows 4i + r4
                        acc = torch.zeros(p.rb, N)
                        for k in range(kb + 4 * wi + r4, ke, 4 * CORES_WARPS):   # fmaf
                            acc = (xb[:, k:k + 1].double() * wf[k] + acc.double()).float()
                        groups.append(acc)
                    warps.append((groups[0] + groups[1]) + (groups[2] + groups[3]))
            else:
                hi, lo = tf32_rna(xb), None
                lo = tf32_rna(xb - hi)
                ksl = 128 // p.tn                            # warps along k in a stage
                spw = 8 // ksl                               # k steps per warp per stage
                for sl in range(ksl):
                    run, acc_lo = torch.zeros(8, N), torch.zeros(8, N)
                    for k0 in range(kb, ke, tqs.KS):
                        acc_hi = torch.zeros(8, N)
                        for step in range(sl * spw, (sl + 1) * spw):
                            ks = slice(k0 + 8 * step, min(ke, k0 + 8 * step + 8))
                            if ks.start >= ke:
                                continue
                            acc_hi = mma_round(hi[:, ks].double() @ wf[ks] + acc_hi.double())
                            acc_lo = mma_round(lo[:, ks].double() @ wf[ks] + acc_lo.double())
                        run = run + acc_hi
                    warps.append(run + acc_lo)
            ranks.append(_fold(warps))
        out[b0:b0 + rows] = (_fold(ranks) * s[None, :])[:rows]
    return out


def test_tf32_rounding_on_the_bits():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0e38])
    out = tf32_rna(v)
    assert out.tolist()[:5] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -10), 1.0]
    assert ((out.view(torch.int32) & 0x1FFF) == 0).all()
    x = torch.randn(4096)
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    assert ((x - hi) - lo).abs().max() <= 2.0 ** -21 * x.abs().max()


EMULATED = SHAPES + [(9, 1000, 512), (2, 130, 256), (8, 4096, 256), (5, 704, 768)]


@pytest.mark.parametrize("B,K,N", EMULATED)
def test_emulated_kernel_matches_jax_and_keeps_its_error(B, K, N):
    """The emulation against the Pallas kernel (interpret) within the JAX
    contract, and its error against an fp64 product, max |diff| over max
    |product|, at most 4x the plain version's in f32 (chip_smoke holds the
    kernel itself to the same ratio on the card)."""
    x, wq, s = _case(B, K, N, seed=K + N + B)
    xt, wt, st = map(torch.from_numpy, (x, wq, s))
    out = emulate_qgemv(xt, wt, st, tqs.plan(B, K, N, 132)).numpy()
    np.testing.assert_allclose(out, np.asarray(ops.qgemv(x, wq, s, interpret=True)),
                               rtol=2e-4, atol=1e-4)
    exact = (x.astype(np.float64) @ wq.astype(np.float64)) * s.astype(np.float64)
    plain = tqs.qgemv_plain(xt, wt, st).numpy()
    err = np.abs(out - exact).max() / np.abs(exact).max()
    err_plain = np.abs(plain - exact).max() / np.abs(exact).max()
    assert err <= 4 * err_plain, (err, err_plain)


# ------------------------------------------------- on the card (CUDA only)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_qgemv_kernel_matches_plain_on_card(cuda_device):
    for B, K, N in SHAPES + [(8, 2048, 32000), (8, 2048, 2048), (1, 2048, 5632),
                             (2, 2048, 32000), (1, 2048, 32000)]:
        x, wq, s = (torch.from_numpy(a).to(cuda_device) for a in _case(B, K, N, seed=K))
        out = tqs.qgemv(x, wq, s)
        torch.testing.assert_close(out, tqs.qgemv_plain(x, wq, s), rtol=2e-4, atol=1e-4)
        assert torch.equal(out, tqs.qgemv(x, wq, s))
