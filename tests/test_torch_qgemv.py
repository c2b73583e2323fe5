"""Port parity: the int8-weight GEMV ``repro_torch.kernels.qdot_serve.qgemv``
against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and its ``ref.qgemv_ref`` oracle.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel runs
only on a card (the test marked ``cuda``, skipped here with a reason).

Tolerance: rtol 2e-4, atol 1e-4, the JAX kernel contract
(tests/test_kernels.py). The plain version and the JAX kernel compute the
same f32 sums in the order of their own matmuls.
"""

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


@pytest.mark.parametrize("B,K,N", SHAPES + [(8, 2048, 5632), (8, 5632, 2048),
                                            (1, 2048, 32000), (37, 4096, 4096)])
@pytest.mark.parametrize("sms", [132, 8])
def test_plan_covers_k_and_fills_the_card(B, K, N, sms):
    """The kernel's launch plan: rows in chunks of the least power of two
    that holds B, up to 8; K ranges that tile K exactly (whole multiples of
    KSTEP, the last one partial); and K split across blocks until they are
    more than one per SM, unless no split can shrink further."""
    rb, kchunk, splits = tqs.plan(B, K, N, sms)
    assert rb == min(8, 1 << (B - 1).bit_length())
    assert kchunk % tqs.KSTEP == 0 and (splits - 1) * kchunk < K <= splits * kchunk
    blocks = (N // tqs.TN) * -(-B // rb) * splits
    assert blocks >= sms or splits == -(-K // tqs.KSTEP)


# ------------------------------------------------- on the card (CUDA only)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_qgemv_kernel_matches_plain_on_card(cuda_device):
    for B, K, N in SHAPES + [(8, 2048, 32000)]:
        x, wq, s = (torch.from_numpy(a).to(cuda_device) for a in _case(B, K, N, seed=K))
        out = tqs.qgemv(x, wq, s)
        torch.testing.assert_close(out, tqs.qgemv_plain(x, wq, s), rtol=2e-4, atol=1e-4)
        assert torch.equal(out, tqs.qgemv(x, wq, s))
