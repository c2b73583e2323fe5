"""The port's pod-scale tpuGemm on one card against the JAX package's
``core/distributed_gemm.py``.

* ``distributed_gemm(quantized=True)`` is bitwise the reference's on the
  same numpy inputs (the W8A8 path: per-tensor A, per-channel B, int32
  accumulation through qgemm's plain version here); ``quantized=False``
  is a plain float product, held to the reference's within 1e-5 relative
  (XLA and PyTorch sum the f32 products in different orders).
* ``dryrun_distributed_gemm`` counts the GEMM on meta: exactly 2MNK
  contraction FLOPs in one qgemm record (quantized) or one mm (float), the
  ideal split over one device, collective bytes null with the reason; a
  pod mesh is refused.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import distributed_gemm as JDG
from repro.distributed import sharding as jshd
from repro_torch.accounting import COLLECTIVES_NOTE, Accounting
from repro_torch.core import distributed_gemm as TDG
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import qgemm as tq
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh

SHAPES = [(64, 96, 128), (37, 130, 257)]


@pytest.fixture
def meshes():
    prev = jshd.current_mesh()
    jshd.set_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,)))
    with tshd.use_mesh(make_smoke_mesh(1, "cpu")):
        yield
    jshd.set_mesh(prev)


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_quantized_is_bitwise_the_references(meshes, M, K, N):
    a, b = _inputs(M, K, N)
    ref = np.asarray(JDG.distributed_gemm(a, b, quantized=True))
    got = TDG.distributed_gemm(torch.from_numpy(a), torch.from_numpy(b), quantized=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_float_matches_the_reference(meshes, M, K, N):
    a, b = _inputs(M, K, N, seed=1)
    ref = np.asarray(JDG.distributed_gemm(a, b, quantized=False))
    got = TDG.distributed_gemm(torch.from_numpy(a), torch.from_numpy(b), quantized=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("quantized", [True, False])
def test_dryrun_counts_two_mnk_on_meta(meshes, quantized):
    M, K, N = 16384, 16384, 16384
    launches = tq.qgemm.launches
    rec = TDG.dryrun_distributed_gemm(M, K, N, quantized=quantized)
    assert rec["flops_dev"] == 2 * M * N * K
    assert rec["ideal_flops_dev"] == 2.0 * M * N * K and rec["n_devices"] == 1
    assert rec["collective_bytes_dev"] is None and rec["collectives"] == COLLECTIVES_NOTE
    assert rec["bytes_dev"] >= 4 * (M * K + K * N + M * N)
    assert tq.qgemm.launches == launches
    a = torch.empty((M, K), device="meta")
    with Accounting() as acc:
        TDG.distributed_gemm(a, torch.empty((K, N), device="meta"), quantized=quantized)
    if quantized:
        assert acc.kernels["qgemm"] == {"calls": 1, "flops": 2 * M * N * K,
                                        "bytes": M * K + K * N + 4 * N + 4 * M * N}
    else:
        assert dict(acc.flops_by_op) == {"mm": 2 * M * N * K}


def test_dryrun_refuses_a_pod_mesh():
    with tshd.use_mesh(make_production_mesh(multi_pod=False)):
        with pytest.raises(ValueError, match="one device"):
            TDG.dryrun_distributed_gemm(64, 64, 64)
