"""Port parity: the public kernel entries ``repro_torch.kernels.ops`` against
``repro.kernels.ops`` (Pallas in interpret mode), entry by entry, under the
same name, on the same numpy inputs made from a seed, at one shape of
tests/test_kernels.py each. CPU tensors take the plain versions, so no
kernel's count moves.

Tolerances
  * qgemm_i32: EXACT (the int32 product as f32).
  * qgemm_f32: rtol = atol = 1e-6, the JAX kernel contract.
  * qgemm_tiles: 1e-6 of the output's absolute max. XLA's interpret fuses
    each k step into one multiply-add where the port rounds twice
    (tests/test_torch_gptpu_kernels.py shows both bit for bit).
  * stencil: rtol = atol = 1e-4, the JAX kernel contract.
  * qgemv: rtol 2e-4, atol 1e-4, the JAX kernel contract.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qdot_serve, qgemm, stencil3x3

T = 128


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _grid(x, rb, cb):
    return np.ascontiguousarray(x.reshape(rb, T, cb, T).swapaxes(1, 2))


def _inputs(entry, rng):
    if entry == "qgemm_f32":
        return (_i8(rng, (128, 512)), _i8(rng, (512, 128)),
                rng.uniform(1e-3, 1e-2, (128,)).astype(np.float32))
    if entry == "qgemm_i32":
        return _i8(rng, (128, 512)), _i8(rng, (512, 128))
    if entry == "qgemm_tiles":
        Mb, Kb, Nb = 2, 4, 2
        return (_grid(_i8(rng, (Mb * T, Kb * T)), Mb, Kb),
                rng.uniform(1e-3, 1e-2, (Mb, Kb)).astype(np.float32),
                _grid(_i8(rng, (Kb * T, Nb * T)), Kb, Nb),
                rng.uniform(1e-3, 1e-2, (Kb, Nb)).astype(np.float32))
    if entry == "stencil":
        return (rng.normal(size=(100, 300)).astype(np.float32),
                rng.normal(size=(3, 3)).astype(np.float32))
    return (rng.normal(size=(8, 384)).astype(np.float32), _i8(rng, (384, 512)),
            rng.uniform(1e-3, 1e-2, (512,)).astype(np.float32))


def _check(entry, out, expect):
    if entry == "qgemm_i32":
        np.testing.assert_array_equal(out, expect)
    elif entry == "qgemm_f32":
        np.testing.assert_allclose(out, expect, rtol=1e-6, atol=1e-6)
    elif entry == "qgemm_tiles":
        assert np.abs(out - expect).max() <= 1e-6 * np.abs(expect).max()
    elif entry == "stencil":
        np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(out, expect, rtol=2e-4, atol=1e-4)


COUNTERS = (qgemm.qgemm, qgemm.qgemm_tile_scales, stencil3x3.stencil3x3, qdot_serve.qgemv)


@pytest.mark.parametrize("entry", ["qgemm_f32", "qgemm_i32", "qgemm_tiles", "stencil",
                                   "qgemv"])
def test_ops_entry_matches_jax(entry):
    args = _inputs(entry, np.random.default_rng(len(entry)))
    before = [c.launches for c in COUNTERS]
    out = getattr(tops, entry)(*map(torch.from_numpy, args))
    assert [c.launches for c in COUNTERS] == before
    assert out.dtype == torch.float32
    expect = np.asarray(getattr(jops, entry)(*args, interpret=True))
    assert tuple(out.shape) == expect.shape
    _check(entry, out.numpy(), expect)


def test_ops_reexports_the_oracles():
    assert {"qgemm_ref", "qgemm_tile_scales_ref", "stencil3x3_ref",
            "qgemv_ref"} <= set(vars(tops.ref))
    assert tops.ref.qgemv_ref is qdot_serve.qgemv_plain
    assert tops.qgemm_tiles is qgemm.qgemm_tiles and tops.qgemv is qdot_serve.qgemv
