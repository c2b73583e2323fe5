"""Port parity: model layers (repro_torch.models.layers) against
repro.models.layers on the same inputs, made from a numpy seed.

Tolerances, each with its reason
  * pdot, W8A8: BITWISE. Per-row quantization, exact int32 accumulation and
    the epilogue ``acc * (sx * sw)`` are the same IEEE f32 operations in the
    same order, then one rounding to bf16.
  * apply_norm (bf16 out): one bf16 ulp (rtol 2^-7). The f32 mean of squares
    is a reduction whose order differs between XLA and torch; the last f32
    bit can move a bf16 rounding.
  * apply_rope: f32 out to 1e-5 absolute (sin/cos of f32 angles differ by a
    few f32 ulps between the two libraries); bf16 out to one bf16 ulp.
  * apply_mlp (W8A8, bf16 out): one bf16 ulp of the row's absolute max.
    The port's silu repeats jax.nn.silu's op-by-op bf16 rounding, but exp
    may differ by an f32 ulp between the libraries, and a one-ulp change of
    the hidden row can move one of its int8 codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config
from repro.core import tensorizer as jtz
from repro.distributed import sharding as shd
from repro.models import layers as JL
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as TL
from repro_torch.testing.params import params_from_numpy

CFG = get_config("tinyllama-1.1b").smoke()
TCFG = tget_config("tinyllama-1.1b").smoke()
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def auto_mesh():
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        yield


def _bf16(a):
    """numpy f32 values that are exactly representable in bf16."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def test_configs_match_reference():
    import dataclasses
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(CFG)
    assert (dataclasses.asdict(tget_config("tinyllama-1.1b"))
            == dataclasses.asdict(get_config("tinyllama-1.1b")))
    assert (dataclasses.asdict(tget_config("qwen3-14b"))
            == dataclasses.asdict(get_config("qwen3-14b")))
    # the last three families are ported too; an unknown arch is refused
    for arch in ("xlstm-125m", "seamless-m4t-medium", "qwen2-vl-2b"):
        assert dataclasses.asdict(tget_config(arch)) == dataclasses.asdict(get_config(arch))
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("gpt-5")


@pytest.mark.parametrize("shape,K,N", [((2, 5), 64, 96), ((1, 1), 128, 256),
                                       ((3, 16), 64, 256)])
def test_pdot_w8a8_bitwise(shape, K, N):
    rng = np.random.default_rng(sum(shape) + K + N)
    x = _bf16(rng.standard_normal(shape + (K,)) * 2)
    w = jtz.quantize(jnp.asarray(rng.standard_normal((K, N)) / np.sqrt(K),
                                 jnp.float32), axis=(-2,))
    ref = JL.pdot(jnp.asarray(x, jnp.bfloat16), w, CFG)
    tw = params_from_numpy({"w": jax.tree.map(np.asarray, w)}, device="cpu")["w"]
    out = TL.pdot(_t(x, torch.bfloat16), tw, TCFG)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape + (N,)
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_apply_norm_within_one_ulp():
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal((3, 7, 64)) * 3)
    scale = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    ref = JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jnp.bfloat16), CFG)
    out = TL.apply_norm({"scale": _t(scale)}, _t(x, torch.bfloat16), TCFG)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    rng = np.random.default_rng(2)
    x = _bf16(rng.standard_normal((2, 9, 4, 16)))
    pos = rng.integers(0, 200, (2, 9)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JL.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), CFG.rope_theta)
    out = TL.apply_rope(_t(x, tdt), torch.from_numpy(pos), TCFG.rope_theta)
    np.testing.assert_allclose(TL.rope_freqs(16, 1e4).numpy(),
                               np.asarray(JL.rope_freqs(16, 1e4)), rtol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(out), _np(ref), rtol=BF16_ULP, atol=1e-5)


def test_apply_mlp_w8a8():
    rng = np.random.default_rng(3)
    D, F = CFG.d_model, CFG.d_ff
    p = {n: jtz.quantize(jnp.asarray(rng.standard_normal(s) / np.sqrt(s[0]),
                                     jnp.float32), axis=(-2,))
         for n, s in (("wi", (D, F)), ("wg", (D, F)), ("wo", (F, D)))}
    x = _bf16(rng.standard_normal((2, 6, D)))
    ref = _np(JL.apply_mlp(p, jnp.asarray(x, jnp.bfloat16), CFG))
    out = TL.apply_mlp(params_from_numpy(jax.tree.map(np.asarray, p), device="cpu"),
                       _t(x, torch.bfloat16), TCFG)
    row_max = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.all(np.abs(_np(out) - ref) <= BF16_ULP * row_max)
