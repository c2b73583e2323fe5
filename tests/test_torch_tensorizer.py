"""Port parity: Tensorizer quantization (repro_torch.core.tensorizer) against
the JAX package's (repro.core.tensorizer). Tolerance: int8 codes and scales
BIT-EXACT — both compute amax, one f32 division by 127, one f32 division per
element and round-half-to-even, all exact IEEE operations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tensorizer as jtz
from repro_torch.core import tensorizer as ttz
from repro_torch.testing.params import params_from_numpy


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(np.float32)
    if kind == "integer":
        return rng.integers(-127, 128, shape).astype(np.float32)
    # exact .5 ties after scaling: amax 127 -> scale 1, halves round to even
    x = rng.integers(-100, 100, shape).astype(np.float32) + 0.5
    x.flat[0] = 127.0
    return x


@pytest.mark.parametrize("kind", ["random", "integer", "ties"])
@pytest.mark.parametrize("axis", [None, (-1,), (-2,), (0,)])
def test_quantize_bit_exact(kind, axis):
    x = _inputs(kind, (3, 17, 40), seed=hash((kind, str(axis))) % 1000)
    ref = jtz.quantize(jnp.asarray(x), axis=axis)
    out = ttz.quantize(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    assert out.q.dtype == torch.int8


def test_amax_calibrate_bit_exact():
    x = _inputs("random", (5, 33), seed=3)
    for axis in (None, (1,), (0,)):
        np.testing.assert_array_equal(
            ttz.amax_calibrate(torch.from_numpy(x), axis=axis).numpy(),
            np.asarray(jtz.amax_calibrate(jnp.asarray(x), axis=axis)))
    zeros = torch.zeros(4, 4)
    assert float(ttz.amax_calibrate(zeros)) == pytest.approx(1e-12 / 127.0)


def test_quantize_params_keeps_layer_axis_and_matches():
    rng = np.random.default_rng(11)
    tree = {
        "embed": rng.standard_normal((32, 8)).astype(np.float32),
        "final_ln": {"scale": np.ones((8,), np.float32)},
        "layers": {"attn": {"wq": rng.standard_normal((3, 8, 12)).astype(np.float32)},
                   "ln1": {"scale": np.ones((3, 8), np.float32)}},
        "lm_head": rng.standard_normal((8, 32)).astype(np.float32),
    }

    def keep(name):   # the serve CLI's rule: projections and lm_head only
        return name == "lm_head" or name.startswith("w")

    ref = jtz.quantize_params(jax.tree.map(jnp.asarray, tree),
                              predicate=lambda path, leaf: keep(path[-1].key))
    out = ttz.quantize_params(params_from_numpy(tree, device="cpu"),
                              predicate=lambda path, leaf: keep(path[-1]))
    wq = out["layers"]["attn"]["wq"]
    assert isinstance(wq, ttz.QTensor) and tuple(wq.scale.shape) == (3, 1, 12)
    assert not isinstance(out["embed"], ttz.QTensor)
    assert not isinstance(out["layers"]["ln1"]["scale"], ttz.QTensor)
    for path in (("layers", "attn", "wq"), ("lm_head",)):
        r, o = ref, out
        for k in path:
            r, o = r[k], o[k]
        np.testing.assert_array_equal(o.q.numpy(), np.asarray(r.q))
        np.testing.assert_array_equal(o.scale.numpy(), np.asarray(r.scale))
    # the converter carries the JAX QTensor q/scale pairs across verbatim
    carried = params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu")
    np.testing.assert_array_equal(carried["lm_head"].q.numpy(),
                                  np.asarray(ref["lm_head"].q))
    np.testing.assert_array_equal(carried["lm_head"][()].scale.numpy(),
                                  np.asarray(ref["lm_head"].scale))


def test_params_from_numpy_defaults_to_the_card():
    """With no device the converter resolves ``cuda``, as every entry point of
    the port does: without a card it raises and does not land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable here")
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"
