"""Port parity: the paper's seven applications (repro_torch.apps) against the
JAX package's (repro.apps) on the CPU: every app quantized at n = 64, and
hotspot3d's fp path (the Pallas stencil in the JAX package) at n = 32.

Both packages build the same inputs from ``np.random.default_rng(0)`` (the
fp64 references agree bit for bit). gemm, lud and backprop call tpuGemm with
``lowering=None``; the choice is timing, so each runs once per lowering
with both packages' ``best_gemm_lowering`` pinned to it, and no other test
here may reach a table.

Bounds
  * every app within tests/test_apps_accuracy.py's MAPE and RMSE limits, on
    both sides;
  * gaussian: BITWISE (the integer path runs end to end);
  * the others: max |port - JAX| <= 1e-5 x the reference's range. At n = 64
    every tpuGemm is one 128-tile, so what differs is f32 summation order
    and the exp/pow/tanh implementations in their last bits;
  * hotspot3d quantized: max |port - JAX| <= 1e-2 x range and MAPE within
    0.01 points. Its field mean (``torch.mean`` vs ``jnp.mean``) and the
    stencil mass differ in their last bits, which moves a few int8 codes of
    the residual field by one step (~range/127 before the 0.3 weight), and
    8 iterations carry them on.
"""

import numpy as np
import pytest
import torch

import repro.apps as JA
import repro.core.instr_select as jsel
import repro_torch.apps as TA
import repro_torch.core.instr_select as tsel
from test_apps_accuracy import LIMITS, RMSE_LIMITS

LOWERED = ("backprop", "gemm", "lud")
CASES = [(name, low) for name in sorted(LIMITS)
         for low in (("fully_connected", "conv2d") if name in LOWERED else (None,))]


@pytest.fixture(autouse=True)
def _lowering_must_be_pinned(monkeypatch):
    """Neither package may read, measure or write an instruction table."""
    def refuse(*_args, **_kw):
        raise AssertionError("tpuGemm lowering not pinned by the test")
    monkeypatch.setattr(jsel, "best_gemm_lowering", refuse)
    monkeypatch.setattr(tsel, "best_gemm_lowering", refuse)


def _run_both(monkeypatch, name, n, quantized, lowering):
    if lowering is not None:
        monkeypatch.setattr(jsel, "best_gemm_lowering", lambda: lowering)
        monkeypatch.setattr(tsel, "best_gemm_lowering", lambda device=None: lowering)
    jo, jref = JA.ALL[name](n, quantized=quantized)
    to, tref = TA.ALL[name](n, quantized=quantized, device="cpu")
    ref = np.asarray(tref(), np.float64)
    np.testing.assert_array_equal(ref, np.asarray(jref(), np.float64))
    return np.asarray(jo, np.float64), np.asarray(to, np.float64), ref


@pytest.mark.parametrize("name,lowering", CASES, ids=lambda v: str(v))
def test_app_matches_jax(name, lowering, monkeypatch):
    jo, to, ref = _run_both(monkeypatch, name, 64, True, lowering)
    assert to.shape == jo.shape == ref.shape
    for out in (jo, to):
        assert TA.mape(out, ref) <= LIMITS[name]
        assert TA.rmse_pct(out, ref) <= RMSE_LIMITS[name]
    span = ref.max() - ref.min()
    diff = np.abs(to - jo).max()
    if name == "gaussian":
        np.testing.assert_array_equal(to, jo)
    elif name == "hotspot3d":
        assert diff <= 1e-2 * span
        assert abs(TA.mape(to, ref) - JA.mape(jo, ref)) <= 0.01
    else:
        assert diff <= 1e-5 * span, f"{name}: {diff} vs range {span}"


def test_hotspot3d_fp_path_matches_jax(monkeypatch):
    """The stencil kernel's path (the Pallas kernel in the JAX package)."""
    jo, to, ref = _run_both(monkeypatch, "hotspot3d", 32, False, None)
    assert np.abs(to - jo).max() <= 1e-5 * (ref.max() - ref.min())
    assert TA.mape(to, ref) < 0.05


def test_run_app_scores_against_the_reference():
    r = TA.run_app("gaussian", n=24, quantized=True, device="cpu")
    assert (r.name, r.n, r.mape_pct, r.rmse_pct) == ("gaussian", 24, 0.0, 0.0)
    assert r.t_gptpu_s > 0 and r.t_ref_s > 0
    assert set(TA.ALL) == set(JA.ALL)


def test_run_app_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TA.run_app("gemm", n=8)
