"""work.py against counts made by hand."""

import pytest

import pbtest  # noqa: F401  (import path)

from portbench import spec, work
from portbench.model import Model

DENSE = Model(family="dense", n_layers=2, d_model=4, n_heads=2, n_kv=1, head_dim=2,
              vocab=10, d_ff=6)


def test_decode_step_by_hand():
    w = work.decode_step(DENSE, [5, 7])
    # per layer: q 4x4, k 4x2, v 4x2, o 4x4, mlp 3 x 4x6 -> 120 MACs; head 40
    assert w.int8_ops == 2 * (2 * (2 * 120) + 2 * 40)
    # attention: 4 * H * hd * ctx per layer
    assert w.float_flops == 4 * 2 * 2 * (5 + 7) * 2
    kv = (5 + 7) * 1 * 2 * 2 * 2
    qo = 2 * 2 * 2 * 4 * 2
    assert abs(w.decode_attn_least_s - 2 * (kv + qo) / work.HBM_BYTES_S) < 1e-30


def test_prefill_by_hand():
    w = work.prefill(DENSE, 3)
    assert w.int8_ops == 3 * 2 * (2 * 120) + 2 * 40
    # causal: sum over positions i = 1..P of 4 * H * hd * i = 2 H hd P (P + 1)
    assert w.float_flops == 2 * 2 * 2 * 3 * 4 * 2
    assert w.decode_attn_least_s == 0


def test_projections_are_attention_and_the_mlp():
    assert work.qgemm_projections(DENSE) == [(4, 4), (4, 2), (4, 2), (4, 4), (4, 6), (4, 6),
                                             (6, 4)]


def test_a_mixture_of_experts_is_refused():
    c = spec.load_json(spec.BENCH / "configs" / "qwen3-14b.json")
    with pytest.raises(ValueError, match="mixture-of-experts"):
        Model.from_config(dict(c, n_routed_experts=64))


def test_gemm_least_time_is_the_larger_bound():
    small = work._gemm_least_s(1, 4096, 4096)
    assert abs(small - (4096 * 4096 + 4 * 4096 + 4096 + 4 + 2 * 4096) / work.HBM_BYTES_S) < 1e-12
    big = work._gemm_least_s(8192, 8192, 8192)
    assert abs(big - 2 * 8192 ** 3 / work.PEAK_INT8_OPS) < 1e-12


def test_least_time_sums_both_peaks():
    w = work.Work(int8_ops=work.PEAK_INT8_OPS, float_flops=work.PEAK_BF16_FLOPS)
    assert abs(w.least_s - 2.0) < 1e-12
