"""work.py against counts made by hand, dense and mixture of experts, and
the dense cell's figures held to the ones it read before the MoE counts."""

import dataclasses

import pytest

import pbtest  # noqa: F401  (import path)

from portbench import spec, work
from portbench.model import Model

DENSE = Model(family="dense", n_layers=2, d_model=4, n_heads=2, n_kv=1, head_dim=2,
              vocab=10, d_ff=6)
# one leading dense layer of width 5, then two MoE layers: 4 experts of
# width 3, top-2, 2 shared (a shared MLP of width 6)
MOE = Model(family="moe", n_layers=3, d_model=4, n_heads=2, n_kv=1, head_dim=2, vocab=10,
            d_ff=5, n_experts=4, n_shared=2, topk=2, expert_ff=3, first_k_dense=1)
ATTN = [(4, 4), (4, 2), (4, 2), (4, 4)]


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
    assert work.qgemm_projections(DENSE) == [(2, ATTN + [(4, 6), (4, 6), (6, 4)])]
    assert work.qgemm_projections(MOE) == [(1, ATTN + [(4, 5), (4, 5), (5, 4)]),
                                           (2, ATTN + [(4, 6), (4, 6), (6, 4)])]
    no_dense = dataclasses.replace(MOE, first_k_dense=0, n_shared=0)
    assert work.qgemm_projections(no_dense) == [(3, ATTN)]


def test_moe_decode_step_by_hand():
    w = work.decode_step(MOE, [5, 7])
    # int8 MACs a token: attention 48 a layer; the dense MLP 60, the shared 72
    assert w.int8_ops == 2 * (2 * (48 * 3 + 60 + 2 * 72) + 2 * 40)
    # attention over every layer; router 4 x 4 and 2 experts of 3 x 4 x 3
    # MACs a token in each MoE layer
    assert w.float_flops == 4 * 2 * 2 * (5 + 7) * 3 + 2 * 2 * (2 * 16 + 2 * 2 * 36)
    # 2 rows over 4 experts, top-2: 4 (1 - 1/4) = 3 experts touched, each
    # 36 int8 codes and 10 f32 scales; 2 bf16 rows in and out
    nbytes = 3 * (36 + 4 * 10) + 2 * 2 * 4 * 2
    ops = 2 * 2 * 2 * 36
    assert w.expert_least_s == 2 * max(ops / work.PEAK_BF16_FLOPS, nbytes / work.HBM_BYTES_S)
    assert w.expert_least_s == 2 * nbytes / work.HBM_BYTES_S


def test_moe_prefill_by_hand():
    w = work.prefill(MOE, 3)
    assert w.int8_ops == 3 * 2 * (48 * 3 + 60 + 2 * 72) + 2 * 40
    assert w.float_flops == 2 * 2 * 2 * 3 * 4 * 3 + 3 * 2 * (2 * 16 + 2 * 2 * 36)
    touched = 4 * (1 - 0.5 ** 3)
    nbytes = touched * (36 + 4 * 10) + 2 * 3 * 4 * 2
    assert abs(w.expert_least_s - 2 * nbytes / work.HBM_BYTES_S) < 1e-30
    # at many rows every expert is touched and the operations bound it
    big = dataclasses.replace(MOE, d_model=2048, expert_ff=1408, n_experts=64, topk=6)
    w = work.prefill(big, 8192)
    assert w.expert_least_s == 2 * 6 * 6 * 2048 * 1408 * 8192 / work.PEAK_BF16_FLOPS


def test_a_dense_step_touches_no_expert():
    assert work.decode_step(DENSE, [5, 7]).expert_least_s == 0
    assert work.prefill(DENSE, 3).expert_least_s == 0


# qwen3-14b's figures as work.py gave them before the MoE counts, each
# field exactly: contexts, then (int8_ops, float_flops, qgemm_least_s,
# decode_attn_least_s); a prompt length, then the same
DENSE_DECODE = [
    ([1, 1020, 4096, 5120], (111919759360.0, 8386150400.0, 0.004186443620298508,
                             0.0005026219940298508)),
    ([1300] * 60, (1678796390400.0, 63897600000.0, 0.004293648616119403,
                   0.003844126567164179)),
]
DENSE_PREFILL = [
    (1, (27979939840.0, 819200.0, 0.004180700495522389, 0.0)),
    (1020, (26954153328640.0, 426565632000.0, 0.013851787703444376, 0.0)),
    (4096, (108234731683840.0, 6873625395200.0, 0.0549233280547329, 0.0)),
]
FIELDS = ("int8_ops", "float_flops", "qgemm_least_s", "decode_attn_least_s")


def _qwen3():
    return Model.from_config(spec.load_json(spec.BENCH / "configs" / "qwen3-14b.json"))


@pytest.mark.parametrize("contexts, want", DENSE_DECODE, ids=["mixed", "60_rows"])
def test_the_dense_decode_figures_are_unchanged(contexts, want):
    w = work.decode_step(_qwen3(), contexts)
    assert tuple(getattr(w, f) for f in FIELDS) == want and w.expert_least_s == 0.0


@pytest.mark.parametrize("prompt, want", DENSE_PREFILL, ids=lambda v: str(v)[:8])
def test_the_dense_prefill_figures_are_unchanged(prompt, want):
    w = work.prefill(_qwen3(), prompt)
    assert tuple(getattr(w, f) for f in FIELDS) == want and w.expert_least_s == 0.0


def test_gemm_least_time_is_the_larger_bound():
    small = work._gemm_least_s(1, 4096, 4096)
    assert abs(small - (4096 * 4096 + 4 * 4096 + 4096 + 4 + 2 * 4096) / work.HBM_BYTES_S) < 1e-12
    big = work._gemm_least_s(8192, 8192, 8192)
    assert abs(big - 2 * 8192 ** 3 / work.PEAK_INT8_OPS) < 1e-12


def test_least_time_sums_both_peaks():
    w = work.Work(int8_ops=work.PEAK_INT8_OPS, float_flops=work.PEAK_BF16_FLOPS)
    assert abs(w.least_s - 2.0) < 1e-12
