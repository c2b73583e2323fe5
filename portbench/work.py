"""The work a served window needs, worked out from the configuration and
the tokens served, and the H100's published peaks it is held against.

Nothing here looks at how the program runs the work: no padding rows, no
bucket widths, no kernel plans. A fused, split or replaced kernel is
measured against the same numbers.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W
limit: 1,979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s HBM3. The run prints
the card's power limit beside the shares it reports.

Counting rules:

* int8 work: every projection the configuration quantizes (attention q, k,
  v, o; the MLP; in an MoE layer the shared experts' MLP; the output
  head), 2 ops a multiply-add, at the int8 peak. The output head runs once
  per emitted token: at decode for every token, at admission for the
  prompt's last position only.
* float work: attention scores and values (causal over the live context),
  and in an MoE layer the router (2 D E a token) and the routed experts
  (k experts of three D x F products, 6 k D F a token), at the bf16 peak.
* a projection's least time: the larger of its operations over the int8
  peak and its bytes over the bandwidth, counting the int8 weight, its f32
  channel scales, the int8 input rows and their f32 row scales, and the
  bf16 output rows, each once, at the live row count.
* decode attention's least time: every live cached token's K and V (bf16)
  read once per layer, plus the f32 query and output rows.
* the routed experts' least time, per MoE layer and step of ``rows``
  tokens: the larger of their operations over the bf16 peak and their
  bytes over the bandwidth. The bytes are the int8 codes and f32 channel
  scales of the distinct experts the step touches, as many as uniform
  routing touches on expectation, E (1 - (1 - k / E)^rows), plus the rows'
  bf16 input and output.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

from portbench.model import Model

PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
KV_BYTES = 2                  # bf16 KV cache entries


@dataclasses.dataclass
class Work:
    int8_ops: float = 0.0
    float_flops: float = 0.0
    qgemm_least_s: float = 0.0      # the projections qgemm runs (qgemm_projections)
    decode_attn_least_s: float = 0.0
    expert_least_s: float = 0.0     # the routed experts of the MoE layers

    def add(self, other: "Work") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    @property
    def least_s(self) -> float:
        """The least time of the whole work at the published peaks."""
        return self.int8_ops / PEAK_INT8_OPS + self.float_flops / PEAK_BF16_FLOPS


def qgemm_projections(m: Model) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """(layers, [(K, N), ...]) for each kind of layer: how many layers of
    the kind, and (K, N) of each of its int8 projections, each a W8A8 GEMM
    with quantized activations: attention and the MLP (dense layers), or
    attention and the shared experts' MLP (MoE layers)."""
    D, H, KV, hd = m.d_model, m.n_heads, m.n_kv, m.head_dim
    attn = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D)]

    def mlp(F):
        return [(D, F), (D, F), (F, D)] if F else []
    kinds = [(m.n_layers - m.n_moe_layers, attn + mlp(m.d_ff))]
    if m.n_moe_layers:
        kinds.append((m.n_moe_layers, attn + mlp(m.n_shared * m.expert_ff)))
    return [(n, projs) for n, projs in kinds if n]


def _gemm_least_s(rows: int, K: int, N: int) -> float:
    ops = 2.0 * rows * K * N
    nbytes = K * N + 4 * N + rows * K + 4 * rows + 2 * rows * N
    return max(ops / PEAK_INT8_OPS, nbytes / HBM_BYTES_S)


def _qgemm_least_s(m: Model, rows: int) -> float:
    """The least time of every layer's int8 projections at ``rows`` rows."""
    return sum(n * sum(_gemm_least_s(rows, K, N) for K, N in projs)
               for n, projs in qgemm_projections(m))


def _linear_ops_per_token(m: Model) -> float:
    """int8 ops of one token through every layer, output head excluded."""
    return sum(sum(2.0 * K * N for K, N in projs) * n for n, projs in qgemm_projections(m))


def _moe_flops_per_token(m: Model) -> float:
    """Float ops of one token through every MoE layer's router and its k
    routed experts."""
    D, F = m.d_model, m.expert_ff
    return m.n_moe_layers * (2.0 * D * m.n_experts + 6.0 * m.topk * D * F)


def _expert_least_s(m: Model, rows: int) -> float:
    """The routed experts' least time over every MoE layer for one step of
    ``rows`` tokens (module doc)."""
    if not m.n_moe_layers or rows == 0:
        return 0.0
    D, F, E, k = m.d_model, m.expert_ff, m.n_experts, m.topk
    touched = E * (1.0 - (1.0 - k / E) ** rows)
    nbytes = touched * (3 * D * F + 4 * (2 * F + D)) + 2 * rows * D * 2
    ops = 6.0 * k * D * F * rows
    return m.n_moe_layers * max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_S)


def decode_step(m: Model, contexts: Iterable[int]) -> Work:
    """One decode step: one token for each live row, row r attending over
    ``contexts[r]`` positions (its prompt and every token fed so far)."""
    ctx = list(contexts)
    n = len(ctx)
    w = Work()
    if n == 0:
        return w
    head = 2.0 * m.d_model * m.vocab
    w.int8_ops = n * (_linear_ops_per_token(m) + head)
    w.float_flops = (4.0 * m.n_heads * m.head_dim * sum(ctx) * m.n_layers
                     + n * _moe_flops_per_token(m))
    w.expert_least_s = _expert_least_s(m, n)
    w.qgemm_least_s = _qgemm_least_s(m, n) + _gemm_least_s(n, m.d_model, m.vocab)
    kv_bytes = sum(ctx) * m.n_kv * m.head_dim * KV_BYTES * 2
    qo_bytes = n * m.n_heads * m.head_dim * 4 * 2
    attn_ops = 4.0 * m.n_heads * m.head_dim * sum(ctx)
    w.decode_attn_least_s = m.n_layers * max((kv_bytes + qo_bytes) / HBM_BYTES_S,
                                             attn_ops / PEAK_BF16_FLOPS)
    return w


def prefill(m: Model, prompt_len: int) -> Work:
    """Admission of one prompt of ``prompt_len`` tokens: every position
    through every layer, causal attention, and the output head at the last
    position."""
    P = prompt_len
    w = Work()
    head = 2.0 * m.d_model * m.vocab
    w.int8_ops = P * _linear_ops_per_token(m) + head
    w.float_flops = (2.0 * m.n_heads * m.head_dim * P * (P + 1) * m.n_layers
                     + P * _moe_flops_per_token(m))
    w.expert_least_s = _expert_least_s(m, P)
    w.qgemm_least_s = _qgemm_least_s(m, P) + _gemm_least_s(1, m.d_model, m.vocab)
    return w
