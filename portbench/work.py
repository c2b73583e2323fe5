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
  v, o; the MLP; the output head), 2 ops a
  multiply-add, at the int8 peak. The output head runs once per emitted
  token: at decode for every token, at admission for the prompt's last
  position only.
* float work: attention scores and values (causal over the live context),
  at the bf16 peak.
* a projection's least time: the larger of its operations over the int8
  peak and its bytes over the bandwidth, counting the int8 weight, its f32
  channel scales, the int8 input rows and their f32 row scales, and the
  bf16 output rows, each once, at the live row count.
* decode attention's least time: every live cached token's K and V (bf16)
  read once per layer, plus the f32 query and output rows.
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

    def add(self, other: "Work") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    @property
    def least_s(self) -> float:
        """The least time of the whole work at the published peaks."""
        return self.int8_ops / PEAK_INT8_OPS + self.float_flops / PEAK_BF16_FLOPS


def qgemm_projections(m: Model) -> List[Tuple[int, int]]:
    """(K, N) of each int8 projection of one layer, each a W8A8 GEMM with
    quantized activations: attention and the MLP."""
    D, H, KV, hd, F = m.d_model, m.n_heads, m.n_kv, m.head_dim, m.d_ff
    return [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D), (D, F), (D, F), (F, D)]


def _gemm_least_s(rows: int, K: int, N: int) -> float:
    ops = 2.0 * rows * K * N
    nbytes = K * N + 4 * N + rows * K + 4 * rows + 2 * rows * N
    return max(ops / PEAK_INT8_OPS, nbytes / HBM_BYTES_S)


def _linear_ops_per_token(m: Model) -> float:
    """int8 ops of one token through every layer, output head excluded."""
    return sum(2.0 * K * N for K, N in qgemm_projections(m)) * m.n_layers


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
    w.float_flops = 4.0 * m.n_heads * m.head_dim * sum(ctx) * m.n_layers
    w.qgemm_least_s = (m.n_layers * sum(_gemm_least_s(n, K, N) for K, N in qgemm_projections(m))
                       + _gemm_least_s(n, m.d_model, m.vocab))
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
    w.float_flops = 2.0 * m.n_heads * m.head_dim * P * (P + 1) * m.n_layers
    w.qgemm_least_s = (m.n_layers * sum(_gemm_least_s(P, K, N) for K, N in qgemm_projections(m))
                       + _gemm_least_s(1, m.d_model, m.vocab))
    return w
