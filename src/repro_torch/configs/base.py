"""Architecture configuration: the port's copy of ``repro.configs.base``.

One ``ArchConfig`` per architecture lives in ``configs/<id>.py`` with the
published hyper-parameters; ``smoke()`` derives the reduced config the CPU
tests use. The fields are the reference's, so a config built here compares
field for field with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


# The assigned LM shape set (identical across the 10 archs).
SHAPES: Tuple[ShapeCfg, ...] = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCfg:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25
    # the port's own (the JAX package's block by default): leading layers
    # with the dense MLP of width dense_d_ff before the MoE layers, and
    # whether the k gates are renormalised to sum to 1
    first_k_dense: int = 0
    dense_d_ff: Optional[int] = None
    norm_topk_prob: bool = True
    # ---- SSM / hybrid ----
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0
    # ---- features ----
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_kind: str = "rope"        # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    act: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # ---- enc-dec ----
    n_enc_layers: int = 0
    enc_len_ratio: int = 4
    # ---- frontends ----
    input_mode: str = "tokens"     # tokens | embeds
    # ---- runtime ----
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024
    quantize: str = "off"          # off | serve  (Tensorizer W8A8 serving path)
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8
    sub_quadratic: bool = False
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    scan_unroll: bool = False
    shard_heads: bool = True
    attn_impl: str = "f32"
    norm_dtype: str = "float32"
    attn_sp: bool = False
    zero1: bool = False
    grad_allreduce_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows, padded to a 16-multiple; padded logit
        columns are masked to -inf in the head."""
        return ((self.vocab + 15) // 16) * 16

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU tests: small widths, few
        layers, tiny vocab — same code paths."""
        return self.replace(
            n_layers=min(self.n_layers, 4 if self.attn_every else 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            dense_d_ff=128 if self.dense_d_ff else self.dense_d_ff,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            topk=min(self.topk, 2),
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            attn_chunk=16,
            mrope_sections=(2, 3, 3),
        )

    # ------------------------------------------------------------------
    # analytics: the reference's formulas, approximation included
    # ------------------------------------------------------------------

    @property
    def n_moe_layers(self) -> int:
        """Layers with the MoE block: all but the ``first_k_dense`` leading
        ones of an MoE config."""
        return self.n_layers - self.first_k_dense if self.family == "moe" else 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + stacked blocks), the
        reference's formula: it leaves out norms, the hybrid's LoRA and the
        xlstm's gates, so it is not the size of ``init_model``'s tree. An
        MoE config's leading dense layers count as dense layers of width
        ``dense_d_ff``."""
        D, H, KV, hd, F, V, L = (self.d_model, self.n_heads, self.n_kv,
                                 self.hd, self.d_ff, self.vocab, self.n_layers)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        width = 3 if self.act == "swiglu" else 2
        mlp = width * D * F
        if self.family == "moe":
            mlp = (self.n_experts + self.n_shared_experts) * mlp + D * self.n_experts
        if self.family == "ssm":
            di = self.ssm_expand * D
            per_layer = 2 * (D * di) + di * D
        elif self.family == "hybrid":
            di = self.ssm_expand * D
            nh = di // self.ssm_headdim
            per_layer = D * (2 * di + 2 * self.ssm_state + nh) + di * D
        else:
            per_layer = attn + mlp
        total = L * per_layer + V * D * (1 if self.tie_embeddings else 2)
        if self.family == "moe" and self.first_k_dense:
            total += self.first_k_dense * (width * D * self.dense_d_ff - mlp)
        if self.is_encdec:
            total += self.n_enc_layers * (attn + mlp)
        if self.attn_every:
            total += attn + 3 * D * self.d_ff  # one shared attn+mlp block
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE layers count topk + shared experts."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        mlp_all = (self.n_experts + self.n_shared_experts) * 3 * D * F
        mlp_act = (self.topk + self.n_shared_experts) * 3 * D * F
        return int(self.param_count() - self.n_moe_layers * (mlp_all - mlp_act))
