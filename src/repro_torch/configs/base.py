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
