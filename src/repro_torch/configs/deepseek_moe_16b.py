"""deepseek-moe-16b — fine-grained MoE (arXiv:2401.06066).

28L d_model=2048 16H (kv=16) d_ff=1408/expert vocab=102400,
2 shared + 64 routed experts, top-6.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, topk=6,
    act="swiglu", rope_kind="rope",
)
