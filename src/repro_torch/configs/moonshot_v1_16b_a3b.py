"""moonshot-v1-16b-a3b — Moonlight-style MoE (hf:moonshotai/Moonlight-16B-A3B).

48L d_model=2048 16H (kv=16, MHA) d_ff=1408/expert vocab=163840,
64 routed experts top-6 + 2 shared (deepseek-v3 lineage).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    n_experts=64, n_shared_experts=2, topk=6,
    act="swiglu", rope_kind="rope",
)
