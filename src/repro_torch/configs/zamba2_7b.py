"""zamba2-7b — hybrid Mamba2 + shared attention blocks (arXiv:2411.15242).

81L d_model=3584 32H (kv=32) d_ff=14336 ssm_state=64. One shared
transformer block (attention + MLP, a single weight set) applied every 6
mamba layers, with a LoRA adapter on W_q per application (13 applications,
then 3 tail mamba layers).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256, attn_every=6,
    act="swiglu", rope_kind="rope", sub_quadratic=True,
)
