"""starcoder2-15b — dense GQA code model (arXiv:2402.19173).

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, GeLU MLP,
LayerNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, d_ff=24576, vocab=49152,
    act="gelu", norm="layernorm", rope_kind="rope",
)
