"""granite-20b — dense MQA code model, llama-arch (arXiv:2405.04324).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152, SwiGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576, vocab=49152,
    act="swiglu", rope_kind="rope",
)
