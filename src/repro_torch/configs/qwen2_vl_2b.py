"""qwen2-vl-2b — VLM transformer backbone with M-RoPE (arXiv:2409.12191).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision
frontend is a stub: the input is precomputed patch embeddings and 3D
(t, h, w) position ids; mrope_sections=(16, 24, 24) split the 64 rotary
half-dims of head_dim 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960, vocab=151936,
    head_dim=128, rope_kind="mrope", mrope_sections=(16, 24, 24),
    act="swiglu", input_mode="embeds", shard_heads=False,
)
