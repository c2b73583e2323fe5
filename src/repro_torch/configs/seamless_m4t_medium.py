"""seamless-m4t-medium — encoder-decoder multimodal backbone (arXiv:2308.11596).

12L encoder + 12L decoder, d_model=1024, 16H (kv=16), d_ff=4096,
vocab=256206 (padded to 256208). The audio frontend is a stub: the encoder
reads precomputed frame embeddings (B, S/4, D); the decoder reads text
tokens and cross-attends the encoder's output.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=256206,
    act="gelu", norm="layernorm", rope_kind="rope",
    input_mode="embeds", enc_len_ratio=4,
)
