"""xlstm-125m — sLSTM + mLSTM blocks (arXiv:2405.04517).

12L (6 alternating mLSTM/sLSTM pairs) d_model=768 4H d_ff=0 vocab=50304.
The mLSTM's full-sequence form runs the chunked linear recurrence; the
sLSTM is a sequential scan. No FFN: each sLSTM block carries its own
up/down projection. The decode state is O(1) in the context.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    ssm_chunk=256, act="gelu", rope_kind="none", shard_heads=False,
    sub_quadratic=True,
)
