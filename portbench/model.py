"""A configuration file's sizes, read once.

The files under ``configs/`` use the published ``config.json`` keys of the
model (Hugging Face names), holding the values as they are run. ``Model``
is the few numbers the work formulas, the weights and the reference need.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Model:
    family: str               # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    vocab: int
    d_ff: int = 0             # the SwiGLU MLP's width
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6

    @classmethod
    def from_config(cls, c: Dict) -> "Model":
        if c.get("n_routed_experts"):
            raise ValueError("no mixture-of-experts configuration is modelled here: "
                             "the reference and the work formulas are the dense decoder's")
        heads = c["num_attention_heads"]
        return cls(
            family="dense", d_ff=c["intermediate_size"], n_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], n_heads=heads, n_kv=c["num_key_value_heads"],
            head_dim=c.get("head_dim") or c["hidden_size"] // heads,
            vocab=c["vocab_size"], qk_norm=bool(c.get("qk_norm", False)),
            rope_theta=float(c["rope_theta"]), rms_norm_eps=float(c["rms_norm_eps"]))
