"""A configuration file's sizes, read once.

The files under ``configs/`` use the published ``config.json`` keys of the
model (Hugging Face names), holding the values as they are run. ``Model``
is the few numbers the work formulas, the weights and the reference need.

Two layer families are modelled: the dense decoder (attention with grouped
KV heads, optional qk_norm, a SwiGLU MLP) and the DeepSeek-MoE decoder
(arXiv:2401.06066), whose layers after ``first_k_dense_replace`` leading
dense ones replace the MLP by a softmax router over ``n_routed_experts``
SwiGLU experts, ``num_experts_per_tok`` of them per token, plus
``n_shared_experts`` always-on experts run as one MLP. A key that would
change these equations and is not modelled here is refused by name
(``UNMODELLED``), so a configuration cannot be measured against the wrong
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# key -> the values under which the layer is still the one modelled here
# (absent or null always is)
UNMODELLED = {
    "kv_lora_rank": (),                 # latent attention (MLA)
    "q_lora_rank": (),
    "topk_method": ("greedy",),
    "n_group": (1,),                    # grouped routing
    "topk_group": (1,),
    "routed_scaling_factor": (1, 1.0),
    "scoring_func": ("softmax",),
    "moe_layer_freq": (1,),
}


@dataclasses.dataclass(frozen=True)
class Model:
    family: str               # dense | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    vocab: int
    d_ff: int = 0             # the SwiGLU MLP's width (moe: the leading dense layers')
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    n_experts: int = 0        # routed experts of an MoE layer
    n_shared: int = 0         # shared experts, run as one MLP of n_shared * expert_ff
    topk: int = 0             # routed experts per token
    expert_ff: int = 0        # one expert's SwiGLU width
    first_k_dense: int = 0    # leading layers with the dense MLP
    norm_topk_prob: bool = False  # the k gates renormalised to sum to 1

    @classmethod
    def from_config(cls, c: Dict) -> "Model":
        for key, fine in UNMODELLED.items():
            if c.get(key) is not None and c[key] not in fine:
                raise ValueError(f"{key} = {c[key]!r} changes the layer equations and is not "
                                 f"modelled by the harness (allowed: absent, null or {fine})")
        heads = c["num_attention_heads"]
        moe = {}
        if c.get("n_routed_experts"):
            moe = dict(family="moe", n_experts=c["n_routed_experts"],
                       n_shared=c.get("n_shared_experts") or 0,
                       topk=c["num_experts_per_tok"], expert_ff=c["moe_intermediate_size"],
                       first_k_dense=c.get("first_k_dense_replace") or 0,
                       norm_topk_prob=bool(c.get("norm_topk_prob", False)))
        return cls(**{
            "family": "dense", "d_ff": c["intermediate_size"],
            "n_layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "n_heads": heads, "n_kv": c["num_key_value_heads"],
            "head_dim": c.get("head_dim") or c["hidden_size"] // heads,
            "vocab": c["vocab_size"], "qk_norm": bool(c.get("qk_norm", False)),
            "rope_theta": float(c["rope_theta"]), "rms_norm_eps": float(c["rms_norm_eps"]),
            **moe})

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` routes over experts (else it has the dense MLP)."""
        return self.family == "moe" and i >= self.first_k_dense

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense if self.family == "moe" else 0
