"""Seeded float weights, made on the device, handed to both sides.

Every tensor is drawn from its own generator, seeded from (run seed,
layer, name), so the reference can make any one layer again on its own,
without replaying the draws before it. Shapes and distributions are the
LM's usual: projections LeCun-normal over their contraction axis, the
embedding N(0, 0.02^2), norm scales 1. The weights are f32 masters: the
program quantizes them on its own path, and the reference works out the
same quantization again from these floats.

Names follow the decoder's layer: attention, then a SwiGLU MLP (``mlp.*``)
or, in an MoE layer, the block of ``repro_torch.models.moe.init_moe``:
``moe.router`` (D, E), the routed experts ``moe.wi``, ``moe.wg`` (E, D, F)
and ``moe.wo`` (E, F, D), and the shared experts' MLP ``moe.shared.*`` of
width ``n_shared * F``.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from portbench.model import Model


def generator(seed: int, layer: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` whose state depends on (seed, layer, name)
    only."""
    digest = hashlib.sha256(f"{int(seed)}/{layer}/{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return g


def _lecun(seed: int, layer: int, name: str, shape, fan_in: int, device) -> torch.Tensor:
    g = generator(seed, layer, name, device)
    w = torch.randn(tuple(shape), generator=g, dtype=torch.float32, device=device)
    return w.mul_(fan_in ** -0.5)


def _mlp_shapes(prefix: str, D: int, F: int) -> Dict[str, tuple]:
    return {prefix + "wi": ((D, F), D), prefix + "wg": ((D, F), D), prefix + "wo": ((F, D), F)}


def layer_shapes(m: Model, i: int) -> Dict[str, tuple]:
    """Every random leaf of layer ``i``, by name: (shape, fan_in)."""
    D, H, KV, hd = m.d_model, m.n_heads, m.n_kv, m.head_dim
    shapes = {
        "attn.wq": ((D, H * hd), D),
        "attn.wk": ((D, KV * hd), D),
        "attn.wv": ((D, KV * hd), D),
        "attn.wo": ((H * hd, D), H * hd),
    }
    if not m.is_moe_layer(i):
        shapes.update(_mlp_shapes("mlp.", D, m.d_ff))
        return shapes
    E, F = m.n_experts, m.expert_ff
    shapes.update({
        "moe.router": ((D, E), D),
        "moe.wi": ((E, D, F), D),
        "moe.wg": ((E, D, F), D),
        "moe.wo": ((E, F, D), F),
    })
    if m.n_shared:
        shapes.update(_mlp_shapes("moe.shared.", D, m.n_shared * F))
    return shapes


def layer(m: Model, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s random leaves, f32, by name (norm scales are all ones
    and are not drawn)."""
    return {name: _lecun(seed, i, name, shape, fan_in, device)
            for name, (shape, fan_in) in layer_shapes(m, i).items()}


def embedding(m: Model, seed: int, device) -> torch.Tensor:
    """The token embedding (vocab, d_model), N(0, 0.02^2)."""
    g = generator(seed, -1, "embed", device)
    e = torch.randn((m.vocab, m.d_model), generator=g, dtype=torch.float32, device=device)
    return e.mul_(0.02)


def lm_head(m: Model, seed: int, device) -> torch.Tensor:
    """The output projection (d_model, vocab), LeCun-normal."""
    return _lecun(seed, -1, "lm_head", (m.d_model, m.vocab), m.d_model, device)
