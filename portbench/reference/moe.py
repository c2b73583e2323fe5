"""The plain reference of the DeepSeek-MoE decoder configurations
(arXiv:2401.06066; Hugging Face ``DeepseekForCausalLM``), in f32 plain
PyTorch with TF32 off, one layer at a time.

A layer is attention (``decoder.py``'s: grouped KV heads, optional
qk_norm, RoPE, K and V rounded to bf16) and then, in the first
``first_k_dense_replace`` layers, ``decoder.py``'s SwiGLU MLP of width
``intermediate_size``; in every other layer, on the normed input x:

* router logits ``x @ router`` in f32;
* a softmax over all E routed experts;
* the k experts of largest probability (the lower index first on ties);
* their gates: the probabilities as they are where ``norm_topk_prob`` is
  false, divided by their sum over the k where it is true;
* each token through each of its k experts' SwiGLU ``wo(silu(x @ wi) *
  (x @ wg))``, weighted by its gate and summed;
* the shared experts' MLP (width ``n_shared * moe_intermediate_size``)
  added ungated.

No capacity and no dropping: the serving modes drop nothing
(``repro_torch/models/moe.py`` doc).

The quantization is the one the configuration states, worked out here from
the float weights as ``decoder.py`` works it out: int-``bits`` weights per
output channel for every projection (attention, the dense and shared MLPs,
the routed experts per expert and channel, the output head), ``bits`` 8
for the configuration and 4 for the control. The router's weights stay f32,
as the port's serve path keeps them.

Departures from the published model, shared with the program: random
weights (``portbench/weights.py``), unit norm scales, and W8A8 in place of
bf16 weights. Points where this reference's arithmetic differs from the
program's recipe, within rounding of the same function:

* the routed experts: here f32 activations times the dequantized int8
  weights in f32; the program rounds the dequantized weights and the
  activations to bf16, contracts in bf16, rounds each gated output to bf16
  and adds the k in bf16;
* top-k: here over the f32 probabilities; the program ranks the f32 router
  logits (the same order but where two probabilities round equal);
* the gates: the program takes a softmax over the k selected logits, which
  is the renormalised case; the unrenormalised case is the published one;
* the residual stream, attention and norms: f32 here, bf16 in the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench import weights as W
from portbench.model import Model
from portbench.reference import decoder as D


def _attention(m: Model, xs: List[torch.Tensor], q: Dict) -> List[torch.Tensor]:
    """``decoder.py``'s attention block with its residual, per sequence."""
    H, KV, hd = m.n_heads, m.n_kv, m.head_dim
    out = []
    for x in xs:
        S = x.shape[0]
        h = D.rmsnorm(x, m.rms_norm_eps)
        qh = D.qlinear(h, *q["attn.wq"]).reshape(S, H, hd)
        kh = D.qlinear(h, *q["attn.wk"]).reshape(S, KV, hd)
        vh = D.qlinear(h, *q["attn.wv"]).reshape(S, KV, hd)
        if m.qk_norm:
            qh, kh = D.rmsnorm(qh, m.rms_norm_eps), D.rmsnorm(kh, m.rms_norm_eps)
        qh, kh = D.rope(qh, m.rope_theta), D.rope(kh, m.rope_theta)
        kh = kh.to(torch.bfloat16).to(torch.float32)
        vh = vh.to(torch.bfloat16).to(torch.float32)
        out.append(x + D.qlinear(D.attention(qh, kh, vh), *q["attn.wo"]))
    return out


def route(m: Model, x: torch.Tensor, router: torch.Tensor):
    """(experts, gates), each (T, k): the k experts of largest softmax
    probability for each row of x (T, D), the lower index first on ties,
    and their gates, renormalised over the k where ``norm_topk_prob``."""
    probs = torch.softmax(x @ router, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, : m.topk]
    gates = probs.gather(1, order)
    if m.norm_topk_prob:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return order, gates


def moe_block(m: Model, x: torch.Tensor, leaves: Dict[str, torch.Tensor], q: Dict,
              bits: int) -> torch.Tensor:
    """The MoE block of normed rows x (T, D): the routed experts' gated sum
    plus the shared experts' MLP."""
    experts, gates = route(m, x, leaves["moe.router"])
    y = torch.zeros_like(x)
    wi, wg, wo = (D.quantize_weight(leaves[f"moe.{n}"], bits) for n in ("wi", "wg", "wo"))
    for e in torch.unique(experts).tolist():
        rows, slot = (experts == e).nonzero(as_tuple=True)
        xe = x[rows]
        h = torch.nn.functional.silu(xe @ (wi[0][e] * wi[1][e])) * (xe @ (wg[0][e] * wg[1][e]))
        y.index_add_(0, rows, (h @ (wo[0][e] * wo[1][e])) * gates[rows, slot, None])
    if m.n_shared:
        y = y + D._mlp(x, q, "moe.shared.")
    return y


def _moe_layer(m: Model, xs: List[torch.Tensor], leaves: Dict[str, torch.Tensor],
               bits: int) -> List[torch.Tensor]:
    q = D._quantized({k: v for k, v in leaves.items()
                      if k.startswith("attn.") or k.startswith("moe.shared.")}, bits)
    xs = _attention(m, xs, q)
    flat = torch.cat(xs)
    y = moe_block(m, D.rmsnorm(flat, m.rms_norm_eps), leaves, q, bits)
    return list((flat + y).split([x.shape[0] for x in xs]))


@torch.no_grad()
def logits(m: Model, seed: int, seqs: Sequence[torch.Tensor], scored: Sequence[int],
           bits: int, device) -> List[torch.Tensor]:
    """The f32 logits (n_i, vocab) at the last ``scored[i]`` positions of
    each token sequence ``seqs[i]`` (int64, on ``device``), every sequence
    attending causally from its first position. Weights are made one layer
    at a time from ``seed``."""
    D._no_tf32()
    emb = W.embedding(m, seed, device)
    xs = [emb[s] for s in seqs]
    del emb
    for i in range(m.n_layers):
        leaves = W.layer(m, seed, i, device)
        layer = _moe_layer if m.is_moe_layer(i) else D._layer
        xs = layer(m, xs, leaves, bits)
        del leaves
    head = D.quantize_weight(W.lm_head(m, seed, device), bits)
    return [D.qlinear(D.rmsnorm(x[x.shape[0] - n:], m.rms_norm_eps), *head)
            for x, n in zip(xs, scored)]
