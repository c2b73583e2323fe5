"""Mixture-of-Experts (the moonshot and deepseek-moe archs) on one card: the
port of ``repro.models.moe``.

The reference bins tokens into fixed-capacity (E, C, D) expert buffers by a
sort-free cumsum and runs the expert MLPs as batched products over them.
Here the dispatch decision is the reference's, computed exactly: the
router's f32 scores, top-k (the lower expert index first among equal
scores, as ``jax.lax.top_k``), a softmax over the selected gates in f32,
each (token, k) slot's queue position in its expert as a cumsum over the
flat (token, k) order, and the keep mask ``pos < capacity``. A config
with ``norm_topk_prob`` false (deepseek-moe-16b as published) gates by the
softmax over all E experts in f32 at the selected ids instead, not
renormalised; the selection still ranks the f32 scores, which orders the
experts as their probabilities do but where two probabilities round
equal. The expert
MLPs then run on the (token, k) pairs, grouped by expert, and a dropped
pair's output is discarded: a kept slot's value in the reference depends
only on its token, so the function is the same and the mostly empty
buffers are never built.

Capacity, three modes (``apply_moe``):

  * ``active`` (decode): idle slots are masked out of the cumsum and the
    capacity is T, so no active token is dropped;
  * ``row_isolated`` (fused, chunked and suffix prefill, verify): each batch
    row is binned against its own capacity S, so a request routes as it
    would alone;
  * neither (``Engine.embed``'s forward, training): one shared capacity
    ``ceil(T * topk / E * capacity_factor)``, Switch-style, over which
    slots are dropped.

A row's bits must not depend on its batchmates: the serving engine's
batch invariance, and a prefill row keeping the bits of the decode step at
its position. cuBLAS picks its kernel, and with it the order of a row's
sums, by the call's shape. So both float contractions have one call shape
for every caller: the router's ``x @ router`` runs ROUTER_ROWS rows at a
time, zero-padded, and the expert products run as batched products of
exactly (E, EXPERT_ROWS, D) (pass i takes rows i * EXPERT_ROWS onward of
every expert's queue). Expert weights are int8 ``QTensor``s on the serving
path: dequantized per layer and forward (``q * scale`` in f32, then the
compute dtype, as the reference dequantizes them) and contracted in the
compute dtype; the shared experts go through ``layers.apply_mlp`` and
therefore through qgemm.

Spans (``repro_torch.tracing``, recorded only while it is on), inside the
serving forwards' ``fwd.moe`` (models/model.py ``ffn``): ``moe.route``
(router, top-k, gates, dispatch), ``moe.experts`` (dequantization and the
expert passes; attributes ``pairs``, the (token, k) pairs, ``passes``, the
batched passes, and ``host_reads``, the values the block read back to the
host: the sizing of ``torch.bincount`` and, above EXPERT_ROWS tokens, the
longest queue; on a card each one waits for the device) and
``moe.shared``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.models import layers as L

# rows per router call and per expert in each batched expert product: every
# call of every caller has exactly these shapes (module doc)
ROUTER_ROWS = 64
EXPERT_ROWS = 32


def init_moe(gen: torch.Generator, cfg: ArchConfig, d: int, device=None) -> Dict:
    """MoE params in draw order: ``router`` (D, E), the routed experts'
    SwiGLU ``wi``, ``wg`` (E, D, F) and ``wo`` (E, F, D), LeCun-normal over
    their contraction axis, and the shared experts' MLP of width
    ``n_shared_experts * d_ff``."""
    E, F = cfg.n_experts, cfg.d_ff
    p = {
        "router": L.dense_init(gen, (d, E), device=device),
        "wi": L.dense_init(gen, (E, d, F), in_axis=1, device=device),
        "wg": L.dense_init(gen, (E, d, F), in_axis=1, device=device),
        "wo": L.dense_init(gen, (E, F, d), in_axis=1, device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg, d, cfg.n_shared_experts * F, device=device)
    return p


def moe_specs(cfg: ArchConfig) -> Dict:
    """Partition specs of :func:`init_moe`'s leaves: experts over model (EP)."""
    p = {"router": (None, None), "wi": ("model", None, None),
         "wg": ("model", None, None), "wo": ("model", None, None)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_specs(cfg)
    return p


def router_scores(router, x: torch.Tensor) -> torch.Tensor:
    """f32 scores (T, E) of tokens x (T, D): ``x.f32 @ router`` in calls of
    exactly ROUTER_ROWS rows, the last zero-padded (module doc)."""
    w = router.dequantize() if isinstance(router, tz.QTensor) else router
    return L.matmul_fixed_rows(x.to(torch.float32), w.to(torch.float32), ROUTER_ROWS)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of f32 ``scores``: the k largest
    values in descending order of IEEE total order (-0.0 below +0.0), the
    lower index first among equal values. A stable descending sort of the
    values' order-preserving int32 keys; ``torch.topk`` promises no order
    for ties on CUDA. Returns (values, indices)."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return scores.gather(-1, idx), idx


def dispatch(scores: torch.Tensor, topk: int, capacity: int,
             token_valid: Optional[torch.Tensor] = None,
             norm_topk_prob: bool = True) -> Tuple[torch.Tensor, ...]:
    """The reference's dispatch decision for groups of tokens binned
    separately: ``scores`` (G, N, E) f32 -> ``(ids, gate, keep)``, each
    (G, N, topk): the selected experts, their gates (f32) and whether the
    slot fits its expert's ``capacity``. The gates are the softmax over the
    k selected scores with ``norm_topk_prob`` (renormalised to sum to 1),
    else the softmax over all E scores at the selected ids. A slot's
    queue position is the cumsum of its expert's slots over the group's
    flat (token, k) order; ``token_valid`` (G, N) bool takes tokens out of
    the cumsum altogether (they are never kept)."""
    G, N, E = scores.shape
    gate, ids = top_k(scores, topk)
    if norm_topk_prob:
        gate = torch.softmax(gate.to(torch.float32), dim=-1)
    else:
        gate = torch.softmax(scores.to(torch.float32), dim=-1).gather(-1, ids)
    flat = ids.reshape(G, N * topk)
    if token_valid is None:
        valid = torch.ones_like(flat, dtype=torch.bool)
    else:
        valid = token_valid.repeat_interleave(topk, dim=1)
    oh = torch.nn.functional.one_hot(torch.where(valid, flat, E), E + 1)[..., :E]
    pos = (torch.cumsum(oh, dim=1) * oh).sum(dim=-1) - 1
    keep = valid & (pos >= 0) & (pos < capacity)
    return ids, gate, keep.reshape(G, N, topk)


def _dequant(w, dtype: torch.dtype) -> torch.Tensor:
    """An expert weight in the compute dtype: a ``QTensor``'s ``q * scale``
    in f32, rounded once to ``dtype`` on the store (one pass, no f32
    copy); a float weight cast."""
    if not isinstance(w, tz.QTensor):
        return w.to(dtype)
    out = torch.empty(w.q.shape, dtype=dtype, device=w.q.device)
    return torch.mul(w.q, w.scale, out=out)


def expert_outputs(p: Dict, x: torch.Tensor, experts: torch.Tensor, n_tokens: int,
                   cfg: ArchConfig) -> torch.Tensor:
    """The routed expert MLP ``wo(silu(x @ wi) * (x @ wg))`` of each pair:
    row n of ``x`` (P, D) through expert ``experts[n]``, in the compute
    dtype, as batched products of exactly (E, EXPERT_ROWS, D): pass i
    carries rows i * EXPERT_ROWS onward of each expert's queue, zero rows
    elsewhere. ``n_tokens`` bounds any expert's queue (a token picks an
    expert at most once), so the passes need no host read at or below
    EXPERT_ROWS tokens. On meta tensors (the dry run) the queues are a
    balanced router's, ``ceil(P / E)`` each. Returns (P, D), under the
    ``moe.experts`` span (module doc)."""
    E, R = cfg.n_experts, EXPERT_ROWS
    P, D = x.shape
    with tracing.span("moe.experts") as sp:
        reads = 0
        if x.is_meta:
            # the dry run has no routing to read: a balanced router's queues
            counts = experts.new_zeros((E,))
            longest = -(-P // E)
        else:
            # sizes its output from the largest id, read on the host
            counts = torch.bincount(experts, minlength=E)
            reads += 1
        order = torch.argsort(experts, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(P, device=x.device) - (torch.cumsum(counts, 0) - counts)[
            experts[order]]
        if n_tokens <= R:
            n_pass = 1
        else:
            if not x.is_meta:
                longest = int(counts.max())
                reads += 1
            n_pass = -(-longest // R)
        step, slot = rank // R, rank % R
        xb = x.new_zeros((n_pass, E, R, D))
        xb[step, experts, slot] = x
        wi, wg, wo = (_dequant(p[n], x.dtype) for n in ("wi", "wg", "wo"))
        yb = torch.empty_like(xb)
        for i in range(n_pass):
            h = L.silu(torch.bmm(xb[i], wi)) * torch.bmm(xb[i], wg)
            yb[i] = torch.bmm(h, wo)
        sp.note(pairs=P, passes=n_pass, host_reads=reads)
        return yb[step, experts, slot]


def combine(out: torch.Tensor, gate: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's gated sum: ``out`` (T, k, D) the expert outputs of its k
    slots, ``gate`` (T, k) f32, ``keep`` (T, k). A slot contributes
    ``out * gate`` rounded to out's dtype (nothing where dropped), and the k
    contributions are added to zero in slot order in that dtype: the
    reference's scatter-add, whose order the sum's roundings depend on."""
    w = (keep * gate).to(out.dtype)
    slots = out * w[..., None]
    slots = torch.where(keep[..., None], slots, torch.zeros_like(slots))
    y = torch.zeros_like(slots[:, 0])
    for j in range(slots.shape[1]):
        y = y + slots[:, j]
    return y


def apply_moe(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
              active: Optional[torch.Tensor] = None,
              row_isolated: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> ``(y, aux)``: the routed experts' gated sum plus the
    shared experts, and the Switch load-balance loss
    ``E * sum_e f_e * mean_p_e`` (f32 scalar).

    ``active`` (B,) bool (decode): idle rows leave the capacity cumsum and
    the capacity is T. ``row_isolated`` (prefill, verify): each row binned
    against capacity S. Neither: the shared, dropping capacity. Each
    token's k contributions ``expert_out * gate`` (rounded to the compute
    dtype) are added to zero in slot order, in the compute dtype: the
    order of the reference's scatter-add. Dropped slots add nothing. The
    gates are ``dispatch``'s under ``cfg.norm_topk_prob``."""
    B, S, D = x.shape
    E, topk = cfg.n_experts, cfg.topk
    T = B * S
    xf = x.reshape(T, D)
    with tracing.span("moe.route"):
        scores = router_scores(p["router"], xf)
        if row_isolated:
            ids, gate, keep = dispatch(scores.reshape(B, S, E), topk, max(topk, S),
                                       norm_topk_prob=cfg.norm_topk_prob)
        else:
            valid = None
            if active is not None:
                valid = active.to(torch.bool)[:, None].expand(B, S).reshape(1, T)
                capacity = max(topk, T)
            else:
                capacity = max(topk, math.ceil(T * topk / E * cfg.capacity_factor))
            ids, gate, keep = dispatch(scores[None], topk, capacity, valid,
                                       norm_topk_prob=cfg.norm_topk_prob)
        ids, gate, keep = (t.reshape(T, topk) for t in (ids, gate, keep))
    out = expert_outputs(p, xf.repeat_interleave(topk, dim=0), ids.reshape(-1), T, cfg)
    y = combine(out.reshape(T, topk, D), gate, keep)
    probs = torch.softmax(scores, dim=-1)
    f = torch.nn.functional.one_hot(ids, E).sum(dim=1).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        with tracing.span("moe.shared"):
            y = y + L.apply_mlp(p["shared"], x, cfg)
    return y, aux
