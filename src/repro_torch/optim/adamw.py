"""Decoupled AdamW with global-norm clipping: the port of
``repro.optim.adamw`` on one card.

The update runs in place under ``torch.no_grad()``: each parameter and its
two f32 moments are rewritten where they lie, the counterpart of the
reference's donated buffers (``donate_argnums=(0, 1)`` in its train CLI),
so no second copy of the 12 bytes a parameter is ever held. All math is in
f32, operation by operation in the reference's order, so each result
rounds as the reference's does."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d: updates taken
    mu: dict                    # first moments, f32, the params' tree
    nu: dict                    # second moments, f32


def adamw_init(params) -> AdamWState:
    leaves = T.leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=T.tree_map(zeros, params), nu=T.tree_map(zeros, params))


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped, norm)``: every leaf times ``min(1, max_norm / norm)``,
    the norm the sqrt of the per-leaf f32 sums of squares added in the
    reference's leaf order. The reference's ``g * scale`` promotes a bf16
    leaf to f32, so the clipped leaves are f32 values of the given ones."""
    total = 0
    for g in T.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gn = torch.sqrt(total)
    # a tensor over a tensor: one rounded division, as the reference's
    # (a scalar over a tensor is a reciprocal, then a product)
    scale = torch.clamp(torch.div(gn.new_tensor(max_norm), torch.clamp_min(gn, 1e-9)),
                        max=1.0)
    return T.tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[dict, AdamWState]:
    """One AdamW step, in place: returns ``(params, state)``, the same
    param and moment tensors rewritten and the step counter advanced.
    Decoupled weight decay on every leaf with ``ndim >= 2``, as the
    reference decides it: that takes in the stacked (L, D) norm scales."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    flat_p, spec = T.flatten(params)
    flat_g, flat_m, flat_v = (T.leaves(x) for x in (grads, state.mu, state.nu))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in their leaves")
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            gf = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            delta = torch.div(m, bc1)
            delta.div_(torch.div(v, bc2).sqrt_().add_(eps))
            pf = p.to(torch.float32)            # p itself when f32
            if p.ndim >= 2:
                delta.add_(weight_decay * pf)
            pf.sub_(delta.mul_(lr))
            if pf is not p:
                p.copy_(pf)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
