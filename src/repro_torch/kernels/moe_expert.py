"""The routed experts of an MoE layer over int8 weights: the CUDA kernel
pair ``csrc/moe_expert.cu``, its queues and its launch plan.

Replaces no TPU kernel: the JAX package contracts the experts through XLA.
The pair takes the (token, k) pairs of one MoE layer sorted by expert
(:func:`queues`): slot r of expert e's queue, ``offsets[e] <= r <
offsets[e] + counts[e]``. Contract::

    moe_expert_swiglu(x, rows, offsets, counts, wi, si, wg, sg)[r]
      = silu(x[rows[r]] @ W(wi, si)[e]) * (x[rows[r]] @ W(wg, sg)[e])
    moe_expert_down(h, pairs, offsets, counts, wo, so, n_tokens)[pairs[r]]
      = h[r] @ W(wo, so)[e]

with ``W(q, s) = (q * s in f32).to(bf16)`` (``models/moe.py::_dequant``),
every product in bf16 with f32 sums rounded to bf16, and ``silu`` op by op
in bf16 as ``models/layers.py::silu``. ``x`` (T, D) and ``h`` (P, F) are
bf16, ``rows`` and ``pairs`` (P,) int32, ``offsets`` and ``counts`` (E,)
int32, the weights (E, D, F) or (E, F, D) int8 with scales (E, 1, N) f32
(a ``QTensor``'s). The results are (P, F) bf16 in slot order and (P, D)
bf16 in pair order. ``n_tokens``, the tokens behind the pairs (``x``'s
rows for the up-projection), bounds every queue.

On the card each kernel walks each expert's queue in M tiles of 16 rows
(at most ``DECODE_ROWS`` pairs an expert on average) or 64 in blocks side
by side (:func:`plan`), dequantizes the codes in the operand load and reads
each expert's count and offset on the device: no host read, and a grid
that depends on E, the width and ``n_tokens`` alone (the source's notes
say more). Every tile size runs the same reduction order, so a row's bits
do not depend on its batchmates.

The pair's plain version is the plain route of ``models/moe.py``
(``plain_experts``): CPU tensors take it there, and the card's checks hold
the pair to it bit for bit. The wrappers record each call with the
accounting context; on meta tensors they return an empty result and
launch nothing, and on any other device but a card they raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import accounting
from repro_torch.kernels import _build

DECODE_ROWS = 8     # mean pairs an expert up to which the kernels take 16-row M tiles
MAX_SLICES = 32     # blocks side by side over one expert's M tiles, at most
ALIGN = 16          # D and F multiples of this; activations and codes 16-byte aligned


def queues(experts: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, ...]:
    """The kernels' queues of the pairs' experts ``experts`` (P,) int64:
    ``(counts, offsets, order)``, the pairs of each expert (E,) int32 (a
    ``scatter_add_``), their exclusive cumsum (E,) int32, and the pairs
    sorted by expert, stable (P,) int64. On the device, no host read."""
    counts = torch.zeros(n_experts, dtype=torch.int32, device=experts.device)
    counts.scatter_add_(0, experts, torch.ones_like(experts, dtype=torch.int32))
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return counts, offsets, torch.argsort(experts, stable=True)


def plan(pairs: int, n_tokens: int, n_experts: int) -> Tuple[int, int]:
    """The kernels' launch plan, ``(rows, slices)``. Where the queues hold
    at most ``DECODE_ROWS`` pairs an expert on average (decode): M tiles of
    16 rows in one slice, a block walking its expert's tiles in turn (a
    second tile is rare). Else M tiles of 64 rows, cut into ``slices``
    blocks side by side (block s takes tiles s, s + slices, ...): as many
    as the longest queue possible needs tiles (``n_tokens``: a token picks
    an expert at most once), at most ``MAX_SLICES``. The blocks of one
    expert and column tile run together, so its codes leave device memory
    once for all of them."""
    if pairs <= DECODE_ROWS * n_experts:
        return 16, 1
    return 64, max(1, min(-(-n_tokens // 64), MAX_SLICES))


def _check(name, a, index, offsets, counts, weights) -> None:
    """Raise on what the kernels do not take: ``a`` (rows, K) bf16,
    ``index`` (P,) int32, ``offsets``/``counts`` (E,) int32, and each
    (code, scale) pair (E, K, N) int8 with (E, 1, N) f32 of one shape."""
    if a.dtype != torch.bfloat16 or a.ndim != 2:
        raise TypeError(f"{name}: activations must be 2-D bf16, got {a.dtype} "
                        f"{tuple(a.shape)}")
    for what, t in (("index", index), ("offsets", offsets), ("counts", counts)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise TypeError(f"{name}: {what} must be 1-D int32, got {t.dtype} "
                            f"{tuple(t.shape)}")
    q0 = weights[0][0]
    for q, s in weights:
        if q.dtype != torch.int8:
            raise TypeError(f"{name}: expert codes must be int8, got {q.dtype}")
        if q.ndim != 3 or q.shape != q0.shape:
            raise ValueError(f"{name}: expert codes must be (E, K, N) alike, got "
                             f"{tuple(q.shape)}")
        if s.dtype != torch.float32 or tuple(s.shape) != (q.shape[0], 1, q.shape[2]):
            raise ValueError(f"{name}: scales {s.dtype} {tuple(s.shape)} do not match codes "
                             f"{tuple(q.shape)}: want f32 (E, 1, N)")
    E, K, N = q0.shape
    if a.shape[1] != K or offsets.shape[0] != E or counts.shape[0] != E:
        raise ValueError(f"{name}: activations {tuple(a.shape)}, offsets "
                         f"{tuple(offsets.shape)} and counts {tuple(counts.shape)} do not "
                         f"match codes {tuple(q0.shape)}")
    tensors = [a, index, offsets, counts] + [t for pair in weights for t in pair]
    if any(t.device != a.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if a.device.type == "cuda":
        if K % ALIGN or N % ALIGN:
            raise ValueError(f"{name}: K {K} and N {N} must be multiples of {ALIGN}")
        if any(t.data_ptr() % ALIGN for t in [a] + [q for q, _ in weights]):
            raise ValueError(f"{name}: activations and codes must be {ALIGN}-byte aligned")


def _device(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for {t.device} tensors (they take "
                         f"moe.expert_outputs' plain route)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_expert_swiglu(x, rows, offsets, counts, wi, si, wg, sg) -> torch.Tensor:
    """See module docstring. CUDA tensors launch the kernel on the current
    stream; meta tensors launch nothing; other devices raise."""
    _check("moe_expert_swiglu", x, rows, offsets, counts, ((wi, si), (wg, sg)))
    _device("moe_expert_swiglu", x)
    E, D, F = wi.shape
    P = rows.shape[0]
    nbytes = sum(accounting.tensor_bytes(t) for t in (wi, si, wg, sg, rows, offsets, counts))
    with accounting.kernel("moe_expert_swiglu", 4 * P * D * F, nbytes + 2 * P * (D + F)):
        h = torch.empty((P, F), dtype=torch.bfloat16, device=x.device)
        if x.device.type == "meta" or P == 0:
            return h
        err = _build.library("moe_expert").moe_expert_swiglu_launch(
            x.data_ptr(), rows.data_ptr(), wi.data_ptr(), si.data_ptr(), wg.data_ptr(),
            sg.data_ptr(), h.data_ptr(), offsets.data_ptr(), counts.data_ptr(), E, D, F,
            *plan(P, x.shape[0], E), _stream(x))
        _build.check(err, "moe_expert_swiglu")
        moe_expert_swiglu.launches += 1
        return h


moe_expert_swiglu.launches = 0


def moe_expert_down(h, pairs, offsets, counts, wo, so, n_tokens: int) -> torch.Tensor:
    """See module docstring. CUDA tensors launch the kernel on the current
    stream; meta tensors launch nothing; other devices raise."""
    _check("moe_expert_down", h, pairs, offsets, counts, ((wo, so),))
    E, F, D = wo.shape
    P = pairs.shape[0]
    if h.shape[0] != P:
        raise ValueError(f"moe_expert_down: h has {h.shape[0]} rows for {P} pairs")
    _device("moe_expert_down", h)
    nbytes = sum(accounting.tensor_bytes(t) for t in (wo, so, pairs, offsets, counts))
    with accounting.kernel("moe_expert_down", 2 * P * F * D, nbytes + 2 * P * (F + D)):
        out = torch.empty((P, D), dtype=torch.bfloat16, device=h.device)
        if h.device.type == "meta" or P == 0:
            return out
        err = _build.library("moe_expert").moe_expert_down_launch(
            h.data_ptr(), pairs.data_ptr(), wo.data_ptr(), so.data_ptr(), out.data_ptr(),
            offsets.data_ptr(), counts.data_ptr(), E, F, D, *plan(P, n_tokens, E), _stream(h))
        _build.check(err, "moe_expert_down")
        moe_expert_down.launches += 1
        return out


moe_expert_down.launches = 0
