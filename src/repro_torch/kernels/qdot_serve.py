"""Int8-weight GEMV: the CUDA kernel ``csrc/qgemv.cu`` and its plain version.

Replaces ``repro/kernels/qdot_serve.py::qgemv``, the weight-only product of
a decode-shaped batch. Contract::

    qgemv(x, w_q, scale)[b, n] = (sum_k x[b, k] * float(w_q[k, n])) * scale[n]

``x`` is (B, K) f32 with B >= 1, ``w_q`` (K, N) int8 with N a multiple of
256 (the Pallas wrapper's assert), ``scale`` (N,) f32. The sum is finished
before the scale is applied; the order of its additions is the kernel's
own, so the kernel and the plain version agree within f32 rounding.

On the card, chunks of 4 or 8 rows of x go through the tensor cores in
exact TF32 parts and chunks of 1 or 2 through the CUDA cores; K is split
across the CTAs of a thread-block cluster, whose partial sums are added in
rank order inside the cluster, in one launch (the source's notes say more).
:func:`plan` picks the row chunk, the stripe width, the cluster size and the
loads in flight on the CUDA cores from the shape and the SM count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import accounting
from repro_torch.kernels import _build

BN = 256        # N must be a multiple of this (the Pallas kernel's stripe)
KS = 64         # k rows of one stage: a CTA's k range is whole stages
STRIPES = (128, 64, 32)   # columns per CTA, widest first (the CUDA cores take the first two)
CLUSTERS = (1, 2, 4, 8)   # CTAs per cluster along K (8: the portable maximum)
RING = 4        # tensor cores: ring stages, the kernel's RING (it takes no other)
CORES_DEPTH = (4, 8)    # CUDA cores: loads in flight per lane, with more than
                        # BLOCKS_PER_SM CTAs per SM and with at most that many
BLOCKS_PER_SM = 2   # the plan widens the cluster until the grid holds this many per SM


class Plan(NamedTuple):
    rb: int         # rows of x per grid row: 1 or 2 (CUDA cores), 4 or 8 (tensor cores)
    tn: int         # columns per CTA
    cluster: int    # CTAs along K per stripe, reduced inside the cluster
    kchunk: int     # the longest k range of one CTA, whole stages
    depth: int      # ring stages (tensor cores: RING) or loads in flight per lane (CUDA cores)

    @property
    def mma(self) -> bool:
        """Whether the rows go through the tensor cores."""
        return self.rb > 2

    def ctas(self, B: int, N: int) -> int:
        return (N // self.tn) * self.cluster * -(-B // self.rb)

    def k_range(self, rank: int, K: int) -> range:
        """The k that cluster rank ``rank`` sums, as the kernel cuts them:
        stages ``[rank * S // C, (rank + 1) * S // C)`` of the ``S`` of K."""
        steps = -(-K // KS)
        return range(rank * steps // self.cluster * KS,
                     min(K, (rank + 1) * steps // self.cluster * KS))


def qgemv_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the f32 product, then the scale."""
    return (x @ w_q.to(torch.float32)) * scale[None, :]


@functools.lru_cache(maxsize=1024)
def plan(B: int, K: int, N: int, sms: int) -> Plan:
    """The kernel's launch plan. Rows of x in chunks of the least power of
    two that holds B, up to 8: chunks of 1 or 2 on the CUDA cores, 4 or 8 on
    the tensor cores. For each stripe width the kernel takes (128 or 64 on
    the CUDA cores), the smallest cluster whose grid reaches
    ``BLOCKS_PER_SM`` CTAs per SM, at most 8 and at most as many as K has
    stages where that is fewer (rounded up to a cluster size the kernel
    takes); the widest stripe whose grid then fills every SM, else the one
    with the most CTAs. On the CUDA cores, 8 loads in flight per lane where
    the grid has at most ``BLOCKS_PER_SM`` CTAs per SM, else 4. The ranks take whole
    stages in rank order, as evenly as they divide (:meth:`Plan.k_range`);
    a rank with none (only where K has fewer stages than the cluster ranks)
    adds zeros. Cached: a caller asks for few shapes."""
    rb = 1 if B == 1 else 2 if B == 2 else 4 if B <= 4 else 8
    chunks = -(-B // rb)
    steps = -(-K // KS)
    plans = []
    for tn in STRIPES if rb > 2 else STRIPES[:2]:
        want = -(-BLOCKS_PER_SM * sms // ((N // tn) * chunks))
        cluster = next((c for c in CLUSTERS if c >= min(want, steps)), CLUSTERS[-1])
        plans.append(Plan(rb, tn, cluster, -(-steps // cluster) * KS,
                          RING if rb > 2 else CORES_DEPTH[0]))
    full = [p for p in plans if p.ctas(B, N) >= sms]
    p = full[0] if full else max(plans, key=lambda p: p.ctas(B, N))
    if not p.mma and p.ctas(B, N) <= BLOCKS_PER_SM * sms:
        p = p._replace(depth=CORES_DEPTH[1])
    return p


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, w_q, scale) -> None:
    for name, t, dt in (("x", x, torch.float32), ("w_q", w_q, torch.int8),
                        ("scale", scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"qgemv: {name} must be {dt}, got {t.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"qgemv: expected x (B,K), w_q (K,N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, {tuple(scale.shape)}")
    B, K = x.shape
    K2, N = w_q.shape
    if K != K2 or scale.shape[0] != N or min(B, K, N) < 1:
        raise ValueError(f"qgemv: shape mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} with scale {tuple(scale.shape)}")
    if N % BN:
        raise ValueError(f"qgemv: N = {N} must be a multiple of {BN}")
    if w_q.device != x.device or scale.device != x.device:
        raise ValueError("qgemv: all operands must be on one device")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qgemv: operands must be contiguous")


def qgemv(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream; meta tensors launch nothing
    (the call is recorded with the accounting context either way)."""
    _check(x, w_q, scale)
    B, K = x.shape
    N = w_q.shape[1]
    nbytes = sum(accounting.tensor_bytes(t) for t in (x, w_q, scale)) + 4 * B * N
    with accounting.kernel("qgemv", 2 * B * K * N, nbytes):
        if x.device.type == "cpu":
            return qgemv_plain(x, w_q, scale)
        if x.device.type == "meta":
            return torch.empty((B, N), dtype=torch.float32, device=x.device)
        if x.device.type != "cuda":
            raise ValueError(f"qgemv: unsupported device {x.device}")
        if w_q.data_ptr() % 4:
            raise ValueError("qgemv: w_q must be 4-byte aligned")
        p = plan(B, K, N, _sm_count(x.device.index))
        out = torch.empty((B, N), dtype=torch.float32, device=x.device)
        lib = _build.library("qgemv")
        err = lib.qgemv_launch(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), B, K, N,
            p.rb, p.tn, p.cluster, p.depth,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "qgemv")
        qgemv.launches += 1
        return out


qgemv.launches = 0
