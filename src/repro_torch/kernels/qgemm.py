"""Int8 GEMMs: the CUDA kernels ``csrc/qgemm.cu`` and
``csrc/qgemm_tile_scales.cu``, each beside its plain version.

``qgemm`` replaces ``repro/kernels/qgemm.py::qgemm`` and, in the port, the XLA int8
``dot_general`` of ``models/layers.py::pdot``, which ``torch.matmul`` cannot
run on CUDA. Contract::

    qgemm(a_q, b_q, sb, sa=None, out_dtype=torch.float32)
      = (float(a_q @ b_q  accumulated in int32) * (sa[m] * sb[n])).to(out_dtype)

with the scale product taken first (pdot's order) and ``sa`` left out when
None, which makes ``sa=None`` with f32 output exactly the Pallas kernel's
function. ``a_q`` is (M, K) int8, ``b_q`` (K, N) int8 in its public layout,
``sb`` (N,) f32, ``sa`` (M,) f32. Ragged M, N and K are masked in the kernel;
the Pallas kernel asserted block alignment instead.

``qgemm_tile_scales`` replaces ``repro/kernels/qgemm.py::qgemm_tile_scales``,
the blocked product of tpuGemm's FullyConnected lowering::

    qgemm_tile_scales(a_q, b_q, sa, sb)[i-tile, j-tile]
      = sum over k tiles, in k order, of float(P_ikj) * (sa[i, k] * sb[k, j])

with ``P_ikj`` the exact int32 product of one 128-deep tile pair, one scale
per 128x128 tile of each operand (``sa`` (M/128, K/128), ``sb`` (K/128,
N/128) f32), M, N and K multiples of 128 as the Pallas wrapper asserted.
Each step rounds the scale product, the multiply and the add, in that order.

On the card both run on the int8 tensor cores. ``qgemm`` has two regimes,
which :func:`plan` picks from the shape: at M <= 16 (decode) the rows of A
are padded to one 16-row tile and the weight is streamed once through 128-,
64- or 32-column stripes; above that, 128x128, 128x64 or 64x64 output
tiles. In both, K is split across blocks until the grid holds about two
blocks per SM; the splits' int32 sums add exactly, so the result does not
depend on the plan. ``qgemm_tile_scales`` runs 64x128 or 64x64 sub-tiles of
its 128x128 scale tiles, K unsplit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_OUT_DTYPES = (torch.float32, torch.bfloat16)
TILE = 128
KSTEP = 32          # k depth of one pipeline stage: a split is whole stages
DECODE_M = 16       # M up to this takes the decode regime
BLOCKS_PER_SM = 2   # the plan splits K until the grid holds this many per SM

# Output tiles of the CUDA kernel, (config id, rows, columns), widest first:
# the ids are those of csrc/qgemm.cu's qgemm_launch.
DECODE_TILES = ((0, 16, 128), (1, 16, 64), (2, 16, 32))
LARGE_TILES = ((3, 128, 128), (4, 128, 64), (5, 64, 64))


class Plan(NamedTuple):
    config: int     # tile id passed to the kernel
    bm: int         # output tile rows
    bn: int         # output tile columns
    kchunk: int     # K range of one split, a multiple of KSTEP
    splits: int     # blocks along K per output tile

    def blocks(self, M: int, N: int) -> int:
        return -(-M // self.bm) * -(-N // self.bn) * self.splits


@functools.lru_cache(maxsize=1024)
def plan(M: int, K: int, N: int, sms: int) -> Plan:
    """The launch plan of ``qgemm``'s kernel. The regime comes from M: decode
    tiles at M <= ``DECODE_M``, else large tiles. For each tile, K is split
    in whole steps into at least as many ranges as the grid needs to hold
    ``BLOCKS_PER_SM`` blocks per SM, or into one range per step; a tile
    whose output tiles alone reach that runs unsplit. Decode takes the
    widest tile that reaches the target: wide stripes read the weight in
    long runs, and the splits' sums are only M rows. Large M takes the
    widest tile that reaches it unsplit, else the one that needs the fewest
    splits, since each split writes an M x N plane of sums. Where no tile
    reaches the target, the plan with the most blocks. Cached: a decode step
    asks for the same few shapes on every call."""
    tiles = DECODE_TILES if M <= DECODE_M else LARGE_TILES
    target = BLOCKS_PER_SM * sms
    steps = -(-K // KSTEP)
    plans = []
    for config, bm, bn in tiles:
        n_tiles = -(-M // bm) * -(-N // bn)
        per = max(1, steps // -(-target // n_tiles))     # K steps per split
        plans.append(Plan(config, bm, bn, per * KSTEP, -(-steps // per)))
    full = [p for p in plans if p.blocks(M, N) >= target]
    if not full:
        return max(plans, key=lambda p: p.blocks(M, N))
    if M <= DECODE_M:
        return full[0]
    return min(full, key=lambda p: p.splits)


def tile_scales_narrow(M: int, N: int, sms: int) -> bool:
    """Whether ``qgemm_tile_scales``' kernel takes 64x64 output sub-tiles:
    where its 64x128 ones are fewer than ``BLOCKS_PER_SM`` per SM. K is
    never split: that would reorder the f32 adds."""
    return (M // 64) * (N // 128) < BLOCKS_PER_SM * sms


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _i32_product(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 operands, as a float64 matmul cast back
    (CUDA has no integer matmul, and the CPU's is a few times slower than
    its float64 one): every partial sum is an integer of magnitude at most
    K * 127^2 < 2^53, so each is exact in any order."""
    return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int32)


def qgemm_plain(a_q: torch.Tensor, b_q: torch.Tensor, sb: torch.Tensor,
                sa: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the exact int32 product, then the epilogue."""
    acc = _i32_product(a_q, b_q)
    scale = sb if sa is None else sa[:, None] * sb[None, :]
    return (acc.to(torch.float32) * scale).to(out_dtype)


def _check(a_q, b_q, sb, sa, out_dtype) -> None:
    for name, t, dt in (("a_q", a_q, torch.int8), ("b_q", b_q, torch.int8),
                        ("sb", sb, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"qgemm: {name} must be {dt}, got {t.dtype}")
    if a_q.ndim != 2 or b_q.ndim != 2 or sb.ndim != 1:
        raise ValueError(f"qgemm: expected a_q (M,K), b_q (K,N), sb (N,); got "
                         f"{tuple(a_q.shape)}, {tuple(b_q.shape)}, {tuple(sb.shape)}")
    M, K = a_q.shape
    K2, N = b_q.shape
    if K != K2 or sb.shape[0] != N or min(M, N, K) < 1:
        raise ValueError(f"qgemm: shape mismatch {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)} with sb {tuple(sb.shape)}")
    if K * 127 * 127 >= 2 ** 31:
        raise ValueError(f"qgemm: contraction dim {K} would overflow int32")
    if sa is not None and (sa.dtype != torch.float32 or sa.shape != (M,)):
        raise ValueError(f"qgemm: sa must be f32 ({M},), got {sa.dtype} "
                         f"{tuple(sa.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"qgemm: out_dtype must be one of {_OUT_DTYPES}")
    tensors = [a_q, b_q, sb] + ([sa] if sa is not None else [])
    if any(t.device != a_q.device for t in tensors):
        raise ValueError("qgemm: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qgemm: operands must be contiguous")


def qgemm(a_q: torch.Tensor, b_q: torch.Tensor, sb: torch.Tensor,
          sa: Optional[torch.Tensor] = None,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    _check(a_q, b_q, sb, sa, out_dtype)
    if a_q.device.type == "cpu":
        return qgemm_plain(a_q, b_q, sb, sa, out_dtype)
    if a_q.device.type != "cuda":
        raise ValueError(f"qgemm: unsupported device {a_q.device}")
    M, K = a_q.shape
    N = b_q.shape[1]
    p = plan(M, K, N, _sm_count(a_q.device.index))
    out = torch.empty((M, N), dtype=out_dtype, device=a_q.device)
    # each split's int32 sums, added by the kernel's second pass
    partial = (torch.empty((p.splits, M, N), dtype=torch.int32, device=a_q.device)
               if p.splits > 1 else None)
    lib = _build.library("qgemm")
    err = lib.qgemm_launch(
        a_q.data_ptr(), b_q.data_ptr(), sb.data_ptr(),
        sa.data_ptr() if sa is not None else None, out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        M, N, K, int(out_dtype == torch.bfloat16), p.config, p.kchunk, p.splits,
        torch.cuda.current_stream(a_q.device).cuda_stream)
    _build.check(err, "qgemm")
    qgemm.launches += 1
    return out


qgemm.launches = 0


def qgemm_tile_scales_plain(a_q: torch.Tensor, b_q: torch.Tensor,
                            sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: an explicit loop over k tiles, in k order,
    of ``acc = acc + float(P_k) * (sa_k * sb_k)`` with the tile scales
    broadcast over their 128x128 blocks. A ``.sum`` over k would reorder
    the additions."""
    M, K = a_q.shape
    N = b_q.shape[1]
    acc = torch.zeros((M, N), dtype=torch.float32, device=a_q.device)
    for k in range(K // TILE):
        ks = slice(k * TILE, (k + 1) * TILE)
        part = _i32_product(a_q[:, ks], b_q[ks, :]).to(torch.float32)
        scale = sa[:, k, None] * sb[None, k, :]                    # (Mb, Nb)
        scale = scale.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
        acc = acc + part * scale
    return acc


def _check_tile_scales(a_q, b_q, sa, sb) -> None:
    for name, t, dt in (("a_q", a_q, torch.int8), ("b_q", b_q, torch.int8),
                        ("sa", sa, torch.float32), ("sb", sb, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"qgemm_tile_scales: {name} must be {dt}, got {t.dtype}")
    if any(t.ndim != 2 for t in (a_q, b_q, sa, sb)):
        raise ValueError("qgemm_tile_scales: expected 2-D a_q, b_q, sa, sb")
    M, K = a_q.shape
    K2, N = b_q.shape
    if K != K2 or min(M, N, K) < 1 or M % TILE or N % TILE or K % TILE:
        raise ValueError(f"qgemm_tile_scales: {tuple(a_q.shape)} @ {tuple(b_q.shape)} "
                         f"must agree in K and be multiples of {TILE}")
    if (tuple(sa.shape) != (M // TILE, K // TILE)
            or tuple(sb.shape) != (K // TILE, N // TILE)):
        raise ValueError(f"qgemm_tile_scales: tile scales sa {tuple(sa.shape)}, sb "
                         f"{tuple(sb.shape)} do not match the tile grid")
    tensors = (a_q, b_q, sa, sb)
    if any(t.device != a_q.device for t in tensors):
        raise ValueError("qgemm_tile_scales: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qgemm_tile_scales: operands must be contiguous")


def qgemm_tile_scales(a_q: torch.Tensor, b_q: torch.Tensor, sa: torch.Tensor,
                      sb: torch.Tensor) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    _check_tile_scales(a_q, b_q, sa, sb)
    if a_q.device.type == "cpu":
        return qgemm_tile_scales_plain(a_q, b_q, sa, sb)
    if a_q.device.type != "cuda":
        raise ValueError(f"qgemm_tile_scales: unsupported device {a_q.device}")
    if a_q.data_ptr() % 16 or b_q.data_ptr() % 16:
        raise ValueError("qgemm_tile_scales: a_q and b_q must be 16-byte aligned")
    M, K = a_q.shape
    N = b_q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a_q.device)
    lib = _build.library("qgemm_tile_scales")
    err = lib.qgemm_tile_scales_launch(
        a_q.data_ptr(), b_q.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
        M, N, K, int(tile_scales_narrow(M, N, _sm_count(a_q.device.index))),
        torch.cuda.current_stream(a_q.device).cuda_stream)
    _build.check(err, "qgemm_tile_scales")
    qgemm_tile_scales.launches += 1
    return out


qgemm_tile_scales.launches = 0


def qgemm_tiles(a_q: torch.Tensor, sa: torch.Tensor, b_q: torch.Tensor,
                sb: torch.Tensor) -> torch.Tensor:
    """Tile-grid entry of ``core.gemm``: ``a_q`` (Mb, Kb, t, t) and ``b_q``
    (Kb, Nb, t, t) int8 tile grids with per-tile scales broadcastable to
    (Mb, Kb) and (Kb, Nb); returns the (Mb, Nb, t, t) f32 output tiles."""
    Mb, Kb, t, _ = a_q.shape
    Nb = b_q.shape[1]
    a2 = a_q.transpose(1, 2).reshape(Mb * t, Kb * t).contiguous()
    b2 = b_q.transpose(1, 2).reshape(Kb * t, Nb * t).contiguous()
    out = qgemm_tile_scales(a2, b2, sa.reshape(Mb, Kb).contiguous(),
                            sb.reshape(Kb, Nb).contiguous())
    return out.reshape(Mb, t, Nb, t).transpose(1, 2)
